# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: forward.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import metric_pb2 as metric__pb2
from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rforward.proto\x12\nforwardrpc\x1a\x0cmetric.proto\x1a\x1bgoogle/protobuf/empty.proto\"/\n\nMetricList\x12!\n\x07metrics\x18\x01 \x03(\x0b\x32\x10.metricpb.Metric2J\n\x07\x46orward\x12?\n\x0bSendMetrics\x12\x16.forwardrpc.MetricList\x1a\x16.google.protobuf.Empty\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'forward_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METRICLIST._serialized_start=72
  _METRICLIST._serialized_end=119
  _FORWARD._serialized_start=121
  _FORWARD._serialized_end=195
# @@protoc_insertion_point(module_scope)
