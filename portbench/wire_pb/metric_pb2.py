# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: metric.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import tdigest_pb2 as tdigest__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmetric.proto\x12\x08metricpb\x1a\rtdigest.proto\"\x8f\x02\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04tags\x18\x02 \x03(\t\x12\x1c\n\x04type\x18\x03 \x01(\x0e\x32\x0e.metricpb.Type\x12)\n\x07\x63ounter\x18\x05 \x01(\x0b\x32\x16.metricpb.CounterValueH\x00\x12%\n\x05gauge\x18\x06 \x01(\x0b\x32\x14.metricpb.GaugeValueH\x00\x12-\n\thistogram\x18\x07 \x01(\x0b\x32\x18.metricpb.HistogramValueH\x00\x12!\n\x03set\x18\x08 \x01(\x0b\x32\x12.metricpb.SetValueH\x00\x12\x1e\n\x05scope\x18\t \x01(\x0e\x32\x0f.metricpb.ScopeB\x07\n\x05value\"\x1d\n\x0c\x43ounterValue\x12\r\n\x05value\x18\x01 \x01(\x03\"\x1b\n\nGaugeValue\x12\r\n\x05value\x18\x01 \x01(\x01\">\n\x0eHistogramValue\x12,\n\x08t_digest\x18\x01 \x01(\x0b\x32\x1a.tdigest.MergingDigestData\"!\n\x08SetValue\x12\x15\n\rhyper_log_log\x18\x01 \x01(\x0c*)\n\x05Scope\x12\t\n\x05Mixed\x10\x00\x12\t\n\x05Local\x10\x01\x12\n\n\x06Global\x10\x02*A\n\x04Type\x12\x0b\n\x07\x43ounter\x10\x00\x12\t\n\x05Gauge\x10\x01\x12\r\n\tHistogram\x10\x02\x12\x07\n\x03Set\x10\x03\x12\t\n\x05Timer\x10\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'metric_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SCOPE._serialized_start=474
  _SCOPE._serialized_end=515
  _TYPE._serialized_start=517
  _TYPE._serialized_end=582
  _METRIC._serialized_start=42
  _METRIC._serialized_end=313
  _COUNTERVALUE._serialized_start=315
  _COUNTERVALUE._serialized_end=344
  _GAUGEVALUE._serialized_start=346
  _GAUGEVALUE._serialized_end=373
  _HISTOGRAMVALUE._serialized_start=375
  _HISTOGRAMVALUE._serialized_end=437
  _SETVALUE._serialized_start=439
  _SETVALUE._serialized_end=472
# @@protoc_insertion_point(module_scope)
