# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: grpsink.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import ssf_pb2 as ssf__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rgrpsink.proto\x12\x07grpsink\x1a\tssf.proto\"\x07\n\x05\x45mpty24\n\x08SpanSink\x12(\n\x08SendSpan\x12\x0c.ssf.SSFSpan\x1a\x0e.grpsink.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'grpsink_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=37
  _EMPTY._serialized_end=44
  _SPANSINK._serialized_start=46
  _SPANSINK._serialized_end=98
# @@protoc_insertion_point(module_scope)
