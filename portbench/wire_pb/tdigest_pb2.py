# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tdigest.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rtdigest.proto\x12\x07tdigest\"\x84\x01\n\x11MergingDigestData\x12)\n\x0emain_centroids\x18\x01 \x03(\x0b\x32\x11.tdigest.Centroid\x12\x13\n\x0b\x63ompression\x18\x02 \x01(\x01\x12\x0b\n\x03min\x18\x03 \x01(\x01\x12\x0b\n\x03max\x18\x04 \x01(\x01\x12\x15\n\rreciprocalSum\x18\x05 \x01(\x01\"9\n\x08\x43\x65ntroid\x12\x0c\n\x04mean\x18\x01 \x01(\x01\x12\x0e\n\x06weight\x18\x02 \x01(\x01\x12\x0f\n\x07samples\x18\x03 \x03(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tdigest_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MERGINGDIGESTDATA._serialized_start=27
  _MERGINGDIGESTDATA._serialized_end=159
  _CENTROID._serialized_start=161
  _CENTROID._serialized_end=218
# @@protoc_insertion_point(module_scope)
