# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: throttlecrab.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12throttlecrab.proto\x12\x0cthrottlecrab\"m\n\x0fThrottleRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x11\n\tmax_burst\x18\x02 \x01(\x05\x12\x18\n\x10\x63ount_per_period\x18\x03 \x01(\x05\x12\x0e\n\x06period\x18\x04 \x01(\x05\x12\x10\n\x08quantity\x18\x05 \x01(\x05\"o\n\x10ThrottleResponse\x12\x0f\n\x07\x61llowed\x18\x01 \x01(\x08\x12\r\n\x05limit\x18\x02 \x01(\x05\x12\x11\n\tremaining\x18\x03 \x01(\x05\x12\x13\n\x0bretry_after\x18\x04 \x01(\x05\x12\x13\n\x0breset_after\x18\x05 \x01(\x05\x32X\n\x0bRateLimiter\x12I\n\x08Throttle\x12\x1d.throttlecrab.ThrottleRequest\x1a\x1e.throttlecrab.ThrottleResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'throttlecrab_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _THROTTLEREQUEST._serialized_start=36
  _THROTTLEREQUEST._serialized_end=145
  _THROTTLERESPONSE._serialized_start=147
  _THROTTLERESPONSE._serialized_end=258
  _RATELIMITER._serialized_start=260
  _RATELIMITER._serialized_end=348
# @@protoc_insertion_point(module_scope)
