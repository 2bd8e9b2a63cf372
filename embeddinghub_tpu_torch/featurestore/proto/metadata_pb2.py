# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: metadata.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0emetadata.proto\x12\x1f\x65mbeddinghub_tpu.metadata.proto\"\x07\n\x05\x45mpty\":\n\x0bResourceRef\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0f\n\x07variant\x18\x03 \x01(\t\"\x17\n\x07TypeRef\x12\x0c\n\x04type\x18\x01 \x01(\t\"r\n\x0cResourceBlob\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0f\n\x07variant\x18\x03 \x01(\t\x12\x0f\n\x07payload\x18\x04 \x01(\x0c\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x14\n\x0cstatus_error\x18\x06 \x01(\t\"!\n\x0e\x43reateResponse\x12\x0f\n\x07\x63reated\x18\x01 \x01(\x08\"<\n\nRunSummary\x12\r\n\x05ready\x18\x01 \x01(\x05\x12\x0e\n\x06\x66\x61iled\x18\x02 \x01(\x05\x12\x0f\n\x07pending\x18\x03 \x01(\x05\"\'\n\x0bSearchQuery\x12\t\n\x01q\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\x05\"M\n\tSearchHit\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0f\n\x07variant\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t2\x8f\x05\n\x08Metadata\x12r\n\x0e\x43reateResource\x12-.embeddinghub_tpu.metadata.proto.ResourceBlob\x1a/.embeddinghub_tpu.metadata.proto.CreateResponse\"\x00\x12l\n\x0bGetResource\x12,.embeddinghub_tpu.metadata.proto.ResourceRef\x1a-.embeddinghub_tpu.metadata.proto.ResourceBlob\"\x00\x12l\n\rListResources\x12(.embeddinghub_tpu.metadata.proto.TypeRef\x1a-.embeddinghub_tpu.metadata.proto.ResourceBlob\"\x00\x30\x01\x12h\n\x0e\x44\x65leteResource\x12,.embeddinghub_tpu.metadata.proto.ResourceRef\x1a&.embeddinghub_tpu.metadata.proto.Empty\"\x00\x12\x61\n\x08RunTasks\x12&.embeddinghub_tpu.metadata.proto.Empty\x1a+.embeddinghub_tpu.metadata.proto.RunSummary\"\x00\x12\x66\n\x06Search\x12,.embeddinghub_tpu.metadata.proto.SearchQuery\x1a*.embeddinghub_tpu.metadata.proto.SearchHit\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'metadata_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=51
  _EMPTY._serialized_end=58
  _RESOURCEREF._serialized_start=60
  _RESOURCEREF._serialized_end=118
  _TYPEREF._serialized_start=120
  _TYPEREF._serialized_end=143
  _RESOURCEBLOB._serialized_start=145
  _RESOURCEBLOB._serialized_end=259
  _CREATERESPONSE._serialized_start=261
  _CREATERESPONSE._serialized_end=294
  _RUNSUMMARY._serialized_start=296
  _RUNSUMMARY._serialized_end=356
  _SEARCHQUERY._serialized_start=358
  _SEARCHQUERY._serialized_end=397
  _SEARCHHIT._serialized_start=399
  _SEARCHHIT._serialized_end=476
  _METADATA._serialized_start=479
  _METADATA._serialized_end=1134
# @@protoc_insertion_point(module_scope)
