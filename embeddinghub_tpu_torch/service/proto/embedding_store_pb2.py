# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: embedding_store.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x15\x65mbedding_store.proto\x12\x1b\x66\x65\x61tureform.embedding.proto\"\x1b\n\tEmbedding\x12\x0e\n\x06values\x18\x01 \x03(\x02\"\x83\x01\n\x1b\x42\x61tchNearestNeighborRequest\x12\r\n\x05space\x18\x01 \x01(\t\x12\x0b\n\x03num\x18\x02 \x01(\x05\x12:\n\nembeddings\x18\x03 \x03(\x0b\x32&.featureform.embedding.proto.Embedding\x12\x0c\n\x04keys\x18\x04 \x03(\t\"\x8b\x01\n\x1c\x42\x61tchNearestNeighborResponse\x12R\n\x07results\x18\x01 \x03(\x0b\x32\x41.featureform.embedding.proto.BatchNearestNeighborResponse.KeyList\x1a\x17\n\x07KeyList\x12\x0c\n\x04keys\x18\x01 \x03(\t\"0\n\x12\x43reateSpaceRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04\x64ims\x18\x02 \x01(\r\"\x15\n\x13\x43reateSpaceResponse\"\"\n\x12\x44\x65leteSpaceRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x15\n\x13\x44\x65leteSpaceResponse\"\"\n\x12\x46reezeSpaceRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x15\n\x13\x46reezeSpaceResponse\"c\n\nSetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x39\n\tembedding\x18\x02 \x01(\x0b\x32&.featureform.embedding.proto.Embedding\x12\r\n\x05space\x18\x03 \x01(\t\"\r\n\x0bSetResponse\"(\n\nGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05space\x18\x02 \x01(\t\"H\n\x0bGetResponse\x12\x39\n\tembedding\x18\x01 \x01(\x0b\x32&.featureform.embedding.proto.Embedding\"h\n\x0fMultiSetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x39\n\tembedding\x18\x02 \x01(\x0b\x32&.featureform.embedding.proto.Embedding\x12\r\n\x05space\x18\x03 \x01(\t\"\x12\n\x10MultiSetResponse\"-\n\x0fMultiGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05space\x18\x02 \x01(\t\"M\n\x10MultiGetResponse\x12\x39\n\tembedding\x18\x01 \x01(\x0b\x32&.featureform.embedding.proto.Embedding\"|\n\x16NearestNeighborRequest\x12\x0b\n\x03num\x18\x01 \x01(\x05\x12\r\n\x05space\x18\x02 \x01(\t\x12\x0b\n\x03key\x18\x03 \x01(\t\x12\x39\n\tembedding\x18\x04 \x01(\x0b\x32&.featureform.embedding.proto.Embedding\"\'\n\x17NearestNeighborResponse\x12\x0c\n\x04keys\x18\x01 \x03(\t\" \n\x0f\x44ownloadRequest\x12\r\n\x05space\x18\x01 \x01(\t\"Z\n\x10\x44ownloadResponse\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x39\n\tembedding\x18\x02 \x01(\x0b\x32&.featureform.embedding.proto.Embedding2\xfb\x08\n\x0c\x45mbeddingHub\x12r\n\x0b\x43reateSpace\x12/.featureform.embedding.proto.CreateSpaceRequest\x1a\x30.featureform.embedding.proto.CreateSpaceResponse\"\x00\x12r\n\x0b\x44\x65leteSpace\x12/.featureform.embedding.proto.DeleteSpaceRequest\x1a\x30.featureform.embedding.proto.DeleteSpaceResponse\"\x00\x12r\n\x0b\x46reezeSpace\x12/.featureform.embedding.proto.FreezeSpaceRequest\x1a\x30.featureform.embedding.proto.FreezeSpaceResponse\"\x00\x12Z\n\x03Set\x12\'.featureform.embedding.proto.SetRequest\x1a(.featureform.embedding.proto.SetResponse\"\x00\x12Z\n\x03Get\x12\'.featureform.embedding.proto.GetRequest\x1a(.featureform.embedding.proto.GetResponse\"\x00\x12k\n\x08MultiSet\x12,.featureform.embedding.proto.MultiSetRequest\x1a-.featureform.embedding.proto.MultiSetResponse\"\x00(\x01\x12m\n\x08MultiGet\x12,.featureform.embedding.proto.MultiGetRequest\x1a-.featureform.embedding.proto.MultiGetResponse\"\x00(\x01\x30\x01\x12~\n\x0fNearestNeighbor\x12\x33.featureform.embedding.proto.NearestNeighborRequest\x1a\x34.featureform.embedding.proto.NearestNeighborResponse\"\x00\x12k\n\x08\x44ownload\x12,.featureform.embedding.proto.DownloadRequest\x1a-.featureform.embedding.proto.DownloadResponse\"\x00\x30\x01\x12\x8d\x01\n\x14\x42\x61tchNearestNeighbor\x12\x38.featureform.embedding.proto.BatchNearestNeighborRequest\x1a\x39.featureform.embedding.proto.BatchNearestNeighborResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'embedding_store_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMBEDDING._serialized_start=54
  _EMBEDDING._serialized_end=81
  _BATCHNEARESTNEIGHBORREQUEST._serialized_start=84
  _BATCHNEARESTNEIGHBORREQUEST._serialized_end=215
  _BATCHNEARESTNEIGHBORRESPONSE._serialized_start=218
  _BATCHNEARESTNEIGHBORRESPONSE._serialized_end=357
  _BATCHNEARESTNEIGHBORRESPONSE_KEYLIST._serialized_start=334
  _BATCHNEARESTNEIGHBORRESPONSE_KEYLIST._serialized_end=357
  _CREATESPACEREQUEST._serialized_start=359
  _CREATESPACEREQUEST._serialized_end=407
  _CREATESPACERESPONSE._serialized_start=409
  _CREATESPACERESPONSE._serialized_end=430
  _DELETESPACEREQUEST._serialized_start=432
  _DELETESPACEREQUEST._serialized_end=466
  _DELETESPACERESPONSE._serialized_start=468
  _DELETESPACERESPONSE._serialized_end=489
  _FREEZESPACEREQUEST._serialized_start=491
  _FREEZESPACEREQUEST._serialized_end=525
  _FREEZESPACERESPONSE._serialized_start=527
  _FREEZESPACERESPONSE._serialized_end=548
  _SETREQUEST._serialized_start=550
  _SETREQUEST._serialized_end=649
  _SETRESPONSE._serialized_start=651
  _SETRESPONSE._serialized_end=664
  _GETREQUEST._serialized_start=666
  _GETREQUEST._serialized_end=706
  _GETRESPONSE._serialized_start=708
  _GETRESPONSE._serialized_end=780
  _MULTISETREQUEST._serialized_start=782
  _MULTISETREQUEST._serialized_end=886
  _MULTISETRESPONSE._serialized_start=888
  _MULTISETRESPONSE._serialized_end=906
  _MULTIGETREQUEST._serialized_start=908
  _MULTIGETREQUEST._serialized_end=953
  _MULTIGETRESPONSE._serialized_start=955
  _MULTIGETRESPONSE._serialized_end=1032
  _NEARESTNEIGHBORREQUEST._serialized_start=1034
  _NEARESTNEIGHBORREQUEST._serialized_end=1158
  _NEARESTNEIGHBORRESPONSE._serialized_start=1160
  _NEARESTNEIGHBORRESPONSE._serialized_end=1199
  _DOWNLOADREQUEST._serialized_start=1201
  _DOWNLOADREQUEST._serialized_end=1233
  _DOWNLOADRESPONSE._serialized_start=1235
  _DOWNLOADRESPONSE._serialized_end=1325
  _EMBEDDINGHUB._serialized_start=1328
  _EMBEDDINGHUB._serialized_end=2475
# @@protoc_insertion_point(module_scope)
