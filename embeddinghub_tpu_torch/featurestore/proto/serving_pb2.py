# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rserving.proto\x12\x19\x66\x65\x61tureform.serving.proto\"\x15\n\x05Model\x12\x0c\n\x04name\x18\x01 \x01(\t\"}\n\x13TrainingDataRequest\x12\x35\n\x02id\x18\x01 \x01(\x0b\x32).featureform.serving.proto.TrainingDataID\x12/\n\x05model\x18\x02 \x01(\x0b\x32 .featureform.serving.proto.Model\"/\n\x0eTrainingDataID\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"L\n\x10TrainingDataRows\x12\x38\n\x04rows\x18\x01 \x03(\x0b\x32*.featureform.serving.proto.TrainingDataRow\"v\n\x0fTrainingDataRow\x12\x32\n\x08\x66\x65\x61tures\x18\x01 \x03(\x0b\x32 .featureform.serving.proto.Value\x12/\n\x05label\x18\x02 \x01(\x0b\x32 .featureform.serving.proto.Value\"\xb3\x01\n\x13\x46\x65\x61tureServeRequest\x12\x36\n\x08\x66\x65\x61tures\x18\x01 \x03(\x0b\x32$.featureform.serving.proto.FeatureID\x12\x33\n\x08\x65ntities\x18\x02 \x03(\x0b\x32!.featureform.serving.proto.Entity\x12/\n\x05model\x18\x03 \x01(\x0b\x32 .featureform.serving.proto.Model\"}\n\nFeatureRow\x12\x34\n\x06values\x18\x01 \x03(\x0b\x32 .featureform.serving.proto.ValueB\x02\x18\x01\x12\x39\n\x0bvalue_lists\x18\x02 \x03(\x0b\x32$.featureform.serving.proto.ValueList\"=\n\tValueList\x12\x30\n\x06values\x18\x01 \x03(\x0b\x32 .featureform.serving.proto.Value\"R\n\x18\x42\x61tchFeatureServeRequest\x12\x36\n\x08\x66\x65\x61tures\x18\x01 \x03(\x0b\x32$.featureform.serving.proto.FeatureID\"L\n\x10\x42\x61tchFeatureRows\x12\x38\n\x04rows\x18\x01 \x03(\x0b\x32*.featureform.serving.proto.BatchFeatureRow\"w\n\x0f\x42\x61tchFeatureRow\x12\x30\n\x06\x65ntity\x18\x01 \x01(\x0b\x32 .featureform.serving.proto.Value\x12\x32\n\x08\x66\x65\x61tures\x18\x02 \x03(\x0b\x32 .featureform.serving.proto.Value\"*\n\tFeatureID\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"9\n\x06\x45ntity\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\x05value\x18\x02 \x01(\tB\x02\x18\x01\x12\x0e\n\x06values\x18\x03 \x03(\t\"\xba\x02\n\x05Value\x12\x13\n\tstr_value\x18\x01 \x01(\tH\x00\x12\x13\n\tint_value\x18\x02 \x01(\x05H\x00\x12\x15\n\x0b\x66loat_value\x18\x03 \x01(\x02H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x12\x15\n\x0bint64_value\x18\x05 \x01(\x03H\x00\x12\x15\n\x0bint32_value\x18\x06 \x01(\x05H\x00\x12\x14\n\nbool_value\x18\x07 \x01(\x08H\x00\x12\x1c\n\x12on_demand_function\x18\x08 \x01(\x0cH\x00\x12=\n\x0evector32_value\x18\t \x01(\x0b\x32#.featureform.serving.proto.Vector32H\x00\x12\x16\n\x0cuint32_value\x18\n \x01(\rH\x00\x12\x16\n\x0cuint64_value\x18\x0b \x01(\x04H\x00\x42\x07\n\x05value\")\n\x08SourceID\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"S\n\x11SourceDataRequest\x12/\n\x02id\x18\x01 \x01(\x0b\x32#.featureform.serving.proto.SourceID\x12\r\n\x05limit\x18\x02 \x01(\x03\"H\n\x0eSourceDataRows\x12\x36\n\x04rows\x18\x01 \x03(\x0b\x32(.featureform.serving.proto.SourceDataRow\"?\n\rSourceDataRow\x12.\n\x04rows\x18\x01 \x03(\x0b\x32 .featureform.serving.proto.Value\"S\n\x1aTrainingDataColumnsRequest\x12\x35\n\x02id\x18\x01 \x01(\x0b\x32).featureform.serving.proto.TrainingDataID\"2\n\x0fTrainingColumns\x12\x10\n\x08\x66\x65\x61tures\x18\x01 \x03(\t\x12\r\n\x05label\x18\x02 \x01(\t\"F\n\x13SourceColumnRequest\x12/\n\x02id\x18\x01 \x01(\x0b\x32#.featureform.serving.proto.SourceID\"$\n\x11SourceDataColumns\x12\x0f\n\x07\x63olumns\x18\x01 \x03(\t\"@\n\x11ResourceIdRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07variant\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\x05\"$\n\x10ResourceLocation\x12\x10\n\x08location\x18\x01 \x01(\t\"\x19\n\x08Vector32\x12\r\n\x05value\x18\x01 \x03(\x02\"\x82\x01\n\x0eNearestRequest\x12\x30\n\x02id\x18\x01 \x01(\x0b\x32$.featureform.serving.proto.FeatureID\x12\x33\n\x06vector\x18\x02 \x01(\x0b\x32#.featureform.serving.proto.Vector32\x12\t\n\x01k\x18\x03 \x01(\x05\"#\n\x0fNearestResponse\x12\x10\n\x08\x65ntities\x18\x01 \x03(\t\"\x9f\x02\n\x15TrainTestSplitRequest\x12\x35\n\x02id\x18\x01 \x01(\x0b\x32).featureform.serving.proto.TrainingDataID\x12/\n\x05model\x18\x02 \x01(\x0b\x32 .featureform.serving.proto.Model\x12\x11\n\ttest_size\x18\x03 \x01(\x02\x12\x12\n\ntrain_size\x18\x04 \x01(\x02\x12\x0f\n\x07shuffle\x18\x05 \x01(\x08\x12\x14\n\x0crandom_state\x18\x06 \x01(\x05\x12<\n\x0crequest_type\x18\x07 \x01(\x0e\x32&.featureform.serving.proto.RequestType\x12\x12\n\nbatch_size\x18\x08 \x01(\x05\"\xd0\x01\n\x1b\x42\x61tchTrainTestSplitResponse\x12<\n\x0crequest_type\x18\x01 \x01(\x0e\x32&.featureform.serving.proto.RequestType\x12\x15\n\riterator_done\x18\x02 \x01(\x08\x12\x15\n\x0binitialized\x18\x03 \x01(\x08H\x00\x12;\n\x04\x64\x61ta\x18\x04 \x01(\x0b\x32+.featureform.serving.proto.TrainingDataRowsH\x00\x42\x08\n\x06result*5\n\x0bRequestType\x12\x0e\n\nINITIALIZE\x10\x00\x12\x0c\n\x08TRAINING\x10\x01\x12\x08\n\x04TEST\x10\x02\x32\x91\x08\n\x07\x46\x65\x61ture\x12o\n\x0cTrainingData\x12..featureform.serving.proto.TrainingDataRequest\x1a+.featureform.serving.proto.TrainingDataRows\"\x00\x30\x01\x12\x80\x01\n\x0eTrainTestSplit\x12\x30.featureform.serving.proto.TrainTestSplitRequest\x1a\x36.featureform.serving.proto.BatchTrainTestSplitResponse\"\x00(\x01\x30\x01\x12g\n\x0c\x46\x65\x61tureServe\x12..featureform.serving.proto.FeatureServeRequest\x1a%.featureform.serving.proto.FeatureRow\"\x00\x12i\n\nSourceData\x12,.featureform.serving.proto.SourceDataRequest\x1a).featureform.serving.proto.SourceDataRows\"\x00\x30\x01\x12\x62\n\x07Nearest\x12).featureform.serving.proto.NearestRequest\x1a*.featureform.serving.proto.NearestResponse\"\x00\x12y\n\x11\x42\x61tchFeatureServe\x12\x33.featureform.serving.proto.BatchFeatureServeRequest\x1a+.featureform.serving.proto.BatchFeatureRows\"\x00\x30\x01\x12z\n\x13TrainingDataColumns\x12\x35.featureform.serving.proto.TrainingDataColumnsRequest\x1a*.featureform.serving.proto.TrainingColumns\"\x00\x12o\n\rSourceColumns\x12..featureform.serving.proto.SourceColumnRequest\x1a,.featureform.serving.proto.SourceDataColumns\"\x00\x12r\n\x13GetResourceLocation\x12,.featureform.serving.proto.ResourceIdRequest\x1a+.featureform.serving.proto.ResourceLocation\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FEATUREROW.fields_by_name['values']._options = None
  _FEATUREROW.fields_by_name['values']._serialized_options = b'\030\001'
  _ENTITY.fields_by_name['value']._options = None
  _ENTITY.fields_by_name['value']._serialized_options = b'\030\001'
  _REQUESTTYPE._serialized_start=2832
  _REQUESTTYPE._serialized_end=2885
  _MODEL._serialized_start=44
  _MODEL._serialized_end=65
  _TRAININGDATAREQUEST._serialized_start=67
  _TRAININGDATAREQUEST._serialized_end=192
  _TRAININGDATAID._serialized_start=194
  _TRAININGDATAID._serialized_end=241
  _TRAININGDATAROWS._serialized_start=243
  _TRAININGDATAROWS._serialized_end=319
  _TRAININGDATAROW._serialized_start=321
  _TRAININGDATAROW._serialized_end=439
  _FEATURESERVEREQUEST._serialized_start=442
  _FEATURESERVEREQUEST._serialized_end=621
  _FEATUREROW._serialized_start=623
  _FEATUREROW._serialized_end=748
  _VALUELIST._serialized_start=750
  _VALUELIST._serialized_end=811
  _BATCHFEATURESERVEREQUEST._serialized_start=813
  _BATCHFEATURESERVEREQUEST._serialized_end=895
  _BATCHFEATUREROWS._serialized_start=897
  _BATCHFEATUREROWS._serialized_end=973
  _BATCHFEATUREROW._serialized_start=975
  _BATCHFEATUREROW._serialized_end=1094
  _FEATUREID._serialized_start=1096
  _FEATUREID._serialized_end=1138
  _ENTITY._serialized_start=1140
  _ENTITY._serialized_end=1197
  _VALUE._serialized_start=1200
  _VALUE._serialized_end=1514
  _SOURCEID._serialized_start=1516
  _SOURCEID._serialized_end=1557
  _SOURCEDATAREQUEST._serialized_start=1559
  _SOURCEDATAREQUEST._serialized_end=1642
  _SOURCEDATAROWS._serialized_start=1644
  _SOURCEDATAROWS._serialized_end=1716
  _SOURCEDATAROW._serialized_start=1718
  _SOURCEDATAROW._serialized_end=1781
  _TRAININGDATACOLUMNSREQUEST._serialized_start=1783
  _TRAININGDATACOLUMNSREQUEST._serialized_end=1866
  _TRAININGCOLUMNS._serialized_start=1868
  _TRAININGCOLUMNS._serialized_end=1918
  _SOURCECOLUMNREQUEST._serialized_start=1920
  _SOURCECOLUMNREQUEST._serialized_end=1990
  _SOURCEDATACOLUMNS._serialized_start=1992
  _SOURCEDATACOLUMNS._serialized_end=2028
  _RESOURCEIDREQUEST._serialized_start=2030
  _RESOURCEIDREQUEST._serialized_end=2094
  _RESOURCELOCATION._serialized_start=2096
  _RESOURCELOCATION._serialized_end=2132
  _VECTOR32._serialized_start=2134
  _VECTOR32._serialized_end=2159
  _NEARESTREQUEST._serialized_start=2162
  _NEARESTREQUEST._serialized_end=2292
  _NEARESTRESPONSE._serialized_start=2294
  _NEARESTRESPONSE._serialized_end=2329
  _TRAINTESTSPLITREQUEST._serialized_start=2332
  _TRAINTESTSPLITREQUEST._serialized_end=2619
  _BATCHTRAINTESTSPLITRESPONSE._serialized_start=2622
  _BATCHTRAINTESTSPLITRESPONSE._serialized_end=2830
  _FEATURE._serialized_start=2888
  _FEATURE._serialized_end=3929
# @@protoc_insertion_point(module_scope)
