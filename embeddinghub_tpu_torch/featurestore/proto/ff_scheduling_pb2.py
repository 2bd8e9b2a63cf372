# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ff_scheduling.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2
from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as ff__metadata__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13\x66\x66_scheduling.proto\x12\x1c\x66\x65\x61tureform.scheduling.proto\x1a\x1fgoogle/protobuf/timestamp.proto\x1a\x11\x66\x66_metadata.proto\"\x14\n\x06TaskID\x12\n\n\x02id\x18\x01 \x01(\t\"\x13\n\x05RunID\x12\n\n\x02id\x18\x01 \x01(\t\"\x16\n\x08ResumeID\x12\n\n\x02id\x18\x01 \x01(\t\"u\n\tTaskRunID\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\"\xdc\x01\n\x10\x43reateRunRequest\x12\x34\n\x06taskID\x18\x01 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x36\n\x05\x61pply\x18\x04 \x01(\x0b\x32%.featureform.scheduling.proto.OnApplyH\x00\x12\x41\n\x08schedule\x18\x05 \x01(\x0b\x32-.featureform.scheduling.proto.ScheduleTriggerH\x00\x42\t\n\x07trigger\"\xbc\x01\n\x0cStatusUpdate\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x42\n\x06status\x18\x03 \x01(\x0b\x32\x32.featureform.serving.metadata.proto.ResourceStatus\"\xb4\x01\n\x0eResumeIDUpdate\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x38\n\x08resumeID\x18\x03 \x01(\x0b\x32&.featureform.scheduling.proto.ResumeID\"|\n\x03Log\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x0b\n\x03log\x18\x03 \x01(\t\"\xa5\x01\n\x10RunEndTimeUpdate\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\'\n\x03\x65nd\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\x83\x03\n\x0cTaskMetadata\x12\x30\n\x02id\x18\x01 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x34\n\x04type\x18\x03 \x01(\x0e\x32&.featureform.scheduling.proto.TaskType\x12\x46\n\x0bnameVariant\x18\x04 \x01(\x0b\x32/.featureform.scheduling.proto.NameVariantTargetH\x00\x12@\n\x08provider\x18\x05 \x01(\x0b\x32,.featureform.scheduling.proto.ProviderTargetH\x00\x12<\n\ntargetType\x18\x06 \x01(\x0e\x32(.featureform.scheduling.proto.TargetType\x12+\n\x07\x63reated\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.TimestampB\x08\n\x06target\"1\n\x0fScheduleTrigger\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08schedule\x18\x02 \x01(\t\"\x17\n\x07OnApply\x12\x0c\n\x04name\x18\x01 \x01(\t\"W\n\x11NameVariantTarget\x12\x42\n\nresourceID\x18\x01 \x01(\x0b\x32..featureform.serving.metadata.proto.ResourceID\"\x1e\n\x0eProviderTarget\x12\x0c\n\x04name\x18\x01 \x01(\t\"\xd9\x06\n\x0fTaskRunMetadata\x12\x32\n\x05runID\x18\x01 \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x34\n\x06taskID\x18\x02 \x01(\x0b\x32$.featureform.scheduling.proto.TaskID\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x36\n\x05\x61pply\x18\x04 \x01(\x0b\x32%.featureform.scheduling.proto.OnApplyH\x00\x12\x41\n\x08schedule\x18\x05 \x01(\x0b\x32-.featureform.scheduling.proto.ScheduleTriggerH\x00\x12>\n\x0btriggerType\x18\x06 \x01(\x0e\x32).featureform.scheduling.proto.TriggerType\x12\x46\n\x0bnameVariant\x18\x07 \x01(\x0b\x32/.featureform.scheduling.proto.NameVariantTargetH\x01\x12@\n\x08provider\x18\x08 \x01(\x0b\x32,.featureform.scheduling.proto.ProviderTargetH\x01\x12<\n\ntargetType\x18\t \x01(\x0e\x32(.featureform.scheduling.proto.TargetType\x12-\n\tstartTime\x18\n \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12+\n\x07\x65ndTime\x18\x0b \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x0c\n\x04logs\x18\x0c \x03(\t\x12\x42\n\x06status\x18\r \x01(\x0b\x32\x32.featureform.serving.metadata.proto.ResourceStatus\x12<\n\x0flast_successful\x18\x0e \x01(\x0b\x32#.featureform.scheduling.proto.RunID\x12\x38\n\x08resumeID\x18\x0f \x01(\x0b\x32&.featureform.scheduling.proto.ResumeID\x12\x10\n\x08isDelete\x18\x10 \x01(\x08\x42\t\n\x07triggerB\x08\n\x06target\"J\n\x0bTaskRunList\x12;\n\x04runs\x18\x01 \x03(\x0b\x32-.featureform.scheduling.proto.TaskRunMetadata\"\x07\n\x05\x45mpty*,\n\nTargetType\x12\x10\n\x0cNAME_VARIANT\x10\x00\x12\x0c\n\x08PROVIDER\x10\x01*W\n\x08TaskType\x12\x15\n\x11RESOURCE_CREATION\x10\x00\x12\x10\n\x0cHEALTH_CHECK\x10\x01\x12\x0b\n\x07METRICS\x10\x02\x12\x15\n\x11RESOURCE_DELETION\x10\x03*)\n\x0bTriggerType\x12\x0c\n\x08SCHEDULE\x10\x00\x12\x0c\n\x08ON_APPLY\x10\x01\x32\x9e\n\n\x05Tasks\x12\x64\n\rCreateTaskRun\x12..featureform.scheduling.proto.CreateRunRequest\x1a#.featureform.scheduling.proto.RunID\x12^\n\x12SyncUnfinishedRuns\x12#.featureform.scheduling.proto.Empty\x1a#.featureform.scheduling.proto.Empty\x12_\n\x0bGetTaskByID\x12$.featureform.scheduling.proto.TaskID\x1a*.featureform.scheduling.proto.TaskMetadata\x12`\n\x07GetRuns\x12$.featureform.scheduling.proto.TaskID\x1a-.featureform.scheduling.proto.TaskRunMetadata0\x01\x12h\n\x0eGetRunMetadata\x12\'.featureform.scheduling.proto.TaskRunID\x1a-.featureform.scheduling.proto.TaskRunMetadata\x12\x62\n\nGetAllRuns\x12#.featureform.scheduling.proto.Empty\x1a-.featureform.scheduling.proto.TaskRunMetadata0\x01\x12i\n\x11GetUnfinishedRuns\x12#.featureform.scheduling.proto.Empty\x1a-.featureform.scheduling.proto.TaskRunMetadata0\x01\x12\x63\n\x0cGetLatestRun\x12$.featureform.scheduling.proto.TaskID\x1a-.featureform.scheduling.proto.TaskRunMetadata\x12_\n\x0cSetRunStatus\x12*.featureform.scheduling.proto.StatusUpdate\x1a#.featureform.scheduling.proto.Empty\x12\x63\n\x0eSetRunResumeID\x12,.featureform.scheduling.proto.ResumeIDUpdate\x1a#.featureform.scheduling.proto.Empty\x12S\n\tAddRunLog\x12!.featureform.scheduling.proto.Log\x1a#.featureform.scheduling.proto.Empty\x12\x64\n\rSetRunEndTime\x12..featureform.scheduling.proto.RunEndTimeUpdate\x1a#.featureform.scheduling.proto.Empty\x12m\n\x0eWatchForCancel\x12\'.featureform.scheduling.proto.TaskRunID\x1a\x32.featureform.serving.metadata.proto.ResourceStatusB)Z\'github.com/featureform/scheduling/protob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ff_scheduling_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z\'github.com/featureform/scheduling/proto'
  _TARGETTYPE._serialized_start=2714
  _TARGETTYPE._serialized_end=2758
  _TASKTYPE._serialized_start=2760
  _TASKTYPE._serialized_end=2847
  _TRIGGERTYPE._serialized_start=2849
  _TRIGGERTYPE._serialized_end=2890
  _TASKID._serialized_start=105
  _TASKID._serialized_end=125
  _RUNID._serialized_start=127
  _RUNID._serialized_end=146
  _RESUMEID._serialized_start=148
  _RESUMEID._serialized_end=170
  _TASKRUNID._serialized_start=172
  _TASKRUNID._serialized_end=289
  _CREATERUNREQUEST._serialized_start=292
  _CREATERUNREQUEST._serialized_end=512
  _STATUSUPDATE._serialized_start=515
  _STATUSUPDATE._serialized_end=703
  _RESUMEIDUPDATE._serialized_start=706
  _RESUMEIDUPDATE._serialized_end=886
  _LOG._serialized_start=888
  _LOG._serialized_end=1012
  _RUNENDTIMEUPDATE._serialized_start=1015
  _RUNENDTIMEUPDATE._serialized_end=1180
  _TASKMETADATA._serialized_start=1183
  _TASKMETADATA._serialized_end=1570
  _SCHEDULETRIGGER._serialized_start=1572
  _SCHEDULETRIGGER._serialized_end=1621
  _ONAPPLY._serialized_start=1623
  _ONAPPLY._serialized_end=1646
  _NAMEVARIANTTARGET._serialized_start=1648
  _NAMEVARIANTTARGET._serialized_end=1735
  _PROVIDERTARGET._serialized_start=1737
  _PROVIDERTARGET._serialized_end=1767
  _TASKRUNMETADATA._serialized_start=1770
  _TASKRUNMETADATA._serialized_end=2627
  _TASKRUNLIST._serialized_start=2629
  _TASKRUNLIST._serialized_end=2703
  _EMPTY._serialized_start=2705
  _EMPTY._serialized_end=2712
  _TASKS._serialized_start=2893
  _TASKS._serialized_end=4203
# @@protoc_insertion_point(module_scope)
