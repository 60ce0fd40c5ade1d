# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: asr.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tasr.proto\x12\x03\x61sr\"b\n\x11TranscribeRequest\x12\x1e\n\x04type\x18\x01 \x01(\x0e\x32\x10.asr.AudioFormat\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x05\x12\r\n\x05\x61udio\x18\x03 \x01(\x0c\x12\x11\n\tdevice_id\x18\x04 \x01(\t\"b\n\x12TranscribeResponse\x12\x0b\n\x03\x65nd\x18\x01 \x01(\x05\x12\x0c\n\x04text\x18\x02 \x01(\x0c\x12\x11\n\tdevice_id\x18\x03 \x01(\t\x12\x1e\n\x08segments\x18\x04 \x03(\x0b\x32\x0c.asr.Segment\"3\n\x07Segment\x12\r\n\x05start\x18\x01 \x01(\x03\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x03\x12\x0c\n\x04text\x18\x03 \x01(\x0c*d\n\x0b\x41udioFormat\x12\x07\n\x03\x41\x41\x43\x10\x00\x12\x07\n\x03MP3\x10\x01\x12\x07\n\x03WAV\x10\x02\x12\x07\n\x03OGG\x10\x03\x12\x08\n\x04\x46LAC\x10\x04\x12\x07\n\x03\x41MR\x10\x05\x12\x08\n\x04OPUS\x10\x06\x12\x07\n\x03PCM\x10\x07\x12\x0b\n\x07UNKNOWN\x10\x08\x32J\n\x03\x41sr\x12\x43\n\nTranscribe\x12\x16.asr.TranscribeRequest\x1a\x17.asr.TranscribeResponse\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'asr_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _AUDIOFORMAT._serialized_start=271
  _AUDIOFORMAT._serialized_end=371
  _TRANSCRIBEREQUEST._serialized_start=18
  _TRANSCRIBEREQUEST._serialized_end=116
  _TRANSCRIBERESPONSE._serialized_start=118
  _TRANSCRIBERESPONSE._serialized_end=216
  _SEGMENT._serialized_start=218
  _SEGMENT._serialized_end=269
  _ASR._serialized_start=373
  _ASR._serialized_end=447
# @@protoc_insertion_point(module_scope)
