"""Generated protobuf messages for the asr.Asr service.

The port's own copy of `speaksense_tpu/serving/pb/` (`asr.proto` and the
generated `asr_pb2.py`, byte for byte the same wire contract).

asr_pb2.py is generated from asr.proto by `protoc --python_out=. asr.proto`
in this directory. The gRPC service wiring is hand-rolled in
serving/grpc_server.py with grpc generic handlers (no grpc_tools needed).
"""

from speaksense_tpu_torch.serving.pb import asr_pb2  # noqa: F401
