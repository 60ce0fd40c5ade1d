"""Serving of the PyTorch port: the stream session (`stream.py`), the REST
task and key API (`rest.py`, aiohttp) and the gRPC bidi-streaming ASR
service (`grpc_server.py`, grpc.aio, with `pb/`): the port's own copies of
`speaksense_tpu/serving/`, with the same wire contracts. Only `rest.py`
(inside its functions), `grpc_server.py` and `pb/` import aiohttp, grpc or
protobuf."""
