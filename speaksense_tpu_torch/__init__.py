"""speaksense_tpu_torch — the PyTorch/CUDA port of the speaksense_tpu engine.

The JAX package (`speaksense_tpu`) stays the reference; this package mirrors
its layout module for module (`models/whisper.py`, `models/decode.py`,
`audio/mel.py`, `asr/engine.py`, `runtime/batcher.py`, `runtime/slots.py`,
`ckpt/`, `ops/flash.py`, `cli.py`, `main.py`) and runs the 30 s window path
and the streaming slot pool on an NVIDIA Hopper GPU, on weights loaded from
ggml or HF checkpoints, behind its own server (`main.py`: the REST and
gRPC front doors, the SQLite task queue and stores, API-key auth). The
encoder's flash attention is a hand-written CUDA kernel
(`ops/csrc/flash_attn_fwd.cu`); every other op is plain PyTorch.

The package stands alone: it imports torch, numpy and the standard library
(the REST and gRPC front doors and the etcd registry also aiohttp, grpcio
and protobuf), never jax and nothing of `speaksense_tpu`. What it needs of the JAX
package's jax-free modules (the `AsrEngine` interface, postprocess, config,
metrics, tokenizer, the numpy DSP, `StreamSession`, the checkpoint codecs,
the serving stack: `serving/`, `schedule/`, `storage/`, `auth/`,
`registry/`, `asr/fake.py`, `utils/`) it keeps as its own copies, each
naming the file it mirrors.
"""

__version__ = "0.1.0"
