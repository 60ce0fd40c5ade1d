"""speaksense_tpu_torch — the PyTorch/CUDA port of the speaksense_tpu engine.

The JAX package (`speaksense_tpu`) stays the reference; this package mirrors
its layout module for module (`models/whisper.py`, `models/decode.py`,
`audio/mel.py`, `asr/engine.py`, `runtime/batcher.py`, `ops/flash.py`) and
runs the 30 s window-transcription path on an NVIDIA Hopper GPU. The encoder's
flash attention is a hand-written CUDA kernel (`ops/csrc/flash_attn_fwd.cu`);
every other op is plain PyTorch.

The package never imports jax. The jax-free shared code of the JAX package
(`speaksense_tpu.asr`, `.asr.postprocess`, `.config`, `.utils.metrics`) is
imported directly; the tokenizer file is loaded on its own by `_shared`
because its package `__init__` imports jax.
"""

__version__ = "0.1.0"
