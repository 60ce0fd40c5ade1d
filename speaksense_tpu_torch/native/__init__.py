"""Native (C++) host kernels, the port's counterpart of `speaksense_tpu/native`.

The GPU owns the compute path; native code speeds up the host side:
checkpoint dequantization (`ggml_kernels.cc`, the port's own copy of the
JAX package's file) and PCM decode. The library is built with g++ at first
use into `_build/` (`build.py`). Without g++ every entry point returns None
and `ckpt/ggml.py` decodes with numpy; where g++ is present a failed build
or call raises.
"""

from speaksense_tpu_torch.native.loader import (  # noqa: F401
    dequantize_native,
    native_available,
    pcm16_to_f32_native,
)
