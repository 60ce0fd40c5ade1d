"""Jax-free access to the shared tokenizer and the numpy DSP.

`speaksense_tpu/models/tokenizer.py` and `speaksense_tpu/audio/dsp.py`
import only the standard library and numpy, but importing them by package
name runs `speaksense_tpu/models/__init__.py` or
`speaksense_tpu/audio/__init__.py`, which import the JAX model and the JAX
mel. This module loads each of those files under a private module name
instead, so the port keeps a single copy of the BPE, special-token and
numpy denoise code and never pulls in jax.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PACKAGE = Path(__file__).resolve().parent.parent / "speaksense_tpu"


def _load_by_path(module_name: str, path: Path):
    mod = sys.modules.get(module_name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the shared module {path}")
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolve the defining module through sys.modules while the
    # class body runs, so register before executing
    sys.modules[module_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[module_name]
        raise
    return mod


tokenizer = _load_by_path("speaksense_tpu_torch._tokenizer",
                          _JAX_PACKAGE / "models" / "tokenizer.py")
Tokenizer = tokenizer.Tokenizer
TS_RESOLUTION = tokenizer.TS_RESOLUTION
LANGUAGES = tokenizer.LANGUAGES

# the numpy denoise chain and its noise classifier (host side)
np_dsp = _load_by_path("speaksense_tpu_torch._np_dsp", _JAX_PACKAGE / "audio" / "dsp.py")
