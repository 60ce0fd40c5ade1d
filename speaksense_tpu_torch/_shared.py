"""Jax-free access to the shared tokenizer.

`speaksense_tpu/models/tokenizer.py` imports only dataclasses and numpy, but
importing it as `speaksense_tpu.models.tokenizer` runs
`speaksense_tpu/models/__init__.py`, which imports the JAX model. This module
loads that one file under a private module name instead, so the port keeps a
single copy of the BPE and special-token code and never pulls in jax.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_TOKENIZER_PATH = (Path(__file__).resolve().parent.parent
                   / "speaksense_tpu" / "models" / "tokenizer.py")
_MODULE_NAME = "speaksense_tpu_torch._tokenizer"


def _load_tokenizer_module():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(_MODULE_NAME, _TOKENIZER_PATH)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the shared tokenizer from {_TOKENIZER_PATH}")
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolve the defining module through sys.modules while the
    # class body runs, so register before executing
    sys.modules[_MODULE_NAME] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[_MODULE_NAME]
        raise
    return mod


tokenizer = _load_tokenizer_module()
Tokenizer = tokenizer.Tokenizer
TS_RESOLUTION = tokenizer.TS_RESOLUTION
LANGUAGES = tokenizer.LANGUAGES
