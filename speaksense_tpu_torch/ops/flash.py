"""Encoder flash attention: a hand-written Hopper CUDA kernel and its plain
PyTorch version.

`flash_attention_full(q, k, v)` computes non-causal softmax(q kᵀ · Dh⁻⁰·⁵) v
over (B, H, T, Dh) operands, the counterpart of
`speaksense_tpu/ops/flash.py::flash_attention_full`. A CUDA tensor always
goes to the kernel in `csrc/flash_attn_fwd.cu` (bf16, Dh = 64); a CPU tensor
goes to `flash_attention_ref`. There is no fallback from one to the other.

The kernel is compiled by `nvcc` at first use into `_build/` (keyed by a
hash of the sources) and loaded with ctypes, so nothing is built or imported
from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = ("flash_attn_fwd.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIM = 64
NEG_INF = -1e30

_lib = None
_lib_lock = threading.Lock()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention with the JAX reference's rounding (`W._attention`):
    f32 logits and softmax, masked logits at -1e30 (mask: True = keep),
    weights cast to the input dtype before the PV product, f32
    accumulation, output in the input dtype. The decoder's attention uses
    it with a mask."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    """Path of the built shared library for the current sources."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD / f"libflash_attn_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel sources with nvcc unless the library for these
    sources exists already. The compiler's output (`-Xptxas -v`: registers,
    shared memory, spills) is kept beside the library as `<name>.log`."""
    so = library_path()
    if so.is_file():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.flash_attn_fwd_bf16
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along Dh (stride {x.stride(-1)})")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned rows (strides {x.stride()})")


def flash_attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, H, T, Dh). CUDA tensors run the Hopper
    kernel (bf16, Dh = 64, Dh-contiguous strides, so views of a fused-QKV
    output pass without a copy); CPU tensors run `flash_attention_ref`.

    The CUDA result is a (B, H, T, Dh) view of a (B, T, H, Dh) buffer, so the
    caller's head merge is a free reshape."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, Dh) operands, got {tuple(q.shape)}")
    B, H, T, Dh = q.shape
    if Dh != HEAD_DIM or T < 1:
        raise ValueError(f"kernel takes Dh={HEAD_DIM} and T >= 1, got {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.shape)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _load()
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attn_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), B, H, T, *strides,
                                     float(Dh ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16 launch failed: CUDA error {rc}")
    flash_attention_full.launches += 1
    return out


flash_attention_full.launches = 0
