"""ggml (whisper.cpp) checkpoint format: parser, quant codecs, and a writer.

The port's own copy of `speaksense_tpu/ckpt/ggml.py`, with the same names,
layouts and results. whisper.cpp's ggml files (the default model path is
`./models/ggml-large-v3.bin`, an f16 file; the quantized variants use
Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 blocks) are read natively:

  int32 magic 0x67676d6c ('ggml' LE)
  11 × int32 hparams: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
      n_audio_layer, n_text_ctx, n_text_state, n_text_head, n_text_layer,
      n_mels, ftype
  mel filterbank: int32 n_mel, int32 n_fft_bins, then f32[n_mel * n_fft_bins]
  vocab: int32 n_vocab_file, then n_vocab_file × (int32 len, bytes)
  tensors until EOF: int32 n_dims, int32 name_len, int32 ttype,
      int32 ne[n_dims] (ne[0] fastest-varying), name bytes, raw data
      (no alignment padding)

Tensors of 65,536 elements or more are decoded by the multithreaded C++
kernels of `speaksense_tpu_torch/native` (the JAX package's rule); the
vectorized numpy codecs below are the reference and decode the rest, every
tensor with `use_native=False`, and every tensor where g++ is missing. The
results are the same. Unlike the JAX package, a native build or call that
fails where g++ is present raises instead of falling back to numpy. The
writer fabricates checkpoints from seeded weights for the tests and the
chip smoke test.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from speaksense_tpu_torch.models.whisper import WhisperDims

GGML_MAGIC = 0x67676D6C

# ggml tensor dtypes (subset whisper ships)
F32, F16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 = 0, 1, 2, 3, 6, 7, 8
QK = 32  # quant block size, all formats

_TYPE_NAMES = {F32: "f32", F16: "f16", Q4_0: "q4_0", Q4_1: "q4_1",
               Q5_0: "q5_0", Q5_1: "q5_1", Q8_0: "q8_0"}


# ---------------------------------------------------------------------------
# block codecs (numpy-vectorized over all blocks of a tensor at once)
# ---------------------------------------------------------------------------

def _f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16)


def dequantize(data: bytes, ttype: int, n: int, use_native: bool = True) -> np.ndarray:
    """Decode `n` elements of ggml type `ttype` from raw bytes -> f32.

    With use_native, tensors of 65,536 elements or more go through the C++
    kernels (`native.dequantize_native`) when g++ is present; the numpy
    codecs below are the reference and take the rest."""
    if use_native and n >= (1 << 16):
        from speaksense_tpu_torch.native import dequantize_native

        out = dequantize_native(data, ttype, n)
        if out is not None:
            return out
    if ttype == F32:
        return np.frombuffer(data, "<f4", count=n).copy()
    if ttype == F16:
        return np.frombuffer(data, "<f2", count=n).astype(np.float32)
    assert n % QK == 0, f"quantized tensor size {n} not a multiple of {QK}"
    nb = n // QK
    raw = np.frombuffer(data, np.uint8)
    if ttype == Q4_0:
        rec = raw[: nb * 18].reshape(nb, 18)
        d = rec[:, :2].copy().view("<f2").astype(np.float32)  # (nb,1)
        qs = rec[:, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)
    if ttype == Q4_1:
        rec = raw[: nb * 20].reshape(nb, 20)
        d = rec[:, :2].copy().view("<f2").astype(np.float32)
        m = rec[:, 2:4].copy().view("<f2").astype(np.float32)
        qs = rec[:, 4:]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)
    if ttype == Q5_0:
        rec = raw[: nb * 22].reshape(nb, 22)
        d = rec[:, :2].copy().view("<f2").astype(np.float32)
        qh = rec[:, 2:6].copy().view("<u4")  # (nb,1)
        qs = rec[:, 6:]
        j = np.arange(16)
        xh0 = ((qh >> j) << 4) & 0x10          # (nb,16)
        xh1 = (qh >> (j + 12)) & 0x10
        lo = ((qs & 0x0F) | xh0).astype(np.int16) - 16
        hi = ((qs >> 4) | xh1).astype(np.int16) - 16
        return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)
    if ttype == Q5_1:
        rec = raw[: nb * 24].reshape(nb, 24)
        d = rec[:, :2].copy().view("<f2").astype(np.float32)
        m = rec[:, 2:4].copy().view("<f2").astype(np.float32)
        qh = rec[:, 4:8].copy().view("<u4")
        qs = rec[:, 8:]
        j = np.arange(16)
        xh0 = ((qh >> j) << 4) & 0x10
        xh1 = (qh >> (j + 12)) & 0x10
        lo = ((qs & 0x0F) | xh0).astype(np.float32)
        hi = ((qs >> 4) | xh1).astype(np.float32)
        return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)
    if ttype == Q8_0:
        rec = raw[: nb * 34].reshape(nb, 34)
        d = rec[:, :2].copy().view("<f2").astype(np.float32)
        qs = rec[:, 2:].view(np.int8).astype(np.float32)
        return (qs * d).astype(np.float32).reshape(-1)
    raise ValueError(f"unsupported ggml tensor type {ttype}")


def quantize(x: np.ndarray, ttype: int) -> bytes:
    """Encode f32 -> ggml blocks (reference-scheme scales). Used by the test
    checkpoint writer and by weight-cache compaction."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if ttype == F32:
        return x.tobytes()
    if ttype == F16:
        return x.astype(np.float16).tobytes()
    assert x.size % QK == 0
    v = x.reshape(-1, QK)
    nb = v.shape[0]
    if ttype in (Q4_0, Q5_0):
        shift, maxq = (8, 15) if ttype == Q4_0 else (16, 31)
        amax_i = np.argmax(np.abs(v), axis=1)
        mx = v[np.arange(nb), amax_i]          # signed max-magnitude value
        d = mx / -shift
        id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = np.clip((v * id_[:, None] + (shift + 0.5)).astype(np.int32), 0, maxq).astype(np.uint8)
    elif ttype in (Q4_1, Q5_1):
        maxq = 15 if ttype == Q4_1 else 31
        mn, mx = v.min(axis=1), v.max(axis=1)
        d = (mx - mn) / maxq
        id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = np.clip(((v - mn[:, None]) * id_[:, None] + 0.5).astype(np.int32), 0, maxq).astype(np.uint8)
    elif ttype == Q8_0:
        amax = np.abs(v).max(axis=1)
        d = amax / 127.0
        id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = np.round(v * id_[:, None]).astype(np.int8)
        out = np.empty((nb, 34), np.uint8)
        out[:, :2] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
        out[:, 2:] = q.view(np.uint8)
        return out.tobytes()
    else:
        raise ValueError(f"unsupported ggml tensor type {ttype}")

    lo, hi = q[:, :16], q[:, 16:]
    if ttype in (Q4_0, Q4_1):
        qs = (lo & 0x0F) | (hi << 4)
        if ttype == Q4_0:
            out = np.empty((nb, 18), np.uint8)
            out[:, :2] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
            out[:, 2:] = qs
        else:
            out = np.empty((nb, 20), np.uint8)
            out[:, :2] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
            out[:, 2:4] = _f16(mn)[:, None].view(np.uint8).reshape(nb, 2)
            out[:, 4:] = qs
        return out.tobytes()
    # Q5_0 / Q5_1: 5th bits packed into qh
    qs = (lo & 0x0F) | ((hi & 0x0F) << 4)
    j = np.arange(16)
    qh = (((lo >> 4) & 1).astype(np.uint32) << j).sum(axis=1, dtype=np.uint32) \
        | (((hi >> 4) & 1).astype(np.uint32) << (j + 16)).sum(axis=1, dtype=np.uint32)
    if ttype == Q5_0:
        out = np.empty((nb, 22), np.uint8)
        out[:, :2] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
        out[:, 2:6] = qh[:, None].view(np.uint8).reshape(nb, 4)
        out[:, 6:] = qs
    else:
        out = np.empty((nb, 24), np.uint8)
        out[:, :2] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = _f16(mn)[:, None].view(np.uint8).reshape(nb, 2)
        out[:, 4:8] = qh[:, None].view(np.uint8).reshape(nb, 4)
        out[:, 8:] = qs
    return out.tobytes()


def _quant_nbytes(ttype: int, n: int) -> int:
    per_block = {F32: QK * 4, F16: QK * 2, Q4_0: 18, Q4_1: 20, Q5_0: 22, Q5_1: 24, Q8_0: 34}[ttype]
    if ttype == F32:
        return n * 4
    if ttype == F16:
        return n * 2
    return (n // QK) * per_block


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

@dataclass
class GgmlModel:
    dims: WhisperDims
    ftype: int
    filters: np.ndarray          # (n_mels, n_fft_bins) f32 mel filterbank
    vocab: list[bytes]           # id -> raw token bytes, len == dims.n_vocab
    tensors: dict[str, np.ndarray]  # name -> f32 array in *torch* layout


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"ggml file truncated: wanted {n} bytes, got {len(b)}")
    return b


def _block_index(name: str) -> int:
    """The layer index of an "encoder.blocks.i." / "decoder.blocks.i."
    tensor name, -1 for the others."""
    parts = name.split(".")
    return int(parts[2]) if len(parts) > 2 and parts[1] == "blocks" else -1


def load_ggml(path_or_file, max_layers: int | None = None,
              use_native: bool = True) -> GgmlModel:
    """Parse a whisper ggml checkpoint into numpy tensors (dequantized f32).

    max_layers cuts the depth: only encoder and decoder blocks below it are
    read (the others are skipped unread) and the dims say so. use_native is
    `dequantize`'s."""
    f = open(path_or_file, "rb") if isinstance(path_or_file, (str, bytes)) else path_or_file
    close = isinstance(path_or_file, (str, bytes))
    try:
        (magic,) = struct.unpack("<i", _read_exact(f, 4))
        if magic != GGML_MAGIC:
            raise ValueError(f"not a ggml file (magic {magic:#x})")
        hp = struct.unpack("<11i", _read_exact(f, 44))
        dims = WhisperDims(
            n_vocab=hp[0], n_audio_ctx=hp[1], n_audio_state=hp[2],
            n_audio_head=hp[3], n_audio_layer=hp[4], n_text_ctx=hp[5],
            n_text_state=hp[6], n_text_head=hp[7], n_text_layer=hp[8],
            n_mels=hp[9],
        )
        ftype = hp[10]
        if max_layers is not None:
            dims = dataclasses.replace(dims, n_audio_layer=min(dims.n_audio_layer, max_layers),
                                       n_text_layer=min(dims.n_text_layer, max_layers))
        n_mel, n_fft = struct.unpack("<2i", _read_exact(f, 8))
        filters = np.frombuffer(_read_exact(f, 4 * n_mel * n_fft), "<f4").reshape(n_mel, n_fft).copy()
        (n_vocab_file,) = struct.unpack("<i", _read_exact(f, 4))
        vocab: list[bytes] = []
        for _ in range(n_vocab_file):
            (ln,) = struct.unpack("<i", _read_exact(f, 4))
            vocab.append(_read_exact(f, ln))
        # whisper.cpp pads missing ids with synthetic tokens
        for i in range(len(vocab), dims.n_vocab):
            vocab.append(b"[_extra_token_%d]" % i)

        tensors: dict[str, np.ndarray] = {}
        while True:
            head = f.read(12)
            if len(head) == 0:
                break
            if len(head) < 12:
                raise EOFError("truncated tensor header")
            n_dims, name_len, ttype = struct.unpack("<3i", head)
            ne = struct.unpack(f"<{n_dims}i", _read_exact(f, 4 * n_dims))
            name = _read_exact(f, name_len).decode("utf-8")
            n = int(np.prod(ne))
            nbytes = _quant_nbytes(ttype, n)
            if max_layers is not None and _block_index(name) >= max_layers:
                f.seek(nbytes, io.SEEK_CUR)
                continue
            arr = dequantize(_read_exact(f, nbytes), ttype, n, use_native)
            # ne[0] is fastest-varying -> numpy shape is reversed(ne)
            tensors[name] = arr.reshape(tuple(reversed(ne)))
        return GgmlModel(dims=dims, ftype=ftype, filters=filters, vocab=vocab, tensors=tensors)
    finally:
        if close:
            f.close()


def write_ggml(model: GgmlModel, path_or_file, ftype: int = F16,
               tensor_types: dict[str, int] | None = None) -> None:
    """Serialize a GgmlModel. 1-D and norm/bias tensors stay f32 (whisper.cpp
    convention); others use `ftype` unless overridden per-tensor."""
    f = open(path_or_file, "wb") if isinstance(path_or_file, (str, bytes)) else path_or_file
    close = isinstance(path_or_file, (str, bytes))
    try:
        d = model.dims
        f.write(struct.pack("<12i", GGML_MAGIC, d.n_vocab, d.n_audio_ctx, d.n_audio_state,
                            d.n_audio_head, d.n_audio_layer, d.n_text_ctx, d.n_text_state,
                            d.n_text_head, d.n_text_layer, d.n_mels, ftype))
        filt = np.ascontiguousarray(model.filters, np.float32)
        f.write(struct.pack("<2i", filt.shape[0], filt.shape[1]))
        f.write(filt.tobytes())
        f.write(struct.pack("<i", len(model.vocab)))
        for tok in model.vocab:
            f.write(struct.pack("<i", len(tok)))
            f.write(tok)
        for name, arr in model.tensors.items():
            arr = np.ascontiguousarray(arr, np.float32)
            tt = (tensor_types or {}).get(name)
            if tt is None:
                tt = F32 if (arr.ndim == 1 or arr.size % QK != 0) else ftype
            ne = tuple(reversed(arr.shape))
            nb = name.encode("utf-8")
            f.write(struct.pack("<3i", arr.ndim, len(nb), tt))
            f.write(struct.pack(f"<{arr.ndim}i", *ne))
            f.write(nb)
            f.write(quantize(arr, tt))
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# ggml tensors (torch layout) -> speaksense parameter pytree
# ---------------------------------------------------------------------------

def params_from_ggml(model: GgmlModel, dtype=np.float32) -> dict:
    """Map whisper.cpp tensor names/layouts into the stacked-block pytree of
    models/whisper.py (linear weights transposed to (in, out))."""
    t = model.tensors
    d = model.dims

    def lin(name: str, bias: bool = True) -> dict:
        p = {"w": t[f"{name}.weight"].T.astype(dtype)}
        if bias:
            p["b"] = t[f"{name}.bias"].reshape(-1).astype(dtype)
        return p

    def ln(name: str) -> dict:
        return {"g": t[f"{name}.weight"].reshape(-1).astype(dtype),
                "b": t[f"{name}.bias"].reshape(-1).astype(dtype)}

    def stack(blocks: list[dict]) -> dict:
        out: dict = {}
        for key in blocks[0]:
            if isinstance(blocks[0][key], dict):
                out[key] = stack([b[key] for b in blocks])
            else:
                out[key] = np.stack([b[key] for b in blocks])
        return out

    enc_blocks = []
    for i in range(d.n_audio_layer):
        pre = f"encoder.blocks.{i}"
        enc_blocks.append({
            "attn_ln": ln(f"{pre}.attn_ln"),
            "q": lin(f"{pre}.attn.query"),
            "k": lin(f"{pre}.attn.key", bias=False),
            "v": lin(f"{pre}.attn.value"),
            "o": lin(f"{pre}.attn.out"),
            "mlp_ln": ln(f"{pre}.mlp_ln"),
            "fc1": lin(f"{pre}.mlp.0"),
            "fc2": lin(f"{pre}.mlp.2"),
        })
    dec_blocks = []
    for i in range(d.n_text_layer):
        pre = f"decoder.blocks.{i}"
        dec_blocks.append({
            "attn_ln": ln(f"{pre}.attn_ln"),
            "q": lin(f"{pre}.attn.query"),
            "k": lin(f"{pre}.attn.key", bias=False),
            "v": lin(f"{pre}.attn.value"),
            "o": lin(f"{pre}.attn.out"),
            "cross_ln": ln(f"{pre}.cross_attn_ln"),
            "cq": lin(f"{pre}.cross_attn.query"),
            "ck": lin(f"{pre}.cross_attn.key", bias=False),
            "cv": lin(f"{pre}.cross_attn.value"),
            "co": lin(f"{pre}.cross_attn.out"),
            "mlp_ln": ln(f"{pre}.mlp_ln"),
            "fc1": lin(f"{pre}.mlp.0"),
            "fc2": lin(f"{pre}.mlp.2"),
        })

    return {
        "encoder": {
            "conv1": {"w": t["encoder.conv1.weight"].transpose(2, 1, 0).astype(dtype),
                      "b": t["encoder.conv1.bias"].reshape(-1).astype(dtype)},
            "conv2": {"w": t["encoder.conv2.weight"].transpose(2, 1, 0).astype(dtype),
                      "b": t["encoder.conv2.bias"].reshape(-1).astype(dtype)},
            "pos": t["encoder.positional_embedding"].astype(dtype),
            "blocks": stack(enc_blocks),
            "ln_post": ln("encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": t["decoder.token_embedding.weight"].astype(dtype),
            "pos": t["decoder.positional_embedding"].astype(dtype),
            "blocks": stack(dec_blocks),
            "ln": ln("decoder.ln"),
        },
    }


def ggml_tensors_from_params(params: dict, dims: WhisperDims) -> dict[str, np.ndarray]:
    """Inverse of params_from_ggml (pytree -> torch-layout named tensors);
    used by the test-checkpoint writer."""
    p = params
    out: dict[str, np.ndarray] = {}
    out["encoder.conv1.weight"] = np.asarray(p["encoder"]["conv1"]["w"]).transpose(2, 1, 0)
    out["encoder.conv1.bias"] = np.asarray(p["encoder"]["conv1"]["b"])
    out["encoder.conv2.weight"] = np.asarray(p["encoder"]["conv2"]["w"]).transpose(2, 1, 0)
    out["encoder.conv2.bias"] = np.asarray(p["encoder"]["conv2"]["b"])
    out["encoder.positional_embedding"] = np.asarray(p["encoder"]["pos"])

    def layer(tree: dict, i: int) -> dict:
        return {k: layer(v, i) if isinstance(v, dict) else np.asarray(v[i])
                for k, v in tree.items()}

    def emit_lin(name, q, bias=True):
        out[f"{name}.weight"] = q["w"].T
        if bias:
            out[f"{name}.bias"] = q["b"]

    def emit_ln(name, q):
        out[f"{name}.weight"] = q["g"]
        out[f"{name}.bias"] = q["b"]

    for i in range(dims.n_audio_layer):
        b = layer(p["encoder"]["blocks"], i)
        pre = f"encoder.blocks.{i}"
        emit_ln(f"{pre}.attn_ln", b["attn_ln"])
        emit_lin(f"{pre}.attn.query", b["q"])
        emit_lin(f"{pre}.attn.key", b["k"], bias=False)
        emit_lin(f"{pre}.attn.value", b["v"])
        emit_lin(f"{pre}.attn.out", b["o"])
        emit_ln(f"{pre}.mlp_ln", b["mlp_ln"])
        emit_lin(f"{pre}.mlp.0", b["fc1"])
        emit_lin(f"{pre}.mlp.2", b["fc2"])
    emit_ln("encoder.ln_post", {k: np.asarray(v) for k, v in p["encoder"]["ln_post"].items()})

    out["decoder.token_embedding.weight"] = np.asarray(p["decoder"]["tok_emb"])
    out["decoder.positional_embedding"] = np.asarray(p["decoder"]["pos"])
    for i in range(dims.n_text_layer):
        b = layer(p["decoder"]["blocks"], i)
        pre = f"decoder.blocks.{i}"
        emit_ln(f"{pre}.attn_ln", b["attn_ln"])
        emit_lin(f"{pre}.attn.query", b["q"])
        emit_lin(f"{pre}.attn.key", b["k"], bias=False)
        emit_lin(f"{pre}.attn.value", b["v"])
        emit_lin(f"{pre}.attn.out", b["o"])
        emit_ln(f"{pre}.cross_attn_ln", b["cross_ln"])
        emit_lin(f"{pre}.cross_attn.query", b["cq"])
        emit_lin(f"{pre}.cross_attn.key", b["ck"], bias=False)
        emit_lin(f"{pre}.cross_attn.value", b["cv"])
        emit_lin(f"{pre}.cross_attn.out", b["co"])
        emit_ln(f"{pre}.mlp_ln", b["mlp_ln"])
        emit_lin(f"{pre}.mlp.0", b["fc1"])
        emit_lin(f"{pre}.mlp.2", b["fc2"])
    emit_ln("decoder.ln", {k: np.asarray(v) for k, v in p["decoder"]["ln"].items()})
    return out
