"""Load HuggingFace-format Whisper checkpoints from a local directory
(config.json + model.safetensors[.index.json]) — covers distil-whisper and
other HF-only releases alongside the ggml path. The port's own copy of
`speaksense_tpu/ckpt/hf_dir.py`, with the same names and results.

The safetensors container is parsed directly (header-length u64 LE, JSON
header with dtype/shape/offsets, then raw little-endian tensor data) so no
safetensors package is required.
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path

import numpy as np

from speaksense_tpu_torch.ckpt.hf import params_from_hf_state_dict
from speaksense_tpu_torch.models.whisper import WhisperDims

log = logging.getLogger(__name__)

_DTYPES = {
    "F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": None,  # special
    "F64": np.dtype("<f8"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"),
    "BOOL": np.dtype("bool"),
}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        out: dict[str, np.ndarray] = {}
        data = f.read()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        blob = data[start:end]
        shape = tuple(meta["shape"])
        dt = meta["dtype"]
        if dt == "BF16":
            arr = np.frombuffer(blob, "<u2").astype(np.uint32)
            arr = (arr << 16).view(np.float32).reshape(shape)
        else:
            arr = np.frombuffer(blob, _DTYPES[dt]).reshape(shape)
            if dt in ("F16", "F64"):
                arr = arr.astype(np.float32)
        out[name] = arr
    return out


def load_hf_dir(path: str | Path):
    """Directory -> (params, dims). Handles single and sharded safetensors;
    decoder-only 'proj_out' tied weights are ignored (we tie to tok_emb)."""
    path = Path(path)
    cfg = json.loads((path / "config.json").read_text())
    dims = WhisperDims(
        n_mels=cfg["num_mel_bins"], n_vocab=cfg["vocab_size"],
        n_audio_ctx=cfg["max_source_positions"], n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"], n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"], n_text_layer=cfg["decoder_layers"],
    )
    index = path / "model.safetensors.index.json"
    sd: dict[str, np.ndarray] = {}
    if index.is_file():
        weight_map = json.loads(index.read_text())["weight_map"]
        for shard in sorted(set(weight_map.values())):
            sd.update(read_safetensors(path / shard))
    else:
        sd = read_safetensors(path / "model.safetensors")
    sd = {k: v for k, v in sd.items() if not k.endswith("proj_out.weight")}
    params = params_from_hf_state_dict(sd, dims)
    log.info("loaded HF checkpoint %s (dims=%s)", path, dims)
    return params, dims
