"""Convert-once weight cache.

The port's own copy of `speaksense_tpu/ckpt/cache.py`, with the same npz +
json format, file names, `CACHE_VERSION` and source signature (size,
mtime), so a cache written by either package is read by the other.
Parsing and dequantizing a ~3 GB ggml file costs tens of seconds; the
converted flat npz of the parameter pytree loads in a few. A changed source
invalidates the entry, and a cache that cannot be read is converted again
with a warning; a missing source file raises.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

CACHE_VERSION = 1


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _cache_paths(src: Path, cache_dir: Path) -> tuple[Path, Path]:
    base = cache_dir / src.name
    return base.with_suffix(".cache.npz"), base.with_suffix(".cache.json")


def _src_sig(src: Path) -> dict:
    st = src.stat()
    return {"version": CACHE_VERSION, "size": st.st_size, "mtime": int(st.st_mtime)}


def load_cached(src_path: str | Path, cache_dir: str | Path):
    """Returns (params, meta) from cache, or None on miss/invalidation.
    meta carries dims/vocab/filters."""
    src, cache_dir = Path(src_path), Path(cache_dir)
    npz_path, meta_path = _cache_paths(src, cache_dir)
    if not (npz_path.is_file() and meta_path.is_file()):
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if meta.get("sig") != _src_sig(src):
            return None
        with np.load(npz_path) as z:
            flat = {k: z[k] for k in z.files}
        params = _unflatten({k: v for k, v in flat.items() if k.startswith("params/")})["params"]
        filters = flat.get("filters")
        vocab = [bytes.fromhex(h) for h in meta["vocab_hex"]]
        return params, dict(dims=meta["dims"], vocab=vocab, filters=filters,
                            ftype=meta.get("ftype"))
    except Exception as e:
        log.warning("weight cache read failed (%s); re-converting", e)
        return None


def save_cached(src_path: str | Path, cache_dir: str | Path, params: dict,
                dims_dict: dict, vocab: list[bytes], filters: np.ndarray | None,
                ftype: int | None = None) -> None:
    src, cache_dir = Path(src_path), Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    npz_path, meta_path = _cache_paths(src, cache_dir)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    if filters is not None:
        flat["filters"] = np.asarray(filters, np.float32)
    tmp = npz_path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, npz_path)
    meta_path.write_text(json.dumps({
        "sig": _src_sig(src), "dims": dims_dict, "ftype": ftype,
        "vocab_hex": [v.hex() for v in vocab],
    }))
    log.info("cached converted weights at %s", npz_path)
