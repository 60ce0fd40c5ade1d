"""HuggingFace WhisperModel state-dict -> the parameter pytree (numpy, the
JAX package's layout, which `models/whisper.py::params_from_jax` takes).

The port's own copy of `speaksense_tpu/ckpt/hf.py`, with the same names and
results; `ckpt/hf_dir.py` uses it to load HF-format checkpoint directories
as an alternative to ggml files.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from speaksense_tpu_torch.models.whisper import WhisperDims


def dims_from_hf_config(cfg: Any) -> WhisperDims:
    return WhisperDims(
        n_mels=cfg.num_mel_bins,
        n_vocab=cfg.vocab_size,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
    )


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def params_from_hf_state_dict(sd: Mapping[str, Any], dims: WhisperDims, dtype=np.float32) -> dict:
    """Convert a WhisperModel state dict (keys 'encoder.*'/'decoder.*'; a
    leading 'model.' prefix is stripped) into the stacked-block pytree."""
    sd = { (k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items() }

    def lin(prefix: str, bias: bool = True) -> dict:
        p = {"w": _np(sd[f"{prefix}.weight"]).T.astype(dtype)}
        if bias:
            p["b"] = _np(sd[f"{prefix}.bias"]).astype(dtype)
        return p

    def ln(prefix: str) -> dict:
        return {"g": _np(sd[f"{prefix}.weight"]).astype(dtype),
                "b": _np(sd[f"{prefix}.bias"]).astype(dtype)}

    def stack(blocks: list[dict]) -> dict:
        out: dict = {}
        for key in blocks[0]:
            if isinstance(blocks[0][key], dict):
                out[key] = stack([b[key] for b in blocks])
            else:
                out[key] = np.stack([b[key] for b in blocks])
        return out

    enc_blocks = []
    for i in range(dims.n_audio_layer):
        pre = f"encoder.layers.{i}"
        enc_blocks.append({
            "attn_ln": ln(f"{pre}.self_attn_layer_norm"),
            "q": lin(f"{pre}.self_attn.q_proj"),
            "k": lin(f"{pre}.self_attn.k_proj", bias=False),
            "v": lin(f"{pre}.self_attn.v_proj"),
            "o": lin(f"{pre}.self_attn.out_proj"),
            "mlp_ln": ln(f"{pre}.final_layer_norm"),
            "fc1": lin(f"{pre}.fc1"),
            "fc2": lin(f"{pre}.fc2"),
        })

    dec_blocks = []
    for i in range(dims.n_text_layer):
        pre = f"decoder.layers.{i}"
        dec_blocks.append({
            "attn_ln": ln(f"{pre}.self_attn_layer_norm"),
            "q": lin(f"{pre}.self_attn.q_proj"),
            "k": lin(f"{pre}.self_attn.k_proj", bias=False),
            "v": lin(f"{pre}.self_attn.v_proj"),
            "o": lin(f"{pre}.self_attn.out_proj"),
            "cross_ln": ln(f"{pre}.encoder_attn_layer_norm"),
            "cq": lin(f"{pre}.encoder_attn.q_proj"),
            "ck": lin(f"{pre}.encoder_attn.k_proj", bias=False),
            "cv": lin(f"{pre}.encoder_attn.v_proj"),
            "co": lin(f"{pre}.encoder_attn.out_proj"),
            "mlp_ln": ln(f"{pre}.final_layer_norm"),
            "fc1": lin(f"{pre}.fc1"),
            "fc2": lin(f"{pre}.fc2"),
        })

    return {
        "encoder": {
            "conv1": {"w": _np(sd["encoder.conv1.weight"]).transpose(2, 1, 0).astype(dtype),
                      "b": _np(sd["encoder.conv1.bias"]).astype(dtype)},
            "conv2": {"w": _np(sd["encoder.conv2.weight"]).transpose(2, 1, 0).astype(dtype),
                      "b": _np(sd["encoder.conv2.bias"]).astype(dtype)},
            "pos": _np(sd["encoder.embed_positions.weight"]).astype(dtype),
            "blocks": stack(enc_blocks),
            "ln_post": ln("encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": _np(sd["decoder.embed_tokens.weight"]).astype(dtype),
            "pos": _np(sd["decoder.embed_positions.weight"]).astype(dtype),
            "blocks": stack(dec_blocks),
            "ln": ln("decoder.layer_norm"),
        },
    }
