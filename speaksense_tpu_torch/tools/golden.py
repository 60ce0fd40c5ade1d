"""Seeded large-v3-width checkpoints and the large-v3 parity fixture.

`seeded_ggml_tensors` draws every tensor of a whisper checkpoint from its
own seeded generator (so a loaded checkpoint can be held against the
source again), and `write_seeded` writes them as a ggml file: the chip
smoke's ckpt phase loads such files at large-v3 width, and
`tests/test_torch_golden.py` makes the parity fixture
`tests/golden/large_v3_f32.json` from one with the JAX package at f32.
`readings` takes from the port what that fixture records (encoder states,
the first step's top-20 logits, argmax tokens) and `errors` holds them
against it, within ENC_RTOL and LOGITS_RTOL, with the tokens equal.
"""

from __future__ import annotations

import numpy as np
import torch

from speaksense_tpu_torch.models import whisper as W

# the parity fixture's bounds, relative L2 at f32 (TF32 off on the card)
ENC_RTOL = 1e-3
LOGITS_RTOL = 1e-3


def seeded_ggml_tensors(dims, seed: int):
    """(name, f32 array) of every tensor of a whisper checkpoint of `dims`,
    in whisper.cpp's names, order and (out, in) layout, each drawn from its
    own seeded generator so the set can be drawn again for the check:
    weights at 1/sqrt(fan-in), embeddings at 0.02, layer-norm gains near 1
    and small biases."""
    d, dt = dims.n_audio_state, dims.n_text_state
    specs = [("encoder.conv1.weight", (d, dims.n_mels, 3)), ("encoder.conv1.bias", (d,)),
             ("encoder.conv2.weight", (d, d, 3)), ("encoder.conv2.bias", (d,)),
             ("encoder.positional_embedding", (dims.n_audio_ctx, d))]

    def block(pre, width, cross):
        out = [(f"{pre}.attn_ln.weight", (width,)), (f"{pre}.attn_ln.bias", (width,))]
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            if attn == "cross_attn":
                out += [(f"{pre}.cross_attn_ln.weight", (width,)),
                        (f"{pre}.cross_attn_ln.bias", (width,))]
            for proj in ("query", "key", "value", "out"):
                out.append((f"{pre}.{attn}.{proj}.weight", (width, width)))
                if proj != "key":
                    out.append((f"{pre}.{attn}.{proj}.bias", (width,)))
        return out + [(f"{pre}.mlp_ln.weight", (width,)), (f"{pre}.mlp_ln.bias", (width,)),
                      (f"{pre}.mlp.0.weight", (4 * width, width)), (f"{pre}.mlp.0.bias", (4 * width,)),
                      (f"{pre}.mlp.2.weight", (width, 4 * width)), (f"{pre}.mlp.2.bias", (width,))]

    for i in range(dims.n_audio_layer):
        specs += block(f"encoder.blocks.{i}", d, cross=False)
    specs += [("encoder.ln_post.weight", (d,)), ("encoder.ln_post.bias", (d,)),
              ("decoder.token_embedding.weight", (dims.n_vocab, dt)),
              ("decoder.positional_embedding", (dims.n_text_ctx, dt))]
    for i in range(dims.n_text_layer):
        specs += block(f"decoder.blocks.{i}", dt, cross=True)
    specs += [("decoder.ln.weight", (dt,)), ("decoder.ln.bias", (dt,))]

    for idx, (name, shape) in enumerate(specs):
        x = np.random.default_rng([seed, idx]).standard_normal(shape, dtype=np.float32)
        if "embedding" in name:
            x *= 0.02
        elif len(shape) > 1:
            x *= 1.0 / np.sqrt(np.prod(shape[1:]))
        elif "ln" in name.split(".")[-2] and name.endswith("weight"):
            x = 1.0 + 0.02 * x
        else:
            x *= 0.02
        yield name, x


class SeededTensors:
    """The tensors of `seeded_ggml_tensors` as `write_ggml` reads them
    (`.items()`), drawn one at a time so the full-width set never sits in
    host memory."""

    def __init__(self, dims, seed: int):
        self.dims, self.seed = dims, seed

    def items(self):
        return seeded_ggml_tensors(self.dims, self.seed)


def write_seeded(path, dims, seed: int, ftype: int) -> None:
    """A ggml file of `dims` holding `seeded_ggml_tensors(dims, seed)` in
    `ftype` (its vocab holds the text pieces only; the loader pads the
    rest)."""
    from speaksense_tpu_torch.audio import mel as MEL
    from speaksense_tpu_torch.ckpt.ggml import GgmlModel, write_ggml

    write_ggml(GgmlModel(dims=dims, ftype=ftype, filters=MEL.mel_filter_bank(dims.n_mels),
                         vocab=[b"<%d>" % i for i in range(50257)],
                         tensors=SeededTensors(dims, seed)), str(path), ftype=ftype)


def seeded_mel(n_mels: int, seed: int) -> np.ndarray:
    """A seeded (1, 3000, n_mels) f32 mel of one 30 s window."""
    return np.random.default_rng(seed).standard_normal((1, 3000, n_mels)).astype(np.float32)


def readings(model, mel, prompt, n_tokens: int, ids: list) -> dict:
    """What the parity fixture records, from the port at the model's
    dtype: the encoder states' norm and rows 0, 500, 1000 and 1499 of
    their first 8 channels, the first step's 20 largest logits (ids and
    values) after the prompt and its logits at `ids` (the fixture's top
    20), and n_tokens argmax tokens (the first step's, then each decode
    step's; no logit rules). The encoder's attention is
    `W.flash_attention_full` (the plain version on the CPU)."""
    with torch.no_grad():
        enc = W.encode(model, mel)
        P = prompt.shape[1]
        cache = W.new_cache(model, W.compute_cross_kv(model, enc), P + n_tokens)
        first = W.decode_prefill(model, prompt, cache)[:, -1]
        toks = [first.argmax(-1)]
        plen = torch.full((1,), P, dtype=torch.long, device=prompt.device)
        for step in range(n_tokens - 1):
            toks.append(W.decode_step(model, toks[-1], cache, step, plen, P).argmax(-1))
    top = first[0].topk(20)
    return {"enc_norm": float(enc.norm()),
            "enc_rows": enc[0, [0, 500, 1000, 1499], :8].tolist(),
            "top20_ids": top.indices.tolist(), "top20_logits": top.values.tolist(),
            "at_ids": first[0, ids].tolist(), "tokens": torch.stack(toks, 1)[0].tolist()}


def errors(got: dict, want: dict) -> dict:
    """Relative L2 of the encoder rows and norm, and of the logits at the
    fixture's top-20 ids; whether the tokens are equal."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    return {"enc_rows": rel(got["enc_rows"], want["enc_rows"]),
            "enc_norm": abs(got["enc_norm"] - want["enc_norm"]) / want["enc_norm"],
            "logits": rel(got["at_ids"], want["top20_logits"]),
            "tokens_equal": got["tokens"] == want["tokens"]}
