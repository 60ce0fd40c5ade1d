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

The full-depth fixture `tests/golden/large_v3_32l_f32.json` adds the
streaming pools: `seeded_chunk` makes the 5 s s16 chunks both packages are
fed, `pool_readings` takes what either package's `StreamingDecodeServer`
returns for them, `projection` reads the whole encoder output along seeded
directions, and `errors` compares those too when both sides hold them.
"""

from __future__ import annotations

import numpy as np
import torch

from speaksense_tpu_torch.models import whisper as W

# the parity fixture's bounds, relative L2 at f32 (TF32 off on the card)
ENC_RTOL = 1e-3
LOGITS_RTOL = 1e-3
# each pool at f32 against the full-depth fixture: tokens equal per chunk,
# the no-speech probability within POOL_NO_SPEECH_ATOL and the mean
# log-probability within POOL_LOGPROB_ATOL: the slot tests' bounds at
# 2 + 2 layers, which plain pages keep at 32 + 32 (read 6.1e-7 and 1.0e-11
# on the CPU, 6.1e-7 and 5.5e-12 on an H100). With int8 pages a value that
# two summation orders put on either side of an int8 rounding step lands a
# step apart, and 32 layers of pages hold many more such values: the beam
# pool's int8 pages read 7.5e-4 (CPU) and 7.0e-4 (H100) against JAX, the
# port on those two devices up to 6.0e-4 apart from itself, and 2.3e-8 and
# 5.4e-8 for the no-speech probability, so its mean log-probability is held
# within POOL_INT8_LOGPROB_ATOL
POOL_LOGPROB_ATOL = 1e-4
POOL_INT8_LOGPROB_ATOL = 1.5e-3
POOL_NO_SPEECH_ATOL = 1e-6
# the served bf16 engine (the f16 weights rounded to bf16, the flash kernel
# in every encoder layer) against the same f32 fixture. Each bound sits
# between the clean reading on an H100 and that of a defect planted once in
# a copy: the encoder projection's relative L2 5.401e-3 clean, 1.131e-2
# with the encoder's residual rounded to bf16 after each sub-layer; the
# first-step logits' 4.006e-3 clean, 5.150e-3 with each decoder product
# rounded to bf16 before its bias (4.640e-3 with the plain attention's
# logits rounded to bf16); the greedy pool's largest |Δ avg_logprob|
# 4.282e-3 clean, 3.290e-1 with the decoder's self-attention logits rounded
# to bf16 (3.660e-1 with the plain attention's); the beam pool's 4.434e-3
# clean, 8.007e-3 with the decoder's products rounded twice (2.229e-2 with
# the encoder's residual rounded)
BF16_ENC_RTOL = 8e-3
BF16_LOGITS_RTOL = 4.5e-3
BF16_GREEDY_LOGPROB_ATOL = 2e-2
BF16_BEAM_LOGPROB_ATOL = 6e-3
# seed of the projection's directions, and their number
PROJECTION_SEED = 7
PROJECTION_K = 16
# what the chip smoke's full-depth check reads from the full-depth fixture
FULL_FIXTURE_KEYS = ("checkpoint", "mel_seed", "prompt", "n_tokens", "enc_norm", "enc_rows",
                     "enc_projection", "top20_ids", "top20_logits", "tokens", "projection",
                     "chunks", "servers", "pool_prompt", "greedy", "beam", "jax_run")


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


def seeded_chunk(seconds: float, seed: int) -> np.ndarray:
    """Seeded pseudo-speech as 16 kHz s16 PCM, the way a stream's chunk
    arrives: voiced harmonics of a gliding pitch under a syllable-rate
    envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 100 + 15 * (seed % 10) + 25 * np.sin(2 * np.pi * 0.4 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 7))
    env = 0.4 + 0.6 * np.sin(2 * np.pi * (2.5 + 0.3 * (seed % 5)) * t) ** 2
    x = 0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)
    return np.round(np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def projection(x, seed: int = PROJECTION_SEED, k: int = PROJECTION_K) -> list:
    """x (any shape) dotted in f64 with k seeded unit directions over all of
    its values: each reading weighs every value, so a fault anywhere in x
    moves it (the relative L2 of two projections estimates that of the two
    tensors)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    flat = np.asarray(x, np.float64).reshape(-1)
    out = []
    for i in range(k):
        d = np.random.default_rng([seed, i]).standard_normal(flat.size)
        out.append(float(flat @ d / np.linalg.norm(d)))
    return out


def pool_readings(server, chunks, language: str = "en") -> list:
    """What a `StreamingDecodeServer` (either package's) returns for each
    chunk, s16 PCM submitted with the device denoise, one chunk at a time:
    each admission then finds the pool empty after the same number of pool
    steps in both packages, so which self-KV columns an int8 pool holds in
    int8 at each step does not depend on thread timing."""
    out = []
    for chunk in chunks:
        r = server.submit_audio(chunk, language=language, denoise=True).result(timeout=3600)
        out.append({"tokens": [int(t) for t in np.asarray(r["tokens"]).reshape(-1)],
                    "n_sampled": int(r["n_sampled"]), "sum_logprob": float(r["sum_logprob"]),
                    "avg_logprob": float(r["avg_logprob"]),
                    "no_speech_prob": float(r["no_speech_prob"])})
    return out


def readings(model, mel, prompt, n_tokens: int, ids: list) -> dict:
    """What the parity fixture records, from the port at the model's
    dtype: the encoder states' norm and rows 0, 500, 1000 and 1499 of
    their first 8 channels, the first step's 20 largest logits (ids and
    values) after the prompt and its logits at `ids` (the fixture's top
    20), and n_tokens argmax tokens (the first step's, then each decode
    step's; no logit rules), and `projection` of the encoder states. The
    encoder's attention is `W.flash_attention_full` (the plain version on
    the CPU)."""
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
            "at_ids": first[0, ids].tolist(), "tokens": torch.stack(toks, 1)[0].tolist(),
            "enc_projection": projection(enc)}


def pool_logprob_atol(spec: dict) -> float:
    """The f32 bound on |Δ avg_logprob| for a pool of server spec `spec`."""
    return POOL_INT8_LOGPROB_ATOL if spec["int8_kv"] or spec["self_int8"] else POOL_LOGPROB_ATOL


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pool_errors(got: list, want: list) -> dict:
    """Per chunk: tokens equal (and n_sampled), the common prefix of the
    sampled tokens (EOT included) and Δ avg_logprob (got - want); over the
    chunks: the largest |Δ avg_logprob| and |Δ no_speech_prob|."""
    equal, prefix = [], []
    for g, w in zip(got, want, strict=True):
        n = min(g["n_sampled"], w["n_sampled"]) + 1
        k = next((j for j in range(min(n, len(w["tokens"])))
                  if g["tokens"][j] != w["tokens"][j]), None)
        same = g["tokens"] == w["tokens"] and g["n_sampled"] == w["n_sampled"]
        equal.append(same)
        prefix.append(min(n, len(w["tokens"])) if k is None else k)
    delta = [g["avg_logprob"] - w["avg_logprob"] for g, w in zip(got, want)]
    return {"tokens_equal": equal, "common_prefix": prefix, "avg_logprob_delta": delta,
            "avg_logprob": max(map(abs, delta)),
            "no_speech_prob": max(abs(g["no_speech_prob"] - w["no_speech_prob"])
                                  for g, w in zip(got, want))}


def errors(got: dict, want: dict) -> dict:
    """Relative L2 of the encoder rows and norm, and of the logits at the
    fixture's top-20 ids; whether the tokens are equal. Where both sides
    hold them, also the projection's relative L2 ("enc_projection") and
    `pool_errors` of each pool ("greedy", "beam")."""
    out = {"enc_rows": rel_l2(got["enc_rows"], want["enc_rows"]),
           "enc_norm": abs(got["enc_norm"] - want["enc_norm"]) / want["enc_norm"],
           "logits": rel_l2(got["at_ids"], want["top20_logits"]),
           "tokens_equal": got["tokens"] == want["tokens"]}
    if "enc_projection" in got and "enc_projection" in want:
        out["enc_projection"] = rel_l2(got["enc_projection"], want["enc_projection"])
    for pool in ("greedy", "beam"):
        if pool in got and pool in want:
            out[pool] = pool_errors(got[pool], want[pool])
    return out
