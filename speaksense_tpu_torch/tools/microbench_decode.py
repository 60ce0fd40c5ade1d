"""Decode-step time budget on the card: where the time of a batched decode
step goes. The counterpart of the repository's `tools/microbench_decode.py`.

Times a 50-step argmax decode at B = 32 over a self-KV cache of `--t-self`
columns (448, the whole text context; 256 is the headline bench's capped
shape) with the first 16 prefilled, and int8 cross-KV over 1500 frames,
for variants of the decoder step:
  full     the port's `W.decode_step` (its own column written in place)
  ring     `W.decode_step` over int8 self-KV pages with per-token scales
           and a 16-row ring that it flushes into them every 16 steps
           (the window bench's path)
  nowrite  the step's self-KV write skipped (attention over the same
           columns; wrong numerics, the same reads)
  noself   self-attention and its write removed
  nocross  cross-attention removed
  nomlp    MLP removed
  novocab  the full block without the final vocabulary projection
The five ablations are built here from the port's block functions
(`W._ln`, `W._qkv_proj`, `W._joint_attention`, `W._cached_attention_q8`,
`W._mlp`, `W._decoder_tail`), as the reference builds its own; nothing in
`models/` has a switch for them. Each variant: warm-up, then the best of
3 runs (host clock to the fetch of the (B,) tokens), and one more under
torch.profiler (device busy and launches per step).

    python -m speaksense_tpu_torch.tools.microbench_decode [variants...]
    python -m speaksense_tpu_torch.tools.microbench_decode full ring --device cpu

Flags: --t-self MB_T (448); --batch (32) and --steps (50), constants in the
reference; --model (large-v3). Not ported: the reference's layout
experiments (`jnone`, `jselect`, `juniform`, `jscatter`, `fused`), which
test XLA write layouts and q/k/v fusion that the port does not copy (it
writes each column in place and always fuses q/k/v). The port's own:
--seed, --device (cuda; no card raises), --out (the sidecar).
"""

from __future__ import annotations

import argparse
import time

import torch

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.tools import measure as M

VARIANTS = ("full", "ring", "nowrite", "noself", "nocross", "nomlp", "novocab")
PREFILLED = 16


def make_cache(model: W.Whisper, B: int, t_self: int, ring: bool, seed: int) -> W.KVCache:
    """Random self-KV pages of t_self columns (the first PREFILLED stand
    for a prompt): bf16, or with `ring` int8 with random per-token scales
    and a 16-row ring; random int8 cross-KV over the encoder's frames with
    random scales."""
    dims, dev = model.dims, model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    H, Dh, A = model.n_text_head, dims.n_text_state // dims.n_text_head, dims.n_audio_ctx
    L = dims.n_text_layer

    def q8(*shape):
        return torch.randint(-127, 127, shape, generator=g, device=dev, dtype=torch.int8)

    cross = (q8(L, B, H, A, Dh), q8(L, B, H, A, Dh),
             *(torch.rand((L, B, H, 1, Dh), generator=g, device=dev) for _ in "kv"))
    cache = W.new_cache(model, cross, t_self, self_int8=ring, ring_width=16 if ring else None)
    for page in (cache.self_k, cache.self_v):
        page.copy_(q8(*page.shape) if ring else
                   torch.randn(page.shape, generator=g, device=dev).to(page.dtype))
    for scales in (cache.self_ks, cache.self_vs):
        if scales is not None:
            scales.copy_(torch.rand(scales.shape, generator=g, device=dev) / 127)
    return cache


def _ablated_step(model: W.Whisper, tok: torch.Tensor, cache: W.KVCache, step: int,
                  variant: str) -> torch.Tensor:
    """One decode step of an ablation: the block of `W._decoder_blocks`
    with a part removed or its write skipped. Returns the next tokens."""
    dec, n_head = model.decoder, model.n_text_head
    col = PREFILLED + step
    x = (dec.tok_emb[tok] + dec.pos[col])[:, None, :]
    mask = torch.ones((1, 1, 1, col), dtype=torch.bool, device=tok.device)
    for i, blk in enumerate(dec.blocks):
        if variant != "noself":
            q, k, v = W._qkv_proj(W._ln(x, blk.attn_ln), blk, n_head)
            if variant != "nowrite":
                cache.self_k[i, :, :, col] = k[:, :, 0]
                cache.self_v[i, :, :, col] = v[:, :, 0]
            keys, values = cache.self_k[i, :, :, :col], cache.self_v[i, :, :, :col]
            attn = W._joint_attention(q, [(keys, values, None, None, mask)], k, v)
            x = x + W._linear(W._merge_heads(attn), blk.o)
        if variant != "nocross":
            cq = W._split_heads(W._linear(W._ln(x, blk.cross_ln), blk.cq), n_head)
            x = x + W._linear(W._merge_heads(W._cached_attention_q8(
                cq, cache.cross_k[i], cache.cross_v[i], cache.cross_ks[i],
                cache.cross_vs[i])), blk.co)
        if variant != "nomlp":
            x = W._mlp(x, blk)
    if variant == "novocab":
        return x[:, 0, :64].float().argmax(-1)
    return W._decoder_tail(model, x)[:, 0, :].argmax(-1)


@torch.no_grad()
def decode(model: W.Whisper, cache: W.KVCache, variant: str, steps: int) -> torch.Tensor:
    """`steps` argmax steps of `variant` from token 0 at position PREFILLED
    (the cache's first PREFILLED columns are the prompt). Returns the last
    tokens (B,)."""
    B = cache.self_k.shape[1]
    tok = torch.zeros(B, dtype=torch.long, device=cache.self_k.device)
    plen = torch.full((B,), PREFILLED, dtype=torch.long, device=tok.device)
    for step in range(steps):
        if variant in ("full", "ring"):
            tok = W.decode_step(model, tok, cache, step, plen, PREFILLED).argmax(-1)
        else:
            tok = _ablated_step(model, tok, cache, step, variant)
    return tok


def main(argv=None, dims: W.WhisperDims | None = None) -> dict:
    from speaksense_tpu_torch.tools.bench import random_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default all)")
    ap.add_argument("--t-self", type=int, default=448)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--model", default="large-v3", choices=tuple(W.MODEL_DIMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    variants = args.variants or list(VARIANTS)
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}: choose from {VARIANTS}")
    if PREFILLED + args.steps > args.t_self:
        raise ValueError(f"{PREFILLED} + {args.steps} steps exceed --t-self {args.t_self}")
    device = M.resolve_device(args.device)
    dims = dims or W.MODEL_DIMS[args.model]
    model = random_model(dims, device, args.seed)
    card = M.card(device)
    rows = {}
    for variant in variants:
        cache = make_cache(model, args.batch, args.t_self, variant == "ring", args.seed)

        def run():
            return decode(model, cache, variant, args.steps).cpu()

        tokens = run()                              # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        prof = M.profile(run, device)
        per = {k: None if prof[k] is None else prof[k] / args.steps
               for k in ("device_busy_ms", "launches")}
        rows[variant] = {"ms_per_step": 1e3 * min(times) / args.steps,
                         "median_ms_per_step": 1e3 * sorted(times)[1] / args.steps,
                         "device_busy_ms_per_step": per["device_busy_ms"],
                         "launches_per_step": per["launches"],
                         "top_kernels": prof["top_kernels"], "tokens": tokens.tolist()}
        r = rows[variant]
        print(f"decode {variant:8s} {r['ms_per_step']:8.3f} ms/step (median "
              f"{r['median_ms_per_step']:.3f}), device busy "
              f"{M.fmt_ms(r['device_busy_ms_per_step'])}/step, launches/step "
              f"{r['launches_per_step']} (B={args.batch}, t_self={args.t_self}, "
              f"{args.steps} steps) [{card}]", flush=True)
        del cache
    result = {"metric": f"decode step variants (B={args.batch}, t_self={args.t_self}, "
                        f"{args.steps} steps, int8 cross-KV; port, {device.type})",
              "rows": rows, **M.stamp(device), "note": M.RANDOM_WEIGHTS_NOTE}
    for v, r in rows.items():
        result[f"{v}_ms_per_step"] = r["ms_per_step"]
    return M.emit(result, ("metric",) + tuple(f"{v}_ms_per_step" for v in rows) + ("card",),
                  args.out, "microbench_decode")


if __name__ == "__main__":
    main()
