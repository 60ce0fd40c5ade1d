"""The yardstick's arithmetic: published peaks of the card, the model
operations of a Whisper window, and the least time of the encoder's
attention kernel.

Operations count a multiply and an add as two and are worked out from the
configuration's shapes, not read from the program: the useful work of what
was served, whatever the program computes besides (padding rows, rows that
already ended).
"""

from __future__ import annotations

from benchmark.reference.whisper import Shape

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The peaks of the card whose name (`torch.cuda.get_device_name`)
    holds a key of PEAKS; a card not in the table raises."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peaks for {device_name!r}")


def encoder_flops(s: Shape) -> float:
    """One 30 s window through the encoder: the two convolutions and every
    block's projections, attention products and MLP at audio_ctx frames."""
    t, d = s.audio_ctx, s.d
    conv = 2 * (2 * t) * d * (s.n_mels * 3) + 2 * t * d * (d * 3)
    block = 2 * t * d * (3 * d + d + 8 * d) + 4 * t * t * d
    return conv + s.enc_layers * block


def cross_kv_flops(s: Shape) -> float:
    """The cross-attention keys and values of one window, every layer."""
    return s.dec_layers * 2 * (2 * s.audio_ctx * s.d * s.d)


def decoder_flops(s: Shape, positions: int) -> float:
    """`positions` tokens through the decoder from position 0 (the prompt
    and every fed token): the projections (q, k, v, o, cross q and out,
    MLP), self-attention over the tokens so far, cross-attention over
    audio_ctx frames, and the logits over the vocabulary."""
    d = s.d
    proj = 2 * d * (3 * d + d + d + d + 8 * d)
    self_attn = sum(4 * (p + 1) * d for p in range(positions))
    cross = 4 * s.audio_ctx * d
    return (s.dec_layers * (positions * (proj + cross) + self_attn)
            + positions * 2 * d * s.n_vocab)


def window_flops(s: Shape, prompt_len: int, emitted: int) -> float:
    """A window served end to end: encode, its cross-KV, a prompt of
    prompt_len tokens and `emitted` tokens chosen (the last is not fed)."""
    return (encoder_flops(s) + cross_kv_flops(s)
            + decoder_flops(s, prompt_len + max(emitted, 1) - 1))


def attention_bound_s(shape: tuple, peak: dict) -> tuple[float, str]:
    """The least time of non-causal attention over (B, H, T, Dh) bf16
    operands: two T x T x Dh products per head at the bf16 rate, against q,
    k, v read and the output written once at the HBM rate. Returns
    (seconds, "operations" or "bytes")."""
    B, H, T, Dh = shape
    by_ops = 2 * 2 * B * H * T * T * Dh / peak["bf16_flops"]
    by_bytes = 4 * B * H * T * Dh * 2 / peak["hbm_bytes_per_s"]
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
