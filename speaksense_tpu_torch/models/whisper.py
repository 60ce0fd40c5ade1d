"""Whisper encoder/decoder in PyTorch: the counterpart of
`speaksense_tpu/models/whisper.py`.

Parameters live in `nn.Module`s with one module per layer (`ModuleList`)
instead of the JAX package's stacked `lax.scan` pytrees; the forward passes
are plain functions on tensors with the JAX names (`encode`,
`compute_cross_kv`, `decode_prefill`, `decode_step`, `_decoder_tail`).

Numerics follow the reference: matmul weights in the compute dtype, layer
norms, biases and logits in f32, f32 accumulation in every linear with the
result cast back to the activation dtype, attention softmax in f32 with
masked logits at -1e30.

Layouts at the public functions are the JAX ones: activations (B, T, d),
attention operands (B, H, T, Dh), mel (B, T_mel, n_mels). Linear weights are
stored PyTorch-style (out, in); the conv stem (out, in, k). The decode cache
is the port's own: a (L, B, H, T_cap, Dh) self-KV tensor written in place at
column `gen_base + step`, and (L, B, H, A, Dh) cross-KV.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaksense_tpu_torch.ops.flash import flash_attention_full, flash_attention_ref


@dataclass(frozen=True)
class WhisperDims:
    """Model hyperparameters (the ggml header fields)."""

    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _d(n_mels, n_vocab, audio_state, audio_head, audio_layer, text_layer):
    return WhisperDims(
        n_mels=n_mels, n_vocab=n_vocab, n_audio_ctx=1500,
        n_audio_state=audio_state, n_audio_head=audio_head, n_audio_layer=audio_layer,
        n_text_ctx=448, n_text_state=audio_state, n_text_head=audio_head,
        n_text_layer=text_layer,
    )


MODEL_DIMS: dict[str, WhisperDims] = {
    "tiny.en": _d(80, 51864, 384, 6, 4, 4),
    "tiny": _d(80, 51865, 384, 6, 4, 4),
    "base.en": _d(80, 51864, 512, 8, 6, 6),
    "base": _d(80, 51865, 512, 8, 6, 6),
    "small.en": _d(80, 51864, 768, 12, 12, 12),
    "small": _d(80, 51865, 768, 12, 12, 12),
    "medium.en": _d(80, 51864, 1024, 16, 24, 24),
    "medium": _d(80, 51865, 1024, 16, 24, 24),
    "large-v1": _d(80, 51865, 1280, 20, 32, 32),
    "large-v2": _d(80, 51865, 1280, 20, 32, 32),
    "large-v3": _d(128, 51866, 1280, 20, 32, 32),
    "large-v3-turbo": _d(128, 51866, 1280, 20, 32, 4),
    "distil-large-v3": _d(128, 51866, 1280, 20, 32, 2),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Sinusoidal position embedding (whisper encoder convention)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2, dtype=np.float32))
    scaled_time = np.arange(length, dtype=np.float32)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------

def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


class Linear(nn.Module):
    """y = x Wᵀ + b with the weight in the compute dtype and the bias in f32."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device, dtype):
        super().__init__()
        self.weight = _param(d_out, d_in, device=device, dtype=dtype)
        self.bias = _param(d_out, device=device, dtype=torch.float32) if bias else None


class LayerNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.weight = _param(d, device=device, dtype=torch.float32)
        self.bias = _param(d, device=device, dtype=torch.float32)


class Conv1d(nn.Module):
    """Kernel-3 conv stem layer; weight (out, in, k), bias f32."""

    def __init__(self, d_in: int, d_out: int, stride: int, device, dtype):
        super().__init__()
        self.stride = stride
        self.weight = _param(d_out, d_in, 3, device=device, dtype=dtype)
        self.bias = _param(d_out, device=device, dtype=torch.float32)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, device, dtype):
        super().__init__()
        self.attn_ln = LayerNorm(d, device)
        # fused q/k/v projection; k has no bias in whisper, so the middle
        # third of the fused bias is zero
        self.qkv = Linear(d, 3 * d, True, device, dtype)
        self.o = Linear(d, d, True, device, dtype)
        self.mlp_ln = LayerNorm(d, device)
        self.fc1 = Linear(d, 4 * d, True, device, dtype)
        self.fc2 = Linear(4 * d, d, True, device, dtype)


class DecoderBlock(EncoderBlock):
    def __init__(self, d: int, device, dtype):
        super().__init__(d, device, dtype)
        self.cross_ln = LayerNorm(d, device)
        self.cq = Linear(d, d, True, device, dtype)
        self.ck = Linear(d, d, False, device, dtype)
        self.cv = Linear(d, d, True, device, dtype)
        self.co = Linear(d, d, True, device, dtype)


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims, device, dtype):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = Conv1d(dims.n_mels, d, 1, device, dtype)
        self.conv2 = Conv1d(d, d, 2, device, dtype)
        self.pos = _param(dims.n_audio_ctx, d, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(EncoderBlock(d, device, dtype)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, device)


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims, device, dtype):
        super().__init__()
        d = dims.n_text_state
        self.tok_emb = _param(dims.n_vocab, d, device=device, dtype=dtype)
        self.pos = _param(dims.n_text_ctx, d, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(DecoderBlock(d, device, dtype)
                                    for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d, device)


class Whisper(nn.Module):
    """Parameter container; uninitialised until `init_random` or
    `params_from_jax` fills it."""

    def __init__(self, dims: WhisperDims, device="cpu", dtype=torch.bfloat16):
        super().__init__()
        self.dims = dims
        self.dtype = dtype
        self.encoder = AudioEncoder(dims, device, dtype)
        self.decoder = TextDecoder(dims, device, dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder.tok_emb.device


@torch.no_grad()
def init_random(dims: WhisperDims, generator: torch.Generator, device="cpu",
                dtype=torch.bfloat16) -> Whisper:
    """Random weights with the scales of the JAX `init_params_np`, drawn on
    `device` from `generator` (which must live on that device)."""
    model = Whisper(dims, device, dtype)

    def randn_(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
        p.copy_(x.mul_(scale))

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "encoder.pos":
            p.copy_(torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)))
        elif name == "decoder.tok_emb" or name == "decoder.pos":
            randn_(p, 0.02)
        elif name.startswith("encoder.conv") and leaf == "weight":
            randn_(p, 0.05)
        elif leaf == "weight" and p.dim() == 2:
            randn_(p, 1.0 / math.sqrt(p.shape[1]))
        elif leaf == "weight":          # layer-norm gains
            p.fill_(1.0)
        else:                           # biases
            p.zero_()
    return model


@torch.no_grad()
def params_from_jax(np_params: dict, dims: WhisperDims, device="cpu",
                    dtype=torch.bfloat16) -> Whisper:
    """Build the port's model from the JAX parameter pytree of numpy arrays
    (as `W.init_params_np` returns it, with fused "qkv" or separate q/k/v
    blocks). JAX linear weights are (in, out) and the conv stem (k, in, out);
    both are transposed to PyTorch's layout."""
    model = Whisper(dims, device, dtype)

    def put(p: torch.Tensor, x) -> None:
        p.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))))

    def put_lin(lin: Linear, src: dict, i: int) -> None:
        put(lin.weight, np.asarray(src["w"][i]).T)
        if lin.bias is not None:
            put(lin.bias, src["b"][i])

    def put_ln(ln: LayerNorm, src: dict, i: int | None = None) -> None:
        put(ln.weight, src["g"] if i is None else src["g"][i])
        put(ln.bias, src["b"] if i is None else src["b"][i])

    def put_qkv(lin: Linear, blocks: dict, i: int) -> None:
        if "qkv" in blocks:
            put_lin(lin, blocks["qkv"], i)
            return
        w = np.concatenate([np.asarray(blocks[n]["w"][i]) for n in "qkv"], axis=-1)
        d = w.shape[0]
        b = np.concatenate([np.asarray(blocks["q"]["b"][i]), np.zeros((d,), np.float32),
                            np.asarray(blocks["v"]["b"][i])])
        put(lin.weight, w.T)
        put(lin.bias, b)

    enc, dec = np_params["encoder"], np_params["decoder"]
    for conv, src in ((model.encoder.conv1, enc["conv1"]), (model.encoder.conv2, enc["conv2"])):
        put(conv.weight, np.asarray(src["w"]).transpose(2, 1, 0))
        put(conv.bias, src["b"])
    put(model.encoder.pos, enc["pos"])
    put_ln(model.encoder.ln_post, enc["ln_post"])
    for i, blk in enumerate(model.encoder.blocks):
        eb = enc["blocks"]
        put_ln(blk.attn_ln, eb["attn_ln"], i)
        put_qkv(blk.qkv, eb, i)
        put_lin(blk.o, eb["o"], i)
        put_ln(blk.mlp_ln, eb["mlp_ln"], i)
        put_lin(blk.fc1, eb["fc1"], i)
        put_lin(blk.fc2, eb["fc2"], i)
    put(model.decoder.tok_emb, dec["tok_emb"])
    put(model.decoder.pos, dec["pos"])
    put_ln(model.decoder.ln, dec["ln"])
    for i, blk in enumerate(model.decoder.blocks):
        db = dec["blocks"]
        put_ln(blk.attn_ln, db["attn_ln"], i)
        put_qkv(blk.qkv, db, i)
        put_lin(blk.o, db["o"], i)
        put_ln(blk.cross_ln, db["cross_ln"], i)
        for name in ("cq", "ck", "cv", "co"):
            put_lin(getattr(blk, name), db[name], i)
        put_ln(blk.mlp_ln, db["mlp_ln"], i)
        put_lin(blk.fc1, db["fc1"], i)
        put_lin(blk.fc2, db["fc2"], i)
    return model


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, ln: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics regardless of activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln.weight, ln.bias, eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """x @ Wᵀ (+ b): the product accumulates in f32 (cuBLAS and the CPU
    GEMM both do for bf16); the bias is added in f32 before the cast back."""
    y = F.linear(x, lin.weight)
    if lin.bias is not None:
        y = (y.float() + lin.bias).to(x.dtype)
    return y


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    # (B, T, d) -> (B, H, T, Dh), a view
    B, T, d = x.shape
    return x.view(B, T, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # (B, H, T, Dh) -> (B, T, d)
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _qkv_proj(h: torch.Tensor, blk: EncoderBlock, n_head: int):
    """Fused q/k/v projection; returns (B, H, T, Dh) views of one buffer."""
    d = h.shape[-1]
    qkv = _linear(h, blk.qkv)
    return tuple(_split_heads(qkv[..., i * d:(i + 1) * d], n_head) for i in range(3))


def _mlp(x: torch.Tensor, blk: EncoderBlock) -> torch.Tensor:
    h = _ln(x, blk.mlp_ln)
    return x + _linear(_gelu(_linear(h, blk.fc1)), blk.fc2)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, conv: Conv1d) -> torch.Tensor:
    """(B, T, C_in) -> (B, T', C_out), padding 1, the whisper stem."""
    y = F.conv1d(x.transpose(1, 2), conv.weight, None, stride=conv.stride, padding=1)
    return (y.transpose(1, 2).float() + conv.bias).to(x.dtype)


@torch.no_grad()
def encode(model: Whisper, mel: torch.Tensor, n_ctx_out: int | None = None) -> torch.Tensor:
    """mel (B, T_mel, n_mels) -> encoder states (B, n_ctx_out, d).

    n_ctx_out defaults to T_mel // 2. The self-attention runs through
    `flash_attention_full`: the CUDA kernel on the card, its plain version
    on the CPU."""
    enc = model.encoder
    x = mel.to(model.dtype)
    x = _gelu(_conv1d(x, enc.conv1))
    x = _gelu(_conv1d(x, enc.conv2))
    t = x.shape[1] if n_ctx_out is None else n_ctx_out
    x = x[:, :t] + enc.pos[:t]
    n_head = model.dims.n_audio_head
    for blk in enc.blocks:
        h = _ln(x, blk.attn_ln)
        q, k, v = _qkv_proj(h, blk, n_head)
        x = x + _linear(_merge_heads(flash_attention_full(q, k, v)), blk.o)
        x = _mlp(x, blk)
    return _ln(x, enc.ln_post)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Decode state for one batch of windows. self_k/self_v (L, B, H, T_cap,
    Dh) are written in place; cross_k/cross_v (L, B, H, A, Dh) are read-only
    after `compute_cross_kv`."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


@torch.no_grad()
def compute_cross_kv(model: Whisper, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder states -> per-layer cross-attention K/V, (L, B, H, A, Dh) each
    in the compute dtype. Computed once per window batch."""
    n_head = model.dims.n_text_head
    ks, vs = [], []
    for blk in model.decoder.blocks:
        ks.append(_split_heads(_linear(enc_out, blk.ck), n_head))
        vs.append(_split_heads(_linear(enc_out, blk.cv), n_head))
    return torch.stack(ks), torch.stack(vs)


def init_cache(model: Whisper, enc_out: torch.Tensor, t_cap: int) -> KVCache:
    dims = model.dims
    B = enc_out.shape[0]
    H = dims.n_text_head
    shape = (dims.n_text_layer, B, H, t_cap, dims.n_text_state // H)
    ck, cv = compute_cross_kv(model, enc_out)
    return KVCache(self_k=torch.zeros(shape, dtype=model.dtype, device=enc_out.device),
                   self_v=torch.zeros(shape, dtype=model.dtype, device=enc_out.device),
                   cross_k=ck, cross_v=cv)


def _decoder_tail(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Final layer norm and tied-embedding logits in f32 (..., T, n_vocab)."""
    dec = model.decoder
    x = _ln(x, dec.ln)
    return F.linear(x.float(), dec.tok_emb.float())


def _decoder_blocks(model: Whisper, x: torch.Tensor, cache: KVCache, col0: int,
                    key_end: int, mask: torch.Tensor) -> torch.Tensor:
    """Run the decoder blocks on x (B, P, d): write this call's self K/V at
    columns [col0, col0 + P) and attend over columns [0, key_end) under
    `mask` (broadcastable to (B, 1, P, key_end), True = keep)."""
    n_head = model.dims.n_text_head
    P = x.shape[1]
    for i, blk in enumerate(model.decoder.blocks):
        h = _ln(x, blk.attn_ln)
        q, k, v = _qkv_proj(h, blk, n_head)
        cache.self_k[i, :, :, col0:col0 + P] = k
        cache.self_v[i, :, :, col0:col0 + P] = v
        attn = flash_attention_ref(q, cache.self_k[i, :, :, :key_end],
                                   cache.self_v[i, :, :, :key_end], mask)
        x = x + _linear(_merge_heads(attn), blk.o)
        h = _ln(x, blk.cross_ln)
        cq = _split_heads(_linear(h, blk.cq), n_head)
        x = x + _linear(_merge_heads(flash_attention_ref(cq, cache.cross_k[i], cache.cross_v[i])),
                        blk.co)
        x = _mlp(x, blk)
    return x


@torch.no_grad()
def decode_prefill(model: Whisper, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Run a prompt of P tokens (B, P) from position 0, writing self-KV at
    columns [0, P). Returns f32 logits (B, P, V). Right-padded prompt rows
    write KV too; later steps mask them out (see `decode_step`)."""
    dec = model.decoder
    P = tokens.shape[1]
    x = dec.tok_emb[tokens] + dec.pos[:P]
    idx = torch.arange(P, device=tokens.device)
    mask = (idx[None, :] <= idx[:, None])[None, None]   # causal (1, 1, P, P)
    x = _decoder_blocks(model, x, cache, 0, P, mask)
    return _decoder_tail(model, x)


@torch.no_grad()
def decode_step(model: Whisper, token: torch.Tensor, cache: KVCache, step: int,
                prompt_len: torch.Tensor, gen_base: int) -> torch.Tensor:
    """One autoregressive step for every row. token (B,); row b sits at
    position prompt_len[b] + step and writes its K/V at the shared column
    gen_base + step (gen_base = the padded prompt length P). Each row attends
    to its real prompt keys [0, prompt_len[b]) and to the generated keys
    [gen_base, gen_base + step]; the padding gap between is masked, as the
    reference's fill-layout ring decode (`W.decode_step_ring`) does.
    Returns f32 logits (B, V)."""
    dec = model.decoder
    pos = prompt_len + step
    x = (dec.tok_emb[token] + dec.pos[pos])[:, None, :]
    col = gen_base + step
    k_idx = torch.arange(col + 1, device=token.device)
    mask = (k_idx[None, :] < prompt_len[:, None]) | (k_idx[None, :] >= gen_base)
    x = _decoder_blocks(model, x, cache, col, col + 1, mask[:, None, None, :])
    return _decoder_tail(model, x)[:, 0, :]
