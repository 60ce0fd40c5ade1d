"""Whisper encoder/decoder in PyTorch: the counterpart of
`speaksense_tpu/models/whisper.py`.

Parameters live in `nn.Module`s with one module per layer (`ModuleList`)
instead of the JAX package's stacked `lax.scan` pytrees; the forward passes
are plain functions on tensors with the JAX names (`encode`,
`compute_cross_kv`, `decode_prefill`, `decode_step`, `_decoder_tail`).

Numerics follow the reference: matmul weights in the compute dtype, layer
norms, biases and logits in f32, attention softmax in f32 with masked logits
at -1e30. The encoder carries f32 activations, as the JAX engine does (its
mel is f32 and its products cast the weights to the activation dtype): the
mel, conv stem, residual stream, layer norms, bias adds and GELU stay f32,
and each product takes operands in the weight dtype with f32 accumulation
and an f32 result (`_mm`), which is what the TPU's default precision makes
of the JAX engine's f32 products. `encode` returns f32 states; only the
flash kernel's q/k/v are cast to the weight dtype. The decoder runs in the
compute dtype with f32 accumulation in every linear and the result cast
back to the activation dtype, as the reference's decoder does.

Layouts at the public functions are the JAX ones: activations (B, T, d),
attention operands (B, H, T, Dh), mel (B, T_mel, n_mels). Linear weights are
stored PyTorch-style (out, in); the conv stem (out, in, k). The decode cache
is the port's own: a (L, B, H, T_cap, Dh) self-KV tensor written in place at
column `gen_base + step`, and (L, B, H, A, Dh) cross-KV. The slot pool's
pages use the same layout with one row per slot; each slot writes its own
column (`decode_step_pool`), so the reference's circular pages, which exist
for XLA on the TPU, are not needed.

The int8 options are the reference's: decoder weights with a scale per
output channel (`quantize_block_weights`), cross-KV with a scale per channel
(`quantize_cross_kv`), and self-KV pages with a scale per token that a small
ring in the compute dtype feeds (`KVCache`): the ring is kept because when a
column turns int8 shows in the results, and the reference quantizes at its
ring's flush.

A model sharded by `parallel.shard_params` holds its rank's tp shard: every
attention runs on the rank's n_head / tp heads (`Whisper.n_audio_head`,
`Whisper.n_text_head`), its caches and pages hold those heads, and each
row-parallel linear sums its f32 partial products over the tp group
(`Linear.reduce`) before its bias and its one rounding. An unsharded model
has no collective.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaksense_tpu_torch.ops.flash import NEG_INF, flash_attention_full, flash_attention_ref


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
    """y = x Wᵀ + b with the weight in the compute dtype and the bias in f32;
    after `quantize_` (or `set_int8_`) an int8 weight `wq` (out, in) with an
    f32 scale `ws` (out,) per output channel takes the weight's place:
    y = (x @ wqᵀ) · ws + b (JAX `_linear`'s "wq" branch).

    reduce is None, or on a row-parallel shard the sum over the tp group of
    the f32 partial products (`parallel.shard_params`)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device, dtype):
        super().__init__()
        self.dtype = dtype
        self.reduce = None
        self.weight = _param(d_out, d_in, device=device, dtype=dtype)
        self.bias = _param(d_out, device=device, dtype=torch.float32) if bias else None
        self.register_parameter("wq", None)
        self.register_parameter("ws", None)

    @torch.no_grad()
    def quantize_(self, w: torch.Tensor | None = None) -> None:
        """Symmetric per-output-channel int8 quantization of `w` (out, in)
        (default: the layer's own weight), the recipe of the JAX
        `quantize_block_weights`: ws = max(amax_in |w|, 1e-8) / 127 in f32,
        wq = clip(round_half_even(w / ws), ±127). The compute-dtype weight is
        dropped."""
        w = (self.weight if w is None else w).float()
        ws = w.abs().amax(dim=1).clamp(min=1e-8) / 127.0
        self.set_int8_(torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8), ws)

    def set_int8_(self, wq: torch.Tensor, ws: torch.Tensor) -> None:
        dev = self.weight.device if self.weight is not None else self.wq.device
        self.wq = nn.Parameter(wq.to(device=dev, dtype=torch.int8), requires_grad=False)
        # the scales stay f32: bf16 scales would add ~0.4% relative error on
        # top of the int8 rounding
        self.ws = nn.Parameter(ws.to(device=dev, dtype=torch.float32), requires_grad=False)
        self.weight = None


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

    def __init__(self, dims: WhisperDims, device="cuda", dtype=torch.bfloat16):
        super().__init__()
        self.dims = dims
        self.dtype = dtype
        # heads of this rank: the whole model's until `parallel.shard_params`
        self.n_audio_head = dims.n_audio_head
        self.n_text_head = dims.n_text_head
        self.mesh = None
        self.encoder = AudioEncoder(dims, device, dtype)
        self.decoder = TextDecoder(dims, device, dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder.tok_emb.device


@torch.no_grad()
def init_random(dims: WhisperDims, generator: torch.Generator, device="cuda",
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
def params_from_jax(np_params: dict, dims: WhisperDims, device="cuda",
                    dtype=torch.bfloat16, weights_int8: bool = False) -> Whisper:
    """Build the port's model on `device` from a parameter pytree of numpy
    arrays in the JAX package's layout (as `W.init_params_np` and the
    checkpoint loaders of `speaksense_tpu_torch/ckpt` give it, with fused
    "qkv" or separate q/k/v blocks; separate ones are fused on the host).
    JAX linear weights are (in, out) and the conv stem (k, in, out); both
    are transposed to PyTorch's layout. Blocks already quantized by the JAX
    `quantize_block_weights` ("wq"/"ws") are carried across as they are;
    weights_int8 quantizes the decoder blocks' linears from the f32 host
    weights, as the JAX engine does before placing them."""
    model = Whisper(dims, device, dtype)

    def put(p: torch.Tensor, x) -> None:
        p.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))))

    def put_w(lin: Linear, w: np.ndarray, q8: bool) -> None:
        if q8:
            lin.quantize_(torch.from_numpy(np.ascontiguousarray(w.T, np.float32)))
        else:
            put(lin.weight, w.T)

    def put_lin(lin: Linear, src: dict, i: int, q8: bool = False) -> None:
        if "wq" in src:
            lin.set_int8_(torch.from_numpy(np.ascontiguousarray(np.asarray(src["wq"][i]).T)),
                          torch.from_numpy(np.asarray(src["ws"][i], np.float32).reshape(-1)))
        else:
            put_w(lin, np.asarray(src["w"][i], np.float32), q8)
        if lin.bias is not None:
            put(lin.bias, src["b"][i])

    def put_ln(ln: LayerNorm, src: dict, i: int | None = None) -> None:
        put(ln.weight, src["g"] if i is None else src["g"][i])
        put(ln.bias, src["b"] if i is None else src["b"][i])

    def put_qkv(lin: Linear, blocks: dict, i: int, q8: bool = False) -> None:
        if "qkv" in blocks:
            put_lin(lin, blocks["qkv"], i, q8)
            return
        w = np.concatenate([np.asarray(blocks[n]["w"][i], np.float32) for n in "qkv"], axis=-1)
        d = w.shape[0]
        b = np.concatenate([np.asarray(blocks["q"]["b"][i]), np.zeros((d,), np.float32),
                            np.asarray(blocks["v"]["b"][i])])
        put_w(lin, w, q8)
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
    q8 = weights_int8
    for i, blk in enumerate(model.decoder.blocks):
        db = dec["blocks"]
        put_ln(blk.attn_ln, db["attn_ln"], i)
        put_qkv(blk.qkv, db, i, q8)
        put_lin(blk.o, db["o"], i, q8)
        put_ln(blk.cross_ln, db["cross_ln"], i)
        for name in ("cq", "ck", "cv", "co"):
            put_lin(getattr(blk, name), db[name], i, q8)
        put_ln(blk.mlp_ln, db["mlp_ln"], i)
        put_lin(blk.fc1, db["fc1"], i, q8)
        put_lin(blk.fc2, db["fc2"], i, q8)
    return model


@torch.no_grad()
def quantize_block_weights(model: Whisper) -> Whisper:
    """int8 block weights in place (JAX `quantize_block_weights`): every
    linear of the decoder blocks becomes an int8 weight with an f32 scale
    per output channel (`Linear.quantize_`, from its current weight).
    Embeddings, layer norms and the encoder stay as they are. Blocks
    already in int8 are left."""
    for blk in model.decoder.blocks:
        for lin in blk.children():
            if isinstance(lin, Linear) and lin.wq is None:
                lin.quantize_()
    return model


def weights_are_int8(model: Whisper) -> bool:
    return model.decoder.blocks[0].qkv.wq is not None


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, ln: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics regardless of activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln.weight, ln.bias, eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """x @ Wᵀ (+ b), rounded to x's dtype once, as the JAX `_linear` does:
    the product accumulates in f32 (cuBLAS and the CPU GEMM both do for
    bf16) and, with a bias, its f32 result (`_mm`) takes the f32 bias
    before the one rounding. An int8 layer multiplies by wq in x's dtype
    (every int8 value is exact there) with an f32 result and scales it per
    output channel before the bias. A row-parallel shard sums its f32
    partial products over tp first, so the bias is added and the result
    rounded once, as without sharding."""
    if lin.wq is not None:
        y = _reduce(lin, _mm(x, lin.wq.to(x.dtype))) * lin.ws
    elif lin.bias is None and lin.reduce is None:
        return F.linear(x, lin.weight)
    else:
        y = _reduce(lin, _mm(x, lin.weight))
    if lin.bias is not None:
        y = y + lin.bias
    return y.to(x.dtype)


def _reduce(lin: Linear, y: torch.Tensor) -> torch.Tensor:
    return y if lin.reduce is None else lin.reduce(y)


class _MmF32(torch.autograd.Function):
    """a (N, in) @ wᵀ for bf16 CUDA operands with an f32 result
    (`torch.mm(..., out_dtype=float32)`), and its gradient as two more such
    products: the f32 cotangent is rounded to the operands' dtype, as the
    forward rounds its activations, and each gradient is accumulated in f32
    and returned in its operand's dtype. Written out because the forward's
    `out_dtype` product is not relied on to carry an autograd formula."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(w.dtype)
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, w, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(g.t(), a, out_dtype=torch.float32).to(w.dtype)
        return da, dw


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ with x rounded to w's dtype, f32 accumulation and an f32
    result. On the card a bf16 product goes to cuBLAS with an f32 output
    (through `_MmF32` when a gradient is being recorded); on the CPU the
    bf16-rounded operands are multiplied in f32, which is the same
    arithmetic."""
    a = x.to(w.dtype)
    if w.dtype == torch.float32:
        return F.linear(a, w)
    if a.is_cuda:
        a2 = a.reshape(-1, a.shape[-1])
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            y = _MmF32.apply(a2, w)
        else:
            y = torch.mm(a2, w.t(), out_dtype=torch.float32)
        return y.view(*a.shape[:-1], w.shape[0])
    return F.linear(a.float(), w.float())


def _linear_f32(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """(x @ Wᵀ + b) in f32 (`_mm` and an f32 bias): the encoder's linear,
    and the cross-KV projections of the f32 encoder states. An int8 layer's
    product takes wq in the compute dtype and its scale in f32."""
    if lin.wq is not None:
        y = _reduce(lin, _mm(x, lin.wq.to(lin.dtype))) * lin.ws
    else:
        y = _reduce(lin, _mm(x, lin.weight))
    return y if lin.bias is None else y + lin.bias


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
    """Fused q/k/v projection; returns (B, H, T, Dh) views of one buffer
    (H and the width d of each third are the rank's own)."""
    qkv = _linear(h, blk.qkv)
    d = qkv.shape[-1] // 3
    return tuple(_split_heads(qkv[..., i * d:(i + 1) * d], n_head) for i in range(3))


def _mlp(x: torch.Tensor, blk: EncoderBlock) -> torch.Tensor:
    h = _ln(x, blk.mlp_ln)
    return x + _linear(_gelu(_linear(h, blk.fc1)), blk.fc2)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, conv: Conv1d) -> torch.Tensor:
    """(B, T, C_in) f32 -> (B, T', C_out) f32, kernel 3, padding 1, the
    whisper stem: the taps are unfolded into one product (`_mm`) with the
    (out, in·k) weight, then the f32 bias."""
    xp = F.pad(x.to(conv.weight.dtype), (0, 0, 1, 1))       # pad time by 1
    taps = xp.unfold(1, 3, conv.stride)                     # (B, T', C_in, 3)
    y = _mm(taps.reshape(*taps.shape[:2], -1), conv.weight.reshape(conv.weight.shape[0], -1))
    return y + conv.bias


def encode(model: Whisper, mel: torch.Tensor, n_ctx_out: int | None = None,
           grad: bool = False) -> torch.Tensor:
    """mel (B, T_mel, n_mels) -> f32 encoder states (B, n_ctx_out, d).

    n_ctx_out defaults to T_mel // 2. Activations stay f32 (module
    docstring). The self-attention runs through `flash_attention_full` on
    q/k/v in the weight dtype: the CUDA kernel on the card, its plain
    version on the CPU; its output enters the f32 residual through `o`.

    Serving calls it with grad=False, under `torch.no_grad()`. With
    grad=True the same body records a graph, as `jax.grad` through the JAX
    `encode` does: gradients flow to `mel` and to whichever encoder
    parameters the caller has set `requires_grad_(True)` (all are False by
    default), and the attention's gradient is the backward kernels'."""
    if grad:
        return _encode(model, mel, n_ctx_out)
    with torch.no_grad():
        return _encode(model, mel, n_ctx_out)


def _encode(model: Whisper, mel: torch.Tensor, n_ctx_out: int | None) -> torch.Tensor:
    enc = model.encoder
    x = _gelu(_conv1d(mel.float(), enc.conv1))
    x = _gelu(_conv1d(x, enc.conv2))
    t = x.shape[1] if n_ctx_out is None else n_ctx_out
    x = x[:, :t] + enc.pos[:t].float()
    n_head = model.n_audio_head
    for blk in enc.blocks:
        qkv = _linear_f32(_ln(x, blk.attn_ln), blk.qkv).to(model.dtype)
        d = qkv.shape[-1] // 3
        q, k, v = (_split_heads(qkv[..., i * d:(i + 1) * d], n_head) for i in range(3))
        x = x + _linear_f32(_merge_heads(flash_attention_full(q, k, v)), blk.o)
        h = _ln(x, blk.mlp_ln)
        x = x + _linear_f32(_gelu(_linear_f32(h, blk.fc1)), blk.fc2)
    return _ln(x, enc.ln_post)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Decode state for one batch of windows, or a pool's pages. self_k/
    self_v (L, B, H, T_cap, Dh) are written in place; cross_k/cross_v
    (L, B, H, A, Dh) are read-only after `compute_cross_kv`.

    int8 cross-KV (`cross_ks` set): cross_k/cross_v are int8 with f32
    scales cross_ks/cross_vs (L, B, H, 1, Dh), one per channel over the
    encoder frames (JAX `quantize_cross_kv`).
    int8 self-KV (`self_ks` set): self_k/self_v are int8 with one f32 scale
    per written token, self_ks/self_vs (L, B, H, T_cap), and ring_k/ring_v
    (L, B, H, W, Dh) in the compute dtype hold the rows written since the
    last flush boundary; `flush_ring` quantizes them into the pages, so a column
    turns int8 at the boundary, not when it is written (the reference's
    ring and `flush_ring_rows`). The prompt's rows are quantized when the
    prefill writes them, as the reference's prefill does."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_ks: torch.Tensor | None = None
    cross_vs: torch.Tensor | None = None
    self_ks: torch.Tensor | None = None
    self_vs: torch.Tensor | None = None
    ring_k: torch.Tensor | None = None
    ring_v: torch.Tensor | None = None


def _quantize_kv_rows(x: torch.Tensor):
    """Symmetric per-token int8 quantization (JAX `_quantize_kv_rows`):
    x (..., Dh) -> (int8 (..., Dh), f32 scales (...)), scale =
    max(amax |x|, 1e-8) / 127 over the token's Dh channels."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale[..., 0]


def _quantize_frames(x: torch.Tensor):
    """Symmetric per-channel int8 quantization over the frame axis:
    x (..., A, Dh) -> (int8 (..., A, Dh), f32 scales (..., 1, Dh))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_cross_kv(ck: torch.Tensor, cv: torch.Tensor):
    """int8 cross-KV (JAX `quantize_cross_kv`): one scale per (layer, row,
    head, channel) over the frames. ck/cv (L, B, H, A, Dh) -> (kq, vq, ks,
    vs) with ks/vs (L, B, H, 1, Dh) f32; the scales fold exactly into the
    query (keys) and the output (values), see `_cached_attention_q8`."""
    kq, ks = _quantize_frames(ck)
    vq, vs = _quantize_frames(cv)
    return kq, vq, ks, vs


@torch.no_grad()
def compute_cross_kv(model: Whisper, enc_out: torch.Tensor, int8: bool = False,
                     out: tuple | None = None):
    """f32 encoder states -> per-layer cross-attention K/V, (L, B, H, A, Dh)
    each, computed in f32 (`_linear_f32`) and stored in the compute dtype,
    as the reference's `compute_cross_kv(..., dtype=bf16)`. int8=True
    quantizes each layer's f32 K/V per channel instead and returns (kq, vq,
    ks, vs), the JAX `compute_cross_kv(..., int8=True)` contract. Computed
    once per window batch or slot admission. With `out` (a tuple of that
    form, `zero_cross`), each layer is written into it in place and `out`
    is returned: no second copy of the whole cross-KV is made."""
    n_head = model.n_text_head
    per_layer = []
    for i, blk in enumerate(model.decoder.blocks):
        k = _split_heads(_linear_f32(enc_out, blk.ck), n_head)
        v = _split_heads(_linear_f32(enc_out, blk.cv), n_head)
        if int8:
            (kq, ks), (vq, vs) = _quantize_frames(k), _quantize_frames(v)
            layer = (kq, vq, ks, vs)
        else:
            layer = (k.to(model.dtype), v.to(model.dtype))
        if out is None:
            per_layer.append(layer)
        else:
            for dst, src in zip(out, layer, strict=True):
                dst[i].copy_(src)
    return out if out is not None else tuple(torch.stack(t) for t in zip(*per_layer))


def zero_cross(model: Whisper, n_rows: int, n_audio_ctx: int, device,
               int8: bool = False) -> tuple:
    """Zero cross-KV pages of n_rows rows, in `compute_cross_kv`'s form:
    (k, v) in the compute dtype, or int8 (kq, vq) with zero scales."""
    dims = model.dims
    shape = (dims.n_text_layer, n_rows, model.n_text_head, n_audio_ctx,
             dims.n_text_state // dims.n_text_head)
    if not int8:
        return tuple(torch.zeros(shape, dtype=model.dtype, device=device) for _ in "kv")
    scales = shape[:3] + (1, shape[4])
    return (*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in "kv"),
            *(torch.zeros(scales, dtype=torch.float32, device=device) for _ in "kv"))


def new_cache(model: Whisper, cross: tuple, t_cap: int, self_int8: bool = False,
              ring_width: int | None = None, beams: int | None = None) -> KVCache:
    """A cache over the cross-KV tuple of `compute_cross_kv` (B rows) with
    zero self-KV pages of t_cap columns: (L, B, H, t_cap, Dh), or with
    `beams` page rows per row (L, B, H, beams, t_cap, Dh) for beam search;
    int8 with zero per-token scales when self_int8; and a ring of
    ring_width rows in the compute dtype when ring_width is given."""
    dims = model.dims
    lead = (dims.n_text_layer, cross[0].shape[1], model.n_text_head) + ((beams,) if beams else ())
    shape = lead + (t_cap, dims.n_text_state // dims.n_text_head)
    dev = cross[0].device
    page_dtype = torch.int8 if self_int8 else model.dtype
    cache = KVCache(self_k=torch.zeros(shape, dtype=page_dtype, device=dev),
                    self_v=torch.zeros(shape, dtype=page_dtype, device=dev),
                    cross_k=cross[0], cross_v=cross[1])
    if len(cross) == 4:
        cache.cross_ks, cache.cross_vs = cross[2], cross[3]
    if self_int8:
        cache.self_ks = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        cache.self_vs = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    if ring_width:
        ring = lead + (ring_width, shape[-1])
        cache.ring_k = torch.zeros(ring, dtype=model.dtype, device=dev)
        cache.ring_v = torch.zeros(ring, dtype=model.dtype, device=dev)
    return cache


def init_cache(model: Whisper, enc_out: torch.Tensor, t_cap: int, cross_int8: bool = False,
               self_int8: bool = False, ring_width: int = 16) -> KVCache:
    """Decode cache of one window batch: the cross-KV of enc_out (int8 when
    cross_int8) and zero self-KV pages of t_cap columns (int8 with a
    ring_width-row ring when self_int8)."""
    return new_cache(model, compute_cross_kv(model, enc_out, int8=cross_int8), t_cap,
                     self_int8=self_int8, ring_width=ring_width if self_int8 else None)


def _decoder_tail(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Final layer norm and tied-embedding logits in f32 (..., T, n_vocab)."""
    dec = model.decoder
    x = _ln(x, dec.ln)
    return F.linear(x.float(), dec.tok_emb.float())


def _cached_attention_q8(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                         ks: torch.Tensor, vs: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over int8 KV with per-channel scales (JAX
    `_cached_attention_q8`): q (B, H, P, Dh); kq/vq int8 (B, H, A, Dh);
    ks/vs f32 (B, H, 1, Dh). The key scales fold into q (rounded to q's
    dtype), the value scales into the output; f32 logits, softmax and
    accumulation, weights in q's dtype."""
    scale = q.shape[-1] ** -0.5
    q_scaled = (q.float() * ks).to(q.dtype)
    logits = torch.matmul(q_scaled.float(), kq.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return (torch.matmul(weights.float(), vq.float()) * vs).to(q.dtype)


def _joint_attention(q: torch.Tensor, groups: list, k_new: torch.Tensor | None = None,
                     v_new: torch.Tensor | None = None) -> torch.Tensor:
    """One softmax over groups of keys and, when given, the step's own key
    (JAX `_joint_decode_attention_ring` and `_joint_decode_attention_ring_q8t`;
    with one group and no own key, `_cached_attention_q8t`). Each group is
    (k, v, ks, vs, mask): k/v (B, H, T, Dh) in the compute dtype (ks/vs
    None) or int8 with per-token f32 scales ks/vs (B, H, T), where a key
    scale multiplies its logit column and a value scale its softmax weight;
    mask broadcastable to (B, H, P, T), True = keep. q (B, H, P, Dh);
    k_new/v_new (B, H, P, Dh), query row p's own key and value. Logits,
    softmax and products in f32; a group's weights are rounded to q's dtype
    before its value product and the own weight is not, as in the
    reference."""
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    logits = []
    for k, _, ks, _, mask in groups:
        col_scale = scale if ks is None else ks[:, :, None, :] * scale
        lg = torch.matmul(qf, k.float().transpose(-1, -2)) * col_scale
        logits.append(lg.masked_fill(~mask, NEG_INF))
    if k_new is not None:
        logits.append((qf * k_new.float()).sum(-1, keepdim=True) * scale)
    w = torch.softmax(torch.cat(logits, dim=-1), dim=-1)
    out, off = None, 0
    for k, v, _, vs, _ in groups:
        wg = w[..., off:off + k.shape[-2]]
        if vs is not None:
            wg = wg * vs[:, :, None, :]
        o = torch.matmul(wg.to(q.dtype).float(), v.float())
        out = o if out is None else out + o
        off += k.shape[-2]
    if v_new is not None:
        out = out + w[..., off:] * v_new.float()
    return out.to(q.dtype)


def _cross_attention(cache: KVCache):
    """cross_attn(i, cq) of `_decoder_blocks` over the cache's cross-KV."""
    if cache.cross_ks is None:
        return lambda i, cq: flash_attention_ref(cq, cache.cross_k[i], cache.cross_v[i])
    return lambda i, cq: _cached_attention_q8(cq, cache.cross_k[i], cache.cross_v[i],
                                              cache.cross_ks[i], cache.cross_vs[i])


def _decoder_blocks(model: Whisper, x: torch.Tensor, self_attn, cross_attn) -> torch.Tensor:
    """Run the decoder blocks on x (B, P, d). self_attn(i, q, k, v) stores
    layer i's new keys and values where its cache keeps them and returns
    the self-attention output; cross_attn(i, cq) attends to the encoder."""
    n_head = model.n_text_head
    for i, blk in enumerate(model.decoder.blocks):
        h = _ln(x, blk.attn_ln)
        q, k, v = _qkv_proj(h, blk, n_head)
        x = x + _linear(_merge_heads(self_attn(i, q, k, v)), blk.o)
        h = _ln(x, blk.cross_ln)
        cq = _split_heads(_linear(h, blk.cq), n_head)
        x = x + _linear(_merge_heads(cross_attn(i, cq)), blk.co)
        x = _mlp(x, blk)
    return x


def _write_attend(cache: KVCache, dst: tuple, key_end: int, mask: torch.Tensor, rows: bool,
                  own: bool = False):
    """self_attn writing the step's K/V at `dst` of each layer's (B, H, T,
    Dh) pages (rows=True: one column per row, dst = (rows, :, cols)), then
    attending over columns [0, key_end) under `mask` (True = keep) and,
    with own, to the step's own K/V in the same softmax (a decode step; the
    mask then leaves out the column just written)."""
    def attn(i, q, k, v):
        cache.self_k[i][dst] = k[:, :, 0] if rows else k
        cache.self_v[i][dst] = v[:, :, 0] if rows else v
        keys, values = cache.self_k[i, :, :, :key_end], cache.self_v[i, :, :, :key_end]
        if not own:
            return flash_attention_ref(q, keys, values, mask)
        return _joint_attention(q, [(keys, values, None, None, mask)], k, v)
    return attn


def _ring_attend(cache: KVCache, n: int, mask_c: torch.Tensor, mask_r: torch.Tensor):
    """self_attn over int8 pages: the step's K/V (compute dtype) go to ring
    row n, then one softmax over the pages' columns under mask_c, the
    ring's rows under mask_r (rows before n) and the step's own K/V."""
    def attn(i, q, k, v):
        cache.ring_k[i, :, :, n] = k[:, :, 0]
        cache.ring_v[i, :, :, n] = v[:, :, 0]
        return _joint_attention(q, [(cache.self_k[i], cache.self_v[i], cache.self_ks[i],
                                     cache.self_vs[i], mask_c),
                                    (cache.ring_k[i], cache.ring_v[i], None, None, mask_r)],
                                k, v)
    return attn


@torch.no_grad()
def decode_prefill(model: Whisper, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Run a prompt of P tokens (B, P) from position 0, writing self-KV at
    columns [0, P) (int8 pages: quantized per token as they are written,
    and the prompt attends to its quantized keys, as the reference's
    prefill into int8 pages does). Returns f32 logits (B, P, V).
    Right-padded prompt rows write KV too; later steps mask them out (see
    `decode_step`)."""
    dec = model.decoder
    P = tokens.shape[1]
    x = dec.tok_emb[tokens] + dec.pos[:P]
    idx = torch.arange(P, device=tokens.device)
    mask = (idx[None, :] <= idx[:, None])[None, None]   # causal (1, 1, P, P)
    if cache.self_ks is None:
        self_attn = _write_attend(cache, (slice(None), slice(None), slice(0, P)), P, mask,
                                  rows=False)
    else:
        def self_attn(i, q, k, v):
            (kq, ks), (vq, vs) = _quantize_kv_rows(k), _quantize_kv_rows(v)
            cache.self_k[i, :, :, :P], cache.self_ks[i, :, :, :P] = kq, ks
            cache.self_v[i, :, :, :P], cache.self_vs[i, :, :, :P] = vq, vs
            return _joint_attention(q, [(kq, vq, ks, vs, mask)])
    x = _decoder_blocks(model, x, self_attn, _cross_attention(cache))
    return _decoder_tail(model, x)


def _scatter_cols(page: torch.Tensor, rows: torch.Tensor, col: torch.Tensor,
                  ok: torch.Tensor, sdim: int, dim: int) -> None:
    """page.scatter_(dim, col, rows) for per-slot columns: col/ok (S, W)
    give each slot's (axis sdim) ring row w its column on axis dim. A row
    with ok False rewrites column 0 with its own value instead, so it
    changes nothing (no row with ok True writes column 0)."""
    shape = [1] * page.dim()
    shape[sdim], shape[dim] = col.shape
    idx = torch.where(ok, col, 0).view(shape).expand(rows.shape)
    src = torch.where(ok.view(shape), rows, page.narrow(dim, 0, 1))
    page.scatter_(dim, idx, src)


def ring_columns(start: torch.Tensor, born: torch.Tensor, width: int, t_text: int):
    """(col, ok), each (S, W): the page column of each slot's ring row w,
    start[s] + w, and whether the row is the slot's to flush: rows below
    born[s] belong to the slot's previous occupant, and columns past the
    page to no one."""
    w = torch.arange(width, device=start.device)
    col = start[:, None] + w[None, :]
    return col, (w[None, :] >= born[:, None]) & (col < t_text)


def ring_masks(pages: KVCache, plen: torch.Tensor, ppad: torch.Tensor, fcol: torch.Tensor,
               born: torch.Tensor, ring_n: int):
    """(mask_c (S, t_text), mask_r (S, W)) of a step over int8 self pages:
    row s reads its true prompt [0, plen[s]) and its flushed tokens
    [ppad[s], fcol[s]) from the pages, and its ring rows [born[s], ring_n)
    (the tokens since the last flush; this step's own key, written to ring
    row ring_n, enters the softmax on its own)."""
    dev = plen.device
    k = torch.arange(pages.self_k.shape[-2], device=dev)[None, :]
    w = torch.arange(pages.ring_k.shape[-2], device=dev)[None, :]
    mask_c = (k < plen[:, None]) | ((k >= ppad[:, None]) & (k < fcol[:, None]))
    return mask_c, (w >= born[:, None]) & (w < ring_n)


def flush_ring(pages: KVCache, fcol: torch.Tensor, born: torch.Tensor):
    """The flush at the step that fills the ring: row s's ring rows
    [born[s], W) go to its columns fcol[s] + w - born[s] on the pages' time
    axis (second to last; the row axis is 1), quantized per token into int8
    pages with their scales, or cast into pages in the compute dtype
    (`ring_columns`). The window path flushes every row from ring row 0; a
    pool slot admitted mid-chunk starts at its own ring row. Returns the
    rows' next (fcol, born) and the flush's (col, ok), for state that moves
    with the ring (the beam pool's ancestor table)."""
    width = pages.ring_k.shape[-2]
    col, ok = ring_columns(fcol - born, born, width, pages.self_k.shape[-2])
    for page, scales, ring in ((pages.self_k, pages.self_ks, pages.ring_k),
                               (pages.self_v, pages.self_vs, pages.ring_v)):
        if scales is None:
            _scatter_cols(page, ring.to(page.dtype), col, ok, 1, page.dim() - 2)
            continue
        q, s = _quantize_kv_rows(ring)
        _scatter_cols(page, q, col, ok, 1, page.dim() - 2)
        _scatter_cols(scales, s, col, ok, 1, scales.dim() - 1)
    return fcol + (width - born), torch.zeros_like(born), col, ok


@torch.no_grad()
def decode_step(model: Whisper, token: torch.Tensor, cache: KVCache, step: int | torch.Tensor,
                prompt_len: torch.Tensor, gen_base: int,
                ring_n: int | None = None) -> torch.Tensor:
    """One autoregressive step for every row. token (B,); row b sits at
    position prompt_len[b] + step and writes its K/V at the shared column
    gen_base + step (gen_base = the padded prompt length P). Each row attends
    to its real prompt keys [0, prompt_len[b]), to the generated keys
    [gen_base, gen_base + step) and to its own key in one softmax whose own
    weight is not rounded (`_joint_attention`); the padding gap between is
    masked, as the reference's fill-layout ring decode (`W.decode_step_ring`)
    does.

    With int8 pages the step's K/V go to ring row n = step % W instead; the
    step that fills the ring flushes it into columns [gen_base + step + 1 -
    W, gen_base + step] (`flush_ring`), so the generated columns before the
    last W-aligned boundary are read in int8 and the rest in the compute
    dtype, as in the reference's `decode_loop(kv_write="ring")`. Returns f32
    logits (B, V).

    On int8 pages `step` may be a 0-d int64 tensor on the device, with
    ring_n = step % W given from the host: the step then reads no host
    value that changes from step to step, so a CUDA graph of it replays at
    any step of its ring row (`decode.WindowSteps`)."""
    dec = model.decoder
    pos = prompt_len + step
    x = (dec.tok_emb[token] + dec.pos[pos])[:, None, :]
    if cache.ring_k is None:
        col = gen_base + step
        k_idx = torch.arange(col, device=token.device)
        mask = (k_idx[None, :] < prompt_len[:, None]) | (k_idx[None, :] >= gen_base)
        self_attn = _write_attend(cache, (slice(None), slice(None), slice(col, col + 1)),
                                  col, mask[:, None, None, :], rows=False, own=True)
        x = _decoder_blocks(model, x, self_attn, _cross_attention(cache))
        return _decoder_tail(model, x)[:, 0, :]
    W = cache.ring_k.shape[3]
    n = step % W if ring_n is None else ring_n
    ppad = torch.full_like(prompt_len, gen_base)
    fcol, born = ppad + (step - n), torch.zeros_like(prompt_len)
    mask_c, mask_r = ring_masks(cache, prompt_len, ppad, fcol, born, n)
    x = _decoder_blocks(model, x, _ring_attend(cache, n, mask_c[:, None, None, :],
                                               mask_r[:, None, None, :]),
                        _cross_attention(cache))
    if n == W - 1:
        flush_ring(cache, fcol, born)
    return _decoder_tail(model, x)[:, 0, :]


# ---------------------------------------------------------------------------
# slot-pool decoding: one page row per slot, each slot at its own position
# ---------------------------------------------------------------------------

def init_pool_pages(model: Whisper, n_slots: int, t_text: int, n_audio_ctx: int,
                    device, cross_int8: bool = False, self_int8: bool = False,
                    ring_width: int = 16) -> KVCache:
    """Preallocated pool pages: self-KV (L, S, H, t_text, Dh) and cross-KV
    (L, S, H, n_audio_ctx, Dh) in the compute dtype, zero-filled (an unused
    row stays finite under the step's masks); int8 with zero scales where
    asked, int8 self pages with a ring of ring_width rows."""
    return new_cache(model, zero_cross(model, n_slots, n_audio_ctx, device, int8=cross_int8),
                     t_text, self_int8=self_int8, ring_width=ring_width if self_int8 else None)


@torch.no_grad()
def prefill_into_pool(model: Whisper, enc_out: torch.Tensor, prompts: torch.Tensor,
                      pages: KVCache, slots: torch.Tensor) -> torch.Tensor:
    """Admission of n windows: their cross-KV (int8 when the pages' is) and
    the prefill of their right-padded prompts (n, P), written in place into
    the pool rows `slots` (n,) (cross-KV whole, self-KV at columns [0, P),
    with scales for int8 pages; beam pages (L, S, H, K, T, Dh) take the
    one prefill in each of their K rows). Other rows are not touched.
    Returns the f32 prefill logits (n, P, V)."""
    P = prompts.shape[1]
    cross = compute_cross_kv(model, enc_out, int8=pages.cross_ks is not None)
    tmp = new_cache(model, cross, P, self_int8=pages.self_ks is not None)
    logits = decode_prefill(model, prompts, tmp)
    for name in ("cross_k", "cross_v", "cross_ks", "cross_vs"):
        if getattr(pages, name) is not None:
            getattr(pages, name).index_copy_(1, slots, getattr(tmp, name))
    beam = pages.self_k.dim() == 6
    cols = (slice(None), slots) + (slice(None),) * (2 if beam else 1) + (slice(0, P),)
    for name in ("self_k", "self_v", "self_ks", "self_vs"):
        if getattr(pages, name) is not None:
            rows = getattr(tmp, name)
            getattr(pages, name)[cols] = rows[:, :, :, None] if beam else rows
    return logits


def pool_mask(t_text: int, prompt_len: torch.Tensor, prompt_pad: torch.Tensor,
              col: torch.Tensor) -> torch.Tensor:
    """(S, t_text) page columns each slot attends to in a pool step: its
    true prompt [0, prompt_len), not the padding gap [prompt_len,
    prompt_pad), and its generated span [prompt_pad, col) before this
    step's own column (the step's own key enters the softmax on its own)."""
    k = torch.arange(t_text, device=col.device)[None, :]
    return ((k < prompt_len[:, None])
            | ((k >= prompt_pad[:, None]) & (k < col[:, None])))


@torch.no_grad()
def decode_step_pool(model: Whisper, token: torch.Tensor, pages: KVCache,
                     pos: torch.Tensor, col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One step for every slot row: token (S,), slot s at position pos[s]
    writes its K/V at its own column col[s] and attends under mask (S,
    t_text) (`pool_mask`) to its own row of the pages and to its own key
    (`_joint_attention`). Rows of free slots
    are computed too, under the same masks, and stay finite. Returns f32
    logits (S, V)."""
    dec = model.decoder
    x = (dec.tok_emb[token] + dec.pos[pos])[:, None, :]
    dst = (torch.arange(token.shape[0], device=token.device), slice(None), col)
    self_attn = _write_attend(pages, dst, pages.self_k.shape[3], mask[:, None, None, :],
                              rows=True, own=True)
    x = _decoder_blocks(model, x, self_attn, _cross_attention(pages))
    return _decoder_tail(model, x)[:, 0, :]


@torch.no_grad()
def decode_step_pool_ring(model: Whisper, token: torch.Tensor, pages: KVCache,
                          pos: torch.Tensor, n: int, mask_c: torch.Tensor,
                          mask_r: torch.Tensor) -> torch.Tensor:
    """One step for every slot row over int8 self pages: every slot writes
    ring row n (the pool's in-chunk step), then attends to its pages'
    columns under mask_c (S, t_text), its ring rows under mask_r (S, W)
    and its own key (`ring_masks`, `_joint_attention`); the pool flushes the ring every W steps (`flush_ring`). Returns
    f32 logits (S, V)."""
    dec = model.decoder
    x = (dec.tok_emb[token] + dec.pos[pos])[:, None, :]
    self_attn = _ring_attend(pages, n, mask_c[:, None, None, :], mask_r[:, None, None, :])
    x = _decoder_blocks(model, x, self_attn, _cross_attention(pages))
    return _decoder_tail(model, x)[:, 0, :]
