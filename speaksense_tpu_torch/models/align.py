"""Word-level timestamps by cross-attention alignment (DTW): the counterpart
of `speaksense_tpu/models/align.py`.

openai's alignment method, as the JAX package runs it: teacher-force the
sampled tokens behind the real decoding prefix, collect the decoder's
cross-attention weights, and dynamic-time-warp the token-by-frame matrix
into a monotonic path whose columns are 20 ms encoder frames. Without
model-specific alignment-head masks (they ship inside OpenAI checkpoints
only), every head of the upper half of the decoder layers is used.

`cross_attention_weights` keeps the JAX contract, (L, B, H, T, A) f32, and
runs on the model's device. `word_timestamps` does not copy it to the host
as the JAX function does (0.88 GB at large-v3 width and 224 tokens): it
selects the upper half and the window's frames on the device and
standardizes, median-filters and averages the heads there
(`_alignment_matrix_torch`, the same function as the numpy
`_alignment_matrix`), so only the (T, n_frames) matrix crosses to the host
for the numpy DTW. `_median_filter`, `dtw_path`, `_alignment_matrix` and
`_split_words` are numpy copies with the JAX names; the numpy
`_alignment_matrix` is the reference the device version is held against.
The teacher-forced forward is XLA in the reference (no Pallas kernel), so
it is plain PyTorch here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.ops.flash import flash_attention_ref

FRAMES_PER_SECOND = 50  # encoder frames: 20 ms each
MEDIAN_WIDTH = 7

# languages written without spaces: each token becomes its own "word"
_NO_SPACE_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue"}


@torch.no_grad()
def cross_attention_weights(model: W.Whisper, tokens: torch.Tensor,
                            enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward collecting the cross-attention
    softmax weights. tokens (B, T) int; enc_out (B, A, d) f32 encoder
    states. Returns (L, B, H, T, A) f32.

    The rounding is the JAX function's: causal self-attention as
    `W._attention`; the cross K/V are f32 products of the f32 encoder
    states (`_linear_f32`, int8 weights through its int8 branch) and stay
    f32; f32 logits of the compute-dtype queries and softmax; the weights
    are rounded to the compute dtype before the f32 value product. On a
    tp-sharded model each rank computes its heads and the weights of every
    head are gathered over tp, so every rank returns all H."""
    dec = model.decoder
    n_head = model.n_text_head
    T = tokens.shape[1]
    x = dec.tok_emb[tokens] + dec.pos[:T]
    idx = torch.arange(T, device=tokens.device)
    causal = (idx[None, :] <= idx[:, None])[None, None]
    weights = []

    def self_attn(i, q, k, v):
        return flash_attention_ref(q, k, v, causal)

    def cross_attn(i, cq):
        blk = dec.blocks[i]
        ck = W._split_heads(W._linear_f32(enc_out, blk.ck), n_head)
        cv = W._split_heads(W._linear_f32(enc_out, blk.cv), n_head)
        logits = torch.matmul(cq.float(), ck.transpose(-1, -2)) * cq.shape[-1] ** -0.5
        w = torch.softmax(logits, dim=-1)
        weights.append(w)
        return torch.matmul(w.to(cq.dtype).float(), cv).to(cq.dtype)

    W._decoder_blocks(model, x, self_attn, cross_attn)
    out = torch.stack(weights)
    return out if model.mesh is None else model.mesh.all_gather(out, dim=2)


def _median_filter(x: np.ndarray, width: int = MEDIAN_WIDTH) -> np.ndarray:
    """Median filter along the last axis (audio frames)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def _median_filter_torch(x: torch.Tensor, width: int = MEDIAN_WIDTH) -> torch.Tensor:
    """`_median_filter` of a 3-D tensor on its device: edge padding is
    `replicate`, and the median of an odd window is its middle element in
    both libraries (of an even one, torch takes the lower middle element
    and numpy the mean of the two; the width here is always odd)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = F.pad(x, (pad, pad), mode="replicate")
    return xp.unfold(-1, width, 1).median(dim=-1).values


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path minimizing summed cost.
    cost: (N_tokens, M_frames). Returns (token_idx, frame_idx) arrays.

    Anti-diagonal wavefront: cell (i, j) needs (i-1, j-1), (i-1, j) and
    (i, j-1), all on earlier diagonals, so each diagonal updates as one
    vector op: N+M numpy steps instead of an N*M Python loop."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), np.int8)
    for d in range(2, N + M + 1):
        i = np.arange(max(1, d - M), min(N, d - 1) + 1)
        if i.size == 0:
            continue
        j = d - i
        c0, c1, c2 = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
        best = np.minimum(np.minimum(c0, c1), c2)
        # tie-break priority diagonal > up > left (the scalar loop's order)
        t = np.where(c0 <= np.minimum(c1, c2), 0,
                     np.where(c1 <= c2, 1, 2)).astype(np.int8)
        D[i, j] = cost[i - 1, j - 1] + best
        trace[i, j] = t
    # backtrack
    i, j = N, M
    ti, fi = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(fi[::-1])


def _alignment_matrix(weights: np.ndarray, n_frames: int) -> np.ndarray:
    """(L, H, T, A) weights -> normalized (T, n_frames): the upper half of
    the layers, each frame column standardized across tokens (population
    std), median-filtered over frames, mean over the heads."""
    L = weights.shape[0]
    sel = weights[L // 2:].reshape(-1, weights.shape[2], weights.shape[3])
    sel = sel[:, :, :n_frames]
    mean = sel.mean(axis=-2, keepdims=True)
    std = sel.std(axis=-2, keepdims=True) + 1e-9
    sel = (sel - mean) / std
    sel = _median_filter(sel, MEDIAN_WIDTH)
    return sel.mean(axis=0)


def _alignment_matrix_torch(weights: torch.Tensor, n_frames: int) -> torch.Tensor:
    """`_alignment_matrix` on the weights' device: (L, H, T, A) f32 ->
    (T, n_frames) f32. `np.std` divides by the count (ddof 0), so the std
    here takes `correction=0`, not torch's Bessel-corrected default.

    The column statistics and the standardization run in float64: where a
    frame's weights barely vary across the tokens, (x - mean) / std keeps
    only the low digits of x, and an f32 evaluation (numpy's included)
    is off there by up to about 1e-5. The median and the head mean run
    in f32 on the standardized values."""
    L = weights.shape[0]
    sel = weights[L // 2:].reshape(-1, weights.shape[2], weights.shape[3])
    sel = sel[:, :, :n_frames].double()
    mean = sel.mean(dim=-2, keepdim=True)
    std = sel.std(dim=-2, keepdim=True, correction=0) + 1e-9
    sel = _median_filter_torch(((sel - mean) / std).float(), MEDIAN_WIDTH)
    return sel.mean(dim=0)


def _split_words(tokenizer: Tokenizer, text_tokens: list[int],
                 language: str | None) -> list[tuple[str, list[int]]]:
    """Group text tokens into word units: split on leading spaces, or one
    token per word for space-free scripts."""
    words: list[tuple[str, list[int]]] = []
    if language in _NO_SPACE_LANGUAGES:
        for t in text_tokens:
            piece = tokenizer.decode([t])
            if piece:
                words.append((piece, [t]))
        return words
    cur_toks: list[int] = []
    cur_text = ""
    for t in text_tokens:
        piece = tokenizer.decode([t])
        if piece.startswith(" ") and cur_toks:
            words.append((cur_text, cur_toks))
            cur_toks, cur_text = [], ""
        cur_toks.append(t)
        cur_text += piece
    if cur_toks:
        words.append((cur_text, cur_toks))
    return words


def word_timestamps(model: W.Whisper, tokenizer: Tokenizer, tokens: list[int],
                    enc_out: torch.Tensor, language: str | None = None,
                    audio_seconds: float = 30.0, time_offset: float = 0.0) -> list[dict]:
    """Align one window's sampled tokens to word-level times.

    tokens: the sampled token ids (timestamps and specials included, they
    are filtered); enc_out: (1, A, d) f32 on the model's device. Returns
    [{word, start, end}] in seconds, shifted by time_offset."""
    text_tokens = [int(t) for t in tokens if t < tokenizer.eot]
    if not text_tokens:
        return []
    # teacher-force with the real decoding prefix + eot (openai timing.py):
    # bare text tokens at position 0 are out of distribution; the prefix
    # and eot rows are sliced off before alignment
    prefix = tokenizer.sot_sequence(language, timestamps=False)
    forced = prefix + text_tokens + [tokenizer.eot]
    tok = torch.as_tensor([forced], dtype=torch.long, device=enc_out.device)
    weights = cross_attention_weights(model, tok, enc_out)[
        :, 0, :, len(prefix): len(prefix) + len(text_tokens)]     # (L, H, T, A)
    n_frames = min(enc_out.shape[1], int(audio_seconds * FRAMES_PER_SECOND))
    matrix = _alignment_matrix_torch(weights, n_frames).cpu().numpy()   # (T, n_frames)
    ti, fi = dtw_path(-matrix)

    # first frame where each token is visited -> token start; next token's
    # start is this token's end
    T = len(text_tokens)
    starts = np.zeros(T)
    ends = np.zeros(T)
    for k in range(len(ti)):
        t, f = ti[k], fi[k]
        if k == 0 or ti[k - 1] != t:
            starts[t] = f / FRAMES_PER_SECOND
        ends[t] = (f + 1) / FRAMES_PER_SECOND

    words = _split_words(tokenizer, text_tokens, language)
    out = []
    idx = 0
    for word, toks in words:
        n = len(toks)
        out.append({"word": word, "start": round(time_offset + starts[idx], 3),
                    "end": round(time_offset + ends[idx + n - 1], 3)})
        idx += n
    return out
