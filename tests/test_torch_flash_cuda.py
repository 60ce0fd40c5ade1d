"""The encoder flash-attention CUDA kernel (speaksense_tpu_torch/ops/csrc/
flash_attn_fwd.cu) on a GPU: against its plain PyTorch version at the
encoder's shapes, on strided views, inside the encoder, and the wrapper's
refusals. Every test here needs a card and skips without one.

This file imports no jax, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py
"""

import numpy as np
import pytest
import torch

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.ops import flash as F

pytestmark = pytest.mark.cuda

# bf16 output of a softmax-weighted average of O(1) values: the kernel
# rounds the unnormalised probabilities to bf16, the plain version the
# normalised ones, and both round the output (ulp 2^-8 at 1.0)
ATOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, dev, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev, torch.bfloat16) for _ in range(3))


@pytest.mark.parametrize("shape", [(8, 20, 1500, 64), (1, 2, 200, 64), (2, 3, 77, 64),
                                   (1, 1, 1, 64), (1, 2, 1536, 64)])
def test_kernel_matches_ref(dev, shape):
    q, k, v = _qkv(shape, dev)
    before = F.flash_attention_full.launches
    out = F.flash_attention_full(q, k, v)
    torch.cuda.synchronize()
    assert F.flash_attention_full.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - F.flash_attention_ref(q, k, v).float()).abs().max().item() <= ATOL


def test_kernel_on_fused_qkv_views(dev):
    B, T, H = 2, 300, 20
    d = H * 64
    qkv = torch.randn(B, T, 3 * d, device=dev, generator=torch.Generator(dev).manual_seed(0))
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(B, T, H, 64).transpose(1, 2) for i in range(3))
    out = F.flash_attention_full(q, k, v)
    assert (out.float() - F.flash_attention_ref(q, k, v).float()).abs().max().item() <= ATOL


def test_encoder_runs_the_kernel_once_per_layer(dev):
    dims = W.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                         n_audio_head=2, n_audio_layer=3, n_text_ctx=448, n_text_state=128,
                         n_text_head=2, n_text_layer=1)
    model = W.init_random(dims, torch.Generator(dev).manual_seed(1), device=dev)
    mel = torch.randn(2, 3000, 80, device=dev, generator=torch.Generator(dev).manual_seed(2))
    before = F.flash_attention_full.launches
    enc = W.encode(model, mel)
    assert F.flash_attention_full.launches == before + dims.n_audio_layer
    W.flash_attention_full = F.flash_attention_ref
    try:
        ref = W.encode(model, mel)
    finally:
        W.flash_attention_full = F.flash_attention_full
    assert torch.isfinite(enc).all()
    # 3 bf16 layers after a layer norm: the attention's ulp-level
    # differences stay within a few percent of the output's RMS
    rel = ((enc.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 5e-2, rel


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    q, k, v = _qkv((1, 2, 64, 64), dev)
    with pytest.raises(ValueError, match="bfloat16"):
        F.flash_attention_full(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="Dh"):
        F.flash_attention_full(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 64, 128, device=dev, dtype=torch.bfloat16)[..., ::2]
        F.flash_attention_full(t, t, t)
    with pytest.raises(ValueError, match="shape"):
        F.flash_attention_full(q, k[:, :, :32], v)
