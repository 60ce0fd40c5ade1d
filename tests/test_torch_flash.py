"""The encoder flash attention of the port (speaksense_tpu_torch.ops.flash):
its plain version against the JAX reference's `_attention`, a CPU emulation
of the CUDA kernel's tiling and online softmax against the plain version,
and the wrapper's checks. The kernel itself is tested on a GPU by
tests/test_torch_flash_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch.ops import flash as F

BLOCK_M = BLOCK_N = 64      # the kernel's query and key tiles
MASK = -1e30                # the kernel's (and the reference's) masked logit


def _qkv(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for _ in range(3))


def emulate_kernel(q, k, v):
    """Step-for-step CPU model of flash_attn_fwd.cu: per 64-row query tile,
    loop over 64-key tiles with zero-filled tail rows, mask keys >= T with a
    finite -1e30, keep running max and sum in f32, cast the unnormalised
    probabilities to the input dtype before the PV product, divide at the end."""
    B, H, T, Dh = q.shape
    scale = Dh ** -0.5
    out = torch.empty_like(q)
    n_tiles = -(-T // BLOCK_N)
    for m0 in range(0, T, BLOCK_M):
        qt = torch.zeros(B, H, BLOCK_M, Dh, dtype=q.dtype)
        qt[:, :, : min(BLOCK_M, T - m0)] = q[:, :, m0:m0 + BLOCK_M]
        m_i = torch.full((B, H, BLOCK_M, 1), MASK)
        l_i = torch.zeros(B, H, BLOCK_M, 1)
        acc = torch.zeros(B, H, BLOCK_M, Dh)
        for j in range(n_tiles):
            n0 = j * BLOCK_N
            kt = torch.zeros(B, H, BLOCK_N, Dh, dtype=q.dtype)
            vt = torch.zeros(B, H, BLOCK_N, Dh, dtype=q.dtype)
            kt[:, :, : min(BLOCK_N, T - n0)] = k[:, :, n0:n0 + BLOCK_N]
            vt[:, :, : min(BLOCK_N, T - n0)] = v[:, :, n0:n0 + BLOCK_N]
            s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
            cols = n0 + torch.arange(BLOCK_N)
            s = s.masked_fill(cols >= T, MASK)
            m_new = torch.maximum(m_i, s.amax(-1, keepdim=True))
            alpha = torch.exp(m_i - m_new)
            p = torch.exp(s - m_new)
            l_i = l_i * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(q.dtype).float(), vt.float())
            m_i = m_new
        rows = min(BLOCK_M, T - m0)
        out[:, :, m0:m0 + rows] = (acc / l_i)[:, :, :rows].to(q.dtype)
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 256, 64), (1, 2, 1500, 64)])
def test_ref_matches_jax_attention(shape, masked):
    q, k, v = _qkv(shape)
    mask = None
    if masked:   # a causal mask, as the decoder's prefill passes it
        idx = np.arange(shape[2])
        mask = (idx[None, :] <= idx[:, None])[None, None]
    want = np.asarray(JW._attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), None if mask is None
                                    else jnp.asarray(mask)))
    got = F.flash_attention_ref(q, k, v, None if mask is None else torch.from_numpy(mask))
    # f32 both sides; the sums run in a different order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (2, 3, 77, 64), (1, 1, 1, 64),
                                   (1, 2, 128, 64), (1, 1, 1500, 64)])
def test_kernel_tiling_emulation_matches_ref_f32(shape):
    q, k, v = _qkv(shape, seed=1)
    # f32: the online softmax is exact algebra; only rounding order differs
    torch.testing.assert_close(emulate_kernel(q, k, v), F.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=0)


def test_kernel_tiling_emulation_matches_ref_bf16():
    q, k, v = _qkv((2, 3, 300, 64), seed=2, dtype=torch.bfloat16)
    got = emulate_kernel(q, k, v).float()
    want = F.flash_attention_ref(q, k, v).float()
    # bf16: the kernel rounds the unnormalised probabilities, the reference
    # the normalised ones, and both round the output (ulp 2^-8 at 1.0)
    assert (got - want).abs().max().item() <= 2e-2


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    q, k, v = _qkv((1, 2, 70, 64), seed=3)
    before = F.flash_attention_full.launches
    torch.testing.assert_close(F.flash_attention_full(q, k, v), F.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert F.flash_attention_full.launches == before


def test_check_operand_rejects_what_the_kernel_cannot_take():
    # the wrapper validates before it launches; a CPU tensor fails the first check
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        F._check_operand("q", q, q.shape)


def test_library_path_is_keyed_by_source_hash():
    p = F.library_path()
    assert p.parent.name == "_build" and p.name.startswith("libflash_attn_")
    assert p == F.library_path()
