"""Parity of the PyTorch model trunk (speaksense_tpu_torch.models.whisper)
with the JAX reference on shared tiny weights, both sides in float32 on the
CPU. The JAX side runs as its own tests run it (XLA attention, flash=False)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch.models import whisper as TW

DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                      n_audio_head=2, n_audio_layer=2, n_text_ctx=448, n_text_state=128,
                      n_text_head=2, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)

# f32 on both sides: the two frameworks sum in different orders, so a
# 2-layer forward agrees to a few f32 ulps of its O(1) activations
ENC_RTOL = 1e-4
ENC_ATOL = 1e-4
LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module")
def np_params():
    return JW.init_params_np(DIMS, seed=3)


@pytest.fixture(scope="module")
def jparams(np_params):
    return {k: _tree(v) for k, v in np_params.items()}


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return jnp.asarray(x)


@pytest.fixture(scope="module")
def tmodel(np_params):
    return TW.params_from_jax(np_params, TDIMS, dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(11).standard_normal((2, 3000, 80)).astype(np.float32) * 0.5


def test_model_dims_table_matches_jax():
    assert set(TW.MODEL_DIMS) == set(JW.MODEL_DIMS)
    for name, dims in JW.MODEL_DIMS.items():
        assert TW.MODEL_DIMS[name].__dict__ == dims.__dict__, name


def test_sinusoids_match_jax():
    np.testing.assert_array_equal(TW.sinusoids(1500, 128), JW.sinusoids(1500, 128))


@pytest.mark.parametrize("n_ctx_out", [None, 250])
def test_encode_matches_jax(jparams, tmodel, mel, n_ctx_out):
    m = mel if n_ctx_out is None else mel[:, : 2 * n_ctx_out]
    want = np.asarray(JW.encode(jparams, DIMS, jnp.asarray(m), n_ctx_out=n_ctx_out, flash=False))
    got = TW.encode(tmodel, torch.from_numpy(m), n_ctx_out=n_ctx_out).numpy()
    assert got.shape == want.shape == (2, n_ctx_out or 1500, 128)
    np.testing.assert_allclose(got, want, rtol=ENC_RTOL, atol=ENC_ATOL)


def test_fused_and_unfused_qkv_give_the_same_model(np_params, tmodel, mel):
    fused = TW.params_from_jax(JW.fuse_qkv_weights(np_params), TDIMS, dtype=torch.float32)
    for a, b in zip(fused.state_dict().values(), tmodel.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    m = torch.from_numpy(mel[:1, :500])
    torch.testing.assert_close(TW.encode(fused, m), TW.encode(tmodel, m), rtol=0, atol=0)


def _jax_prefill(jparams, enc, prompt, prompt_len, t_cap):
    B = prompt.shape[0]
    cache = JW.init_cache(DIMS, B, enc.shape[1], dtype=jnp.float32, t_text=t_cap)
    ck, cv = JW.compute_cross_kv(jparams, DIMS, enc, dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    return JW.decode_prefill(jparams, DIMS, jnp.asarray(prompt), cache,
                             prompt_len=jnp.asarray(prompt_len))


def _prompts():
    # right-padded variable-length prompts, as decode_windows builds them
    prompt = np.full((2, 8), 50257, np.int64)
    prompt[0, :3] = [50258, 50259, 50360]
    prompt[1, :8] = [50362, 11, 22, 33, 44, 50258, 50259, 50360]
    return prompt, np.array([3, 8])


def test_decode_prefill_and_steps_match_jax(jparams, tmodel, mel):
    enc_j = JW.encode(jparams, DIMS, jnp.asarray(mel[:, :1000]), flash=False)
    enc_t = TW.encode(tmodel, torch.from_numpy(mel[:, :1000]))
    prompt, plen = _prompts()
    P, t_cap = prompt.shape[1], 128
    logits_j, cache_j = _jax_prefill(jparams, enc_j, prompt.astype(np.int32),
                                     plen.astype(np.int32), t_cap)
    cache_t = TW.init_cache(tmodel, enc_t, t_cap=t_cap)
    logits_t = TW.decode_prefill(tmodel, torch.from_numpy(prompt), cache_t)
    assert logits_t.dtype == torch.float32 and logits_t.shape == (2, P, DIMS.n_vocab)
    # padded prompt rows are masked from later steps only; compare real rows
    for b in range(2):
        np.testing.assert_allclose(logits_t[b, : plen[b]].numpy(),
                                   np.asarray(logits_j)[b, : plen[b]], atol=LOGIT_ATOL, rtol=0)

    # three decode steps on the same tokens through the reference's ring
    # step (fill layout, padding gap masked, per-row positions)
    cache_j = JW.arm_uniform_fill(cache_j, P)
    ring = JW.init_ring(DIMS, 2, 16, dtype=jnp.float32)
    plen_t = torch.from_numpy(plen)
    for step, tok in enumerate([[50364, 50370], [100, 200], [300, 50365]]):
        lj, cache_j, ring = JW.decode_step_ring(jparams, DIMS, jnp.asarray(tok, jnp.int32),
                                                cache_j, ring)
        lt = TW.decode_step(tmodel, torch.tensor(tok), cache_t, step, plen_t, P)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL, rtol=0)


def test_compute_cross_kv_layout(jparams, tmodel, mel):
    enc = TW.encode(tmodel, torch.from_numpy(mel[:1, :200]))
    ck, cv = TW.compute_cross_kv(tmodel, enc)
    jck, jcv = JW.compute_cross_kv(jparams, DIMS, jnp.asarray(enc.numpy()), dtype=jnp.float32)
    # JAX keeps cross-KV time-minor (L, B, H, Dh, A); the port (L, B, H, A, Dh)
    np.testing.assert_allclose(ck.numpy(), np.swapaxes(np.asarray(jck), -1, -2), atol=1e-5)
    np.testing.assert_allclose(cv.numpy(), np.swapaxes(np.asarray(jcv), -1, -2), atol=1e-5)


def test_init_random_scales_and_determinism():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    m1 = TW.init_random(TDIMS, g1, dtype=torch.float32)
    m2 = TW.init_random(TDIMS, g2, dtype=torch.float32)
    for a, b in zip(m1.state_dict().values(), m2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    blk = m1.encoder.blocks[0]
    assert abs(blk.fc1.weight.std().item() - 128 ** -0.5) < 0.01
    assert torch.all(blk.qkv.bias == 0) and torch.all(blk.attn_ln.weight == 1)
    np.testing.assert_array_equal(m1.encoder.pos.numpy(), JW.sinusoids(1500, 128))
    assert abs(m1.decoder.tok_emb.std().item() - 0.02) < 0.002
