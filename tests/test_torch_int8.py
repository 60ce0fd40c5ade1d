"""The port's int8 paths against the JAX package on shared tiny weights (f32
on the CPU unless a test says otherwise): int8 decoder weights
(`quantize_block_weights`, bit-equal), int8 cross-KV (`quantize_cross_kv`,
`_cached_attention_q8`), int8 self-KV (`_quantize_kv_rows`, the scale fold,
pages quantized at the ring's flush boundaries), the window decode with
each of them against `decode.transcribe_window`, the engine's rule for
skipping int8 self-KV, and the greedy slot pool with int8 cross- and
self-KV against the JAX pool, a mid-chunk admission included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import decode as JD
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.runtime.slots import SlotPool as JPool
from speaksense_tpu.runtime.slots import _StreamJob as JJob
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.models import decode as TD
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.slots import SlotPool as TPool
from speaksense_tpu_torch.runtime.slots import _StreamJob as TJob


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
WIDE_DIMS = JW.WhisperDims(n_mels=128, n_vocab=51866, n_audio_ctx=1500, n_audio_state=1280,
                           n_audio_head=20, n_audio_layer=2, n_text_ctx=448,
                           n_text_state=1280, n_text_head=20, n_text_layer=2)
TOK = Tokenizer.synthetic(DIMS.n_vocab)
JTOK = JTokenizer.synthetic(DIMS.n_vocab)
SUPPRESS = TOK.suppress_mask()
LINEARS = ("qkv", "o", "cq", "ck", "cv", "co", "fc1", "fc2")
# f32 on both sides, summed in different orders: per-token log-probs agree
# to a few f32 ulps, their mean to 1e-5 (measured below 1e-6)
AVG_LOGPROB_ATOL = 1e-5
POOL_LOGPROB_ATOL = 1e-4
NEVER = dict(compute_dtype="float32", compression_ratio_thold=1e9, logprob_thold=-1e9,
             entropy_thold=-1.0)


@pytest.fixture(scope="module")
def np_params():
    return JW.fuse_qkv_weights(JW.init_params_np(DIMS, seed=3))


def _assert_int8_equal(model, jparams):
    for i, blk in enumerate(model.decoder.blocks):
        for name in LINEARS:
            lin, src = getattr(blk, name), jparams["decoder"]["blocks"][name]
            assert lin.weight is None and lin.wq.dtype == torch.int8
            assert lin.ws.dtype == torch.float32
            np.testing.assert_array_equal(lin.wq.numpy(), np.asarray(src["wq"][i]).T)
            np.testing.assert_array_equal(lin.ws.numpy(), np.asarray(src["ws"][i]).reshape(-1))
    assert model.encoder.blocks[0].qkv.wq is None      # the encoder stays as it is


@pytest.mark.parametrize("how", ["params_from_jax", "quantize_block_weights", "carried"])
def test_quantize_block_weights_bit_equal_to_jax(np_params, how):
    """wq and ws bit-equal to JAX `quantize_block_weights` on the same f32
    weights: quantized on the way in, quantized in place on an f32 model,
    or carried across from a JAX tree that is already quantized (separate
    q/k/v blocks fused on the host first)."""
    want = JW.quantize_block_weights(np_params)
    if how == "params_from_jax":
        model = TW.params_from_jax(JW.init_params_np(DIMS, seed=3), TDIMS, device="cpu",
                                   dtype=torch.bfloat16, weights_int8=True)
    elif how == "quantize_block_weights":
        model = TW.quantize_block_weights(
            TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32))
    else:
        model = TW.params_from_jax(want, TDIMS, device="cpu", dtype=torch.bfloat16)
    assert TW.weights_are_int8(model)
    _assert_int8_equal(model, want)


def _rand_int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
def test_cached_attention_q8_matches_jax(dtype, atol):
    """Cross-attention over int8 KV with per-channel scales on the same
    int8 tensors (JAX time-minor, the port time-major). f32: summation
    order only (1e-6); bf16: both sides round q·scale, the weights and the
    output to bf16, so a bf16 ulp at the output's magnitude (2e-2)."""
    rng = np.random.default_rng(0)
    B, H, P, A, Dh = 2, 4, 3, 40, 16
    q = rng.standard_normal((B, H, P, Dh)).astype(np.float32)
    kq, vq = _rand_int8(rng, B, H, A, Dh), _rand_int8(rng, B, H, A, Dh)
    ks = (rng.random((B, H, 1, Dh)) * 0.02).astype(np.float32)
    vs = (rng.random((B, H, 1, Dh)) * 0.02).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = JW._cached_attention_q8(
        jnp.asarray(q, jdt), jnp.asarray(kq.transpose(0, 1, 3, 2)),
        jnp.asarray(vq.transpose(0, 1, 3, 2)), jnp.asarray(ks.transpose(0, 1, 3, 2)),
        jnp.asarray(vs.transpose(0, 1, 3, 2)), None)
    got = TW._cached_attention_q8(torch.from_numpy(q).to(dtype), torch.from_numpy(kq),
                                  torch.from_numpy(vq), torch.from_numpy(ks),
                                  torch.from_numpy(vs))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_kv_quantizers_bit_equal_to_jax():
    """Per-channel cross-KV quantization over the frames and per-token
    self-KV quantization give JAX's int8 values and f32 scales on the same
    input, zero rows included (their scale is 1e-8 / 127)."""
    rng = np.random.default_rng(1)
    ck, cv = (rng.standard_normal((2, 3, 4, 50, 16)).astype(np.float32) for _ in range(2))
    ck[0, 0, 0, :, 3] = 0.0
    want = JW.quantize_cross_kv(jnp.asarray(ck.swapaxes(-1, -2)), jnp.asarray(cv.swapaxes(-1, -2)))
    got = TW.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).swapaxes(-1, -2))
    rows = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    rows[1, 2, 3] = 0.0
    for w, g in zip(JW._quantize_kv_rows(jnp.asarray(rows)),
                    TW._quantize_kv_rows(torch.from_numpy(rows))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paged_attention_matches_jax_ring_q8t():
    """One softmax over int8 pages with per-token scales, the ring's rows
    and the current token's own key: the port's `_joint_attention` against
    `_joint_decode_attention_ring_q8t`, f32, to 1e-6."""
    rng = np.random.default_rng(2)
    B, H, T, Wd, Dh = 2, 4, 24, 8, 16
    q, kn, vn = (rng.standard_normal((B, H, 1, Dh)).astype(np.float32) for _ in range(3))
    kq, vq = _rand_int8(rng, B, H, T, Dh), _rand_int8(rng, B, H, T, Dh)
    ks, vs = ((rng.random((B, H, T)) * 0.02).astype(np.float32) for _ in range(2))
    rk, rv = (rng.standard_normal((B, H, Wd, Dh)).astype(np.float32) for _ in range(2))
    mask_c = np.zeros((B, 1, 1, T), bool)
    mask_c[0, ..., :7] = mask_c[1, ..., :11] = True
    n = 3                                    # ring rows [0, n) written before
    mask_r = (np.arange(Wd) < n)[None, None, None, :]
    want = JW._joint_decode_attention_ring_q8t(
        *(jnp.asarray(a) for a in (q, kq.swapaxes(-1, -2), vq.swapaxes(-1, -2), ks, vs,
                                   mask_c, rk, rv, mask_r, kn, vn)))
    q, kq, vq, ks, vs, mask_c, rk, rv, mask_r, kn, vn = (torch.from_numpy(np.asarray(a)) for a in (
        q, kq, vq, ks, vs, mask_c, rk, rv, mask_r, kn, vn))
    got = TW._joint_attention(q, [(kq, vq, ks, vs, mask_c), (rk, rv, None, None, mask_r)],
                              kn, vn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _windows(np_params, max_new, weights_int8=False, cross=False, self_=False):
    jparams = jax.tree.map(jnp.asarray, JW.quantize_block_weights(np_params)
                           if weights_int8 else np_params)
    tmodel = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32,
                                weights_int8=weights_int8)
    jcfg = JD.RuleConfig.from_tokenizer(JTOK, max_new_tokens=max_new)
    tcfg = TD.RuleConfig.from_tokenizer(TOK, max_new_tokens=max_new)
    mel = np.random.default_rng(0).standard_normal((2, 1024, 80)).astype(np.float32) * 0.3
    prompt = np.asarray([TOK.sot_sequence("en")] * 2, np.int64)
    j = jax.jit(lambda p, m, pr: JD.transcribe_window(
        p, DIMS, jcfg, jnp.asarray(SUPPRESS), m, pr, jnp.zeros((2,)), jax.random.PRNGKey(0),
        n_audio_ctx=512, cross_kv_int8=cross, self_kv_int8=self_))(
        jparams, jnp.asarray(mel), jnp.asarray(prompt.astype(np.int32)))
    t = TD.transcribe_window(tmodel, tcfg, torch.from_numpy(SUPPRESS), torch.from_numpy(mel),
                             torch.from_numpy(prompt), torch.zeros(2), n_audio_ctx=512,
                             cross_kv_int8=cross, self_kv_int8=self_)
    return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}


def _departs(j, t) -> bool:
    return (not np.array_equal(t["tokens"], j["tokens"])
            or np.abs(t["avg_logprob"] - j["avg_logprob"]).max() > AVG_LOGPROB_ATOL)


@pytest.mark.parametrize("kind", ["weights", "cross_kv", "self_kv", "all"])
def test_int8_window_decode_matches_jax(np_params, kind, monkeypatch):
    """The window decode with int8 weights, int8 cross-KV, int8 self-KV or
    all three against JAX `transcribe_window` (its default ring decode):
    tokens equal, avg_logprob within 1e-5 (measured 0 to 2e-6). The self-KV
    cases decode 144 tokens after a 4-token prompt (more than one 128-column
    page, so the engine would not skip them) across nine flush boundaries.
    That the bound checks the quantization's timing: the same decode with
    pages in the compute dtype, and one quantizing every token when it is
    written (a ring of one row), both depart from JAX by more than it
    (measured 5e-5 to 3e-3, and 2e-5 to 3e-2 or other tokens)."""
    self_ = kind in ("self_kv", "all")
    max_new = 144 if self_ else 32
    q8 = dict(weights_int8=kind in ("weights", "all"), cross=kind in ("cross_kv", "all"))
    j, t = _windows(np_params, max_new, self_=self_, **q8)
    np.testing.assert_array_equal(t["n_sampled"], j["n_sampled"])
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert t["n_sampled"].min() > 8
    np.testing.assert_allclose(t["avg_logprob"], j["avg_logprob"], atol=AVG_LOGPROB_ATOL, rtol=0)
    if self_:
        assert _departs(j, _windows(np_params, max_new, **q8)[1])
        monkeypatch.setattr(TD, "ring_width", lambda max_new: 1)
        assert _departs(j, _windows(np_params, max_new, self_=True, **q8)[1])


def test_self_kv_is_quantized_at_flush_boundaries_only(np_params):
    """The window cache's generated columns turn int8 only at a flush: after
    a step that does not fill the ring its rows sit in the ring and the
    pages' generated columns are untouched; the step that fills it writes
    all W rows, quantized per token, into the pages."""
    model = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)
    enc = torch.zeros((1, 8, 64))
    prompt = torch.as_tensor([TOK.sot_sequence("en")])
    P = prompt.shape[1]
    cache = TW.init_cache(model, enc, t_cap=P + 16, self_int8=True, ring_width=8)
    TW.decode_prefill(model, prompt, cache)
    assert cache.self_ks[:, :, :, :P].gt(0).all()           # the prompt is int8 at once
    plen = torch.tensor([P])
    tok = torch.tensor([TOK.ts_begin])
    for step in range(8):
        before = cache.self_k[:, :, :, P:].clone()
        TW.decode_step(model, tok, cache, step, plen, P)
        if step < 7:
            assert torch.equal(cache.self_k[:, :, :, P:], before)
            assert not cache.self_ks[:, :, :, P:].any()
    q, s = TW._quantize_kv_rows(cache.ring_k)
    assert torch.equal(cache.self_k[:, :, :, P:P + 8], q)
    assert torch.equal(cache.self_ks[:, :, :, P:P + 8], s)
    assert not cache.self_ks[:, :, :, P + 8:].any()


@pytest.mark.parametrize("max_new, used", [(48, False), (144, True)])
def test_engine_self_kv_int8_skip_rule(np_params, max_new, used):
    """The engine's window path uses int8 self-KV only when the prompt and
    the budget span more than 128 columns (JAX `_window_fn`'s rule): below,
    `self_kv_int8=True` decodes exactly as without it; above, it is the
    JAX engine's int8 decode."""
    base = EngineConfig(**NEVER, cross_kv_int8=True, weights_int8=True)
    on = dataclasses.replace(base, self_kv_int8=True)
    raw = JW.init_params_np(DIMS, seed=3)
    audio = (np.random.default_rng(4).standard_normal((2, 16000 * 5)) * 0.1).astype(np.float32)
    jeng = JEngine(raw, DIMS, JTOK, config=on)
    mels = np.asarray(jeng.compute_mel(audio, pad_to=1024))
    want = jeng.decode_windows(mels, "en", max_new_tokens=max_new)
    teng = TEngine.from_jax_params(raw, TDIMS, TOK, config=on, device="cpu")
    got = teng.decode_windows(mels, "en", max_new_tokens=max_new)
    teng.config = base
    plain = teng.decode_windows(mels, "en", max_new_tokens=max_new)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= AVG_LOGPROB_ATOL
        assert (g["avg_logprob"] != p["avg_logprob"]) == used


N = 512 * 160


def _audio(seed: int, scale: float) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(N) * scale).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(int8_kv=True), dict(int8_kv=True, self_int8=True)])
def test_int8_pool_matches_jax_pool(kw):
    """The greedy pool with int8 cross-KV, and with int8 self pages too,
    against the JAX pool stepped in lockstep, one step per dispatch: two
    jobs admitted together, a third admitted after 5 steps (mid-chunk: its
    first ring row is 5, so its first 11 tokens turn int8 at the first
    flush). Tokens equal, avg_logprob within 1e-4 (measured up to 1.3e-5:
    a K or V value that the two summation orders put on either side of an
    int8 rounding boundary lands one step apart), no-speech to 1e-6."""
    raw = JW.init_params_np(DIMS, seed=0)
    jeng = JEngine(raw, DIMS, JTOK, config=EngineConfig(**NEVER))
    teng = TEngine.from_jax_params(raw, TDIMS, TOK, config=EngineConfig(**NEVER), device="cpu")
    jpool, tpool = JPool(jeng, 3, 512, 40, **kw), TPool(teng, 3, 512, 40, **kw)
    assert tpool.state.pages.cross_k.dtype == torch.int8
    assert (tpool.state.pages.self_k.dtype == torch.int8) == ("self_int8" in kw)
    sot = list(TOK.sot_sequence("en"))
    inputs = [_audio(1, 0.15), _audio(2, 0.25), _audio(3, 0.4)]
    jjobs = [JJob(a, sot, is_audio=True) for a in inputs]
    tjobs = [TJob(a, sot, is_audio=True) for a in inputs]
    assert jpool.admit_many(jjobs[:2]) == tpool.admit_many(tjobs[:2]) == 2
    for step in range(60):
        if step == 5:
            assert jpool.admit_many(jjobs[2:]) == tpool.admit_many(tjobs[2:]) == 1
            assert tpool.state.born[tjobs[2].slot] == 5
        if not (jpool.jobs or tpool.jobs):
            break
        if jpool.jobs:
            jpool.step(retire=True, k=1)
        if tpool.jobs:
            tpool.step()
    for jj, tj in zip(jjobs, tjobs):
        w, g = jj.future.result(timeout=1), tj.future.result(timeout=1)
        assert g["n_sampled"] == w["n_sampled"] > 8
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= POOL_LOGPROB_ATOL
        assert abs(g["no_speech_prob"] - w["no_speech_prob"]) <= 1e-6


def test_pool_flush_follows_the_pool_steps():
    """The greedy pool's int8 pages turn a slot's tokens int8 when the
    pool's ring fills, every 16 pool steps, whenever the slot was admitted:
    a job admitted after 5 steps writes ring rows 5-15, none of its
    generated columns is int8 before the pool's 16th step, and that step
    quantizes those 11 rows into its columns after its prompt (the first
    job's 16 rows into its own)."""
    raw = JW.init_params_np(DIMS, seed=0)
    teng = TEngine.from_jax_params(raw, TDIMS, TOK, config=EngineConfig(**NEVER), device="cpu")
    pool = TPool(teng, 2, 512, 40, self_int8=True)
    pages = pool.state.pages
    sot = list(TOK.sot_sequence("en"))
    a, b = TJob(_audio(1, 0.15), sot, is_audio=True), TJob(_audio(3, 0.4), sot, is_audio=True)
    pool.admit_many([a])
    for _ in range(5):
        pool.step()
    pool.admit_many([b])
    P = int(pool.state.ppad[b.slot])
    assert int(pool.state.born[b.slot]) == 5 and int(pool.state.fcol[b.slot]) == P
    for _ in range(10):
        pool.step()
        assert not pages.self_ks[:, :, :, P:].any()
    pool.step()                                   # the pool's 16th step
    q, s = TW._quantize_kv_rows(pages.ring_k)
    for job, first, n in ((a, 0, 16), (b, 5, 11)):
        np.testing.assert_array_equal(pages.self_k[:, job.slot, :, P:P + n].numpy(),
                                      q[:, job.slot, :, first:].numpy())
        np.testing.assert_array_equal(pages.self_ks[:, job.slot, :, P:P + n].numpy(),
                                      s[:, job.slot, :, first:].numpy())
        assert not pages.self_ks[:, job.slot, :, P + n:].any()
        assert int(pool.state.fcol[job.slot]) == P + n
    assert not pool.state.born.any()


@pytest.mark.slow
def test_int8_self_kv_ring_drift_quantified():
    """The port's copy of tests/test_accuracy.py's drift test, at its
    bounds: bf16 weights of large-v3's width (2 layers), a 4-token prompt
    and 20 greedy steps across two flush boundaries (W = 8), int8 self
    pages against pages in bf16. The greedy tokens agree at every step, the
    max logit drift stays under 3x the logit std, and it decays (the last
    four steps' below the first four's)."""
    params = JW.init_params_np(WIDE_DIMS, seed=0)
    model = TW.params_from_jax(params, TW.WhisperDims(**WIDE_DIMS.__dict__), device="cpu",
                               dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((1, 512, WIDE_DIMS.n_mels)).astype(np.float32))
    enc = TW.encode(model, mel, n_ctx_out=256)
    prompt = torch.from_numpy(rng.integers(0, 50000, (1, 4)))
    plen = torch.tensor([4])

    def run(self_int8):
        cache = TW.init_cache(model, enc, t_cap=4 + 24, self_int8=self_int8, ring_width=8)
        tok = TW.decode_prefill(model, prompt, cache)[:, -1].argmax(-1)
        outs = []
        for step in range(20):
            logits = TW.decode_step(model, tok, cache, step, plen, 4)
            outs.append(logits[0].float().numpy())
            tok = logits.argmax(-1)
        return np.stack(outs)

    ref, q = run(False), run(True)
    scale = float(ref.std())
    assert float(np.abs(q - ref).max()) / scale < 3.0
    assert np.abs(q - ref)[-4:].max() < np.abs(q - ref)[:4].max()
    assert (ref.argmax(-1) == q.argmax(-1)).all()


@pytest.mark.slow
def test_int8_self_kv_fold_exactness():
    """The port's copy of tests/test_accuracy.py's fold test, at its bound:
    the scale-folded attention over int8 pages and the bf16 ring agrees
    with exact dequantize-then-attend to within 5% of the output's std."""
    rng = np.random.default_rng(0)
    B, H, Dh, T, Wd = 2, 20, 64, 128, 8

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()

    q = mk(B, H, 1, Dh)
    k_full = torch.from_numpy(rng.standard_normal((B, H, T, Dh)).astype(np.float32))
    v_full = torch.from_numpy(rng.standard_normal((B, H, T, Dh)).astype(np.float32))
    mask_c = (torch.arange(T) < 7)[None, None, None, :]
    rk, rv = mk(B, H, Wd, Dh), mk(B, H, Wd, Dh)
    mask_r = (torch.arange(Wd) < 4)[None, None, None, :]
    (kq, ks), (vq, vs) = TW._quantize_kv_rows(k_full), TW._quantize_kv_rows(v_full)
    fused = TW._joint_attention(q, [(kq, vq, ks, vs, mask_c), (rk, rv, None, None, mask_r)]).float()
    kdq = (kq.float() * ks[..., None]).bfloat16()
    vdq = (vq.float() * vs[..., None]).bfloat16()
    keys, values = torch.cat([kdq, rk], dim=2), torch.cat([vdq, rv], dim=2)
    mask = torch.cat([mask_c, mask_r], dim=-1)
    ref = TW.flash_attention_ref(q, keys, values, mask).float()
    assert ((fused - ref).abs().max() / ref.std()).item() < 0.05
