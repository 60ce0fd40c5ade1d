"""The port's bench (`speaksense_tpu_torch/tools/bench.py`) on the CPU at
tiny dims: the headline `window_step` against a JAX composition of the same
public functions (the reference `bench.py`'s closure, at f32: tokens
equal), the sessions and serve modes' keys (the reference's names), the
gRPC and in-process stream drivers' responses on one engine, and the short
last line with its sidecar."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.models import whisper as JW
from speaksense_tpu_torch.models import decode as TD
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.tools import bench as B


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test run puts several workers on
    the cores, and torch's thread pool then spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
CPU = torch.device("cpu")
# the reference's serve keys (bench.py:436-484) and sessions keys
# (bench.py:551-562); `fast_retires` counts the reference's lagged
# retirement, a TPU layout the port's pool does not copy
SERVE_KEYS = {"metric", "value", "unit", "vs_baseline", "firehose_runs", "p50_chunk_latency_s",
              "p95_chunk_latency_s", "paced_streams", "paced_responses_per_chunk",
              "p50_chunk_latency_mid_s", "p95_chunk_latency_mid_s", "paced_mid_streams",
              "paced_mid_responses_per_chunk", "warmup_wall_s", "paced_wall_s", "knobs",
              "quality_counters", "thresh_real", "admit_avg_batch", "avg_occupancy",
              "step_calls", "admit_calls"}
SESSION_KEYS = {"metric", "value", "unit", "vs_baseline", "admit_avg_batch", "avg_occupancy",
                "step_calls", "admit_calls"}


def _jax_window_step(params, mel, prompt, decode_tokens, int8_self_kv):
    """The reference's `window_step` (bench.py:843-915, kv_write="ring")
    in f32, every step's token kept."""
    B_, P = prompt.shape
    enc = JW.encode(params, DIMS, mel)
    t_cap = min(DIMS.n_text_ctx, -(-(P + decode_tokens + 1) // 128) * 128)
    cache = JW.init_cache(DIMS, B_, enc.shape[1], dtype=jnp.float32,
                          self_kv_int8=int8_self_kv, t_text=t_cap)
    kq, vq, ks, vs = JW.compute_cross_kv(params, DIMS, enc, int8=True)
    cache = {**cache, "cross_k": kq, "cross_v": vq, "cross_k_scale": ks, "cross_v_scale": vs}
    logits, cache = JW.decode_prefill(params, DIMS, prompt, cache)
    tok0 = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    cache = JW.arm_uniform_fill(cache, P)
    width = 16
    while decode_tokens % width:
        width //= 2

    def chunk(carry, _):
        def body(c, _):
            tok, cache, ring = c
            logits, cache, ring = JW.decode_step_ring(params, DIMS, tok, cache, ring)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (tok, cache, ring), tok

        (tok, cache, ring), toks = jax.lax.scan(body, carry, None, length=width)
        cache, ring = JW.flush_ring(cache, ring)
        return (tok, cache, ring), toks

    ring = JW.init_ring(DIMS, B_, width, dtype=jnp.float32)
    _, toks = jax.lax.scan(chunk, (tok0, cache, ring), None, length=decode_tokens // width)
    return jnp.concatenate([tok0[:, None], toks.reshape(-1, B_).T], axis=1)


@pytest.mark.parametrize("int8_self_kv", [True, False], ids=["int8_self", "f32_self"])
def test_window_step_matches_jax(int8_self_kv):
    """The headline's window_step (encode, int8 cross-KV, prefill, a fixed
    40-token argmax decode; int8 self pages quantized from the ring at its
    flushes, or pages in the compute dtype) on weights carried across by
    `params_from_jax`, against the JAX composition of the same public
    functions: every token equal at f32."""
    np_params = JW.fuse_qkv_weights(JW.init_params_np(DIMS, seed=3))
    model = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)
    mel = np.random.default_rng(0).standard_normal((2, 1024, 80)).astype(np.float32)
    prompt = np.zeros((2, 3), np.int64)
    n = 40
    got = B.window_step(model, torch.from_numpy(mel), torch.from_numpy(prompt), n,
                        int8_kv=True, int8_self_kv=int8_self_kv)
    want = jax.jit(_jax_window_step, static_argnums=(3, 4))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(mel),
        jnp.asarray(prompt.astype(np.int32)), n, int8_self_kv)
    assert got.shape == (2, n + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TD.ring_width(n) == 8                    # five flushes


def test_bench_last_line_parses_and_sidecar_exists(tmp_path, capsys):
    """The window mode's last line is one short JSON object naming the
    sidecar, which holds the whole result stamped with the device."""
    out = tmp_path / "window.json"
    B.main(["--device", "cpu", "--batch", "2", "--decode-tokens", "8", "--iters", "2",
            "--no-e2e", "--out", str(out)], dims=TDIMS)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert len(last) < 1024
    assert {"metric", "value", "unit", "vs_baseline", "median_rtf", "card", "nproc",
            "sidecar"} <= set(line)
    assert line["unit"] == "x_realtime" and line["card"] == "cpu" and line["value"] > 0
    assert line["sidecar"] == str(out)
    full = json.loads(out.read_text())
    assert full["tokens_same"] and len(full["runs_s"]) == 2
    assert full["best_s"] <= full["median_s"]
    assert full["busy_share"] is None and full["profile"]["device_busy_ms"] is None
    assert "random weights" in full["note"]


def _args(*argv):
    return B.parser().parse_args(["--device", "cpu", *argv])


SERVE = ("--serve-streams", "2", "--serve-chunks", "2", "--serve-paced-chunks", "1",
         "--serve-repeats", "2", "--serve-tokens", "8", "--serve-thresh-streams", "1",
         "--serve-thresh-chunks", "1")


@pytest.mark.parametrize("driver", ["inproc", "grpc"])
def test_serve_keys(driver):
    """Both drivers: the reference's serve keys, each firehose run kept,
    one latency sample per paced response; the mid-load row and the armed
    phase's retries on one driver (each paced row waits 5 s a chunk)."""
    extra = (("--serve-paced-mid", "1") if driver == "inproc" else
             ("--serve-paced-mid", "0", "--no-serve-thresh-phase"))
    r = B.bench_serve(_args(*SERVE, *extra), TDIMS, CPU, driver=driver)
    keys = SERVE_KEYS if driver == "inproc" else SERVE_KEYS - {"thresh_real"}
    assert keys <= set(r), keys - set(r)
    assert r["driver"] == driver and B.DRIVERS[driver].name in r["metric"]
    assert len(r["firehose_runs"]) == 2 and r["value"] == r["firehose_runs"][-1]
    assert r["paced_samples"] >= 2 and 0 < r["p50_chunk_latency_s"] <= r["p95_chunk_latency_s"]
    assert r["admit_calls"] > 0 and r["step_calls"] > 0
    if driver == "inproc":
        assert r["paced_mid_streams"] == 1
        assert r["thresh_real"]["pool_fallback_retries"] > 0   # random weights trip the gate
    else:
        assert r["paced_mid_streams"] is None and "thresh_real" not in r


def test_sessions_keys():
    r = B.bench_sessions(_args("--serve-streams", "1", "--serve-chunks", "1",
                               "--serve-tokens", "4", "--iters", "1"), TDIMS, CPU)
    assert SESSION_KEYS <= set(r), SESSION_KEYS - set(r)
    assert r["value"] > 0 and r["admit_calls"] > 0 and r["avg_occupancy"] > 0


def test_drivers_give_the_same_responses():
    """The gRPC client and the in-process driver, on one engine: the same
    streams give the same responses, text for text."""
    from speaksense_tpu_torch.runtime.batcher import BatchedEngine

    engine = B._engine(TDIMS, CPU, 0, cross_kv_int8=True, **B.NEUTRAL)
    engine.enable_slot_serving(n_slots=4, t_mel=512, max_new=8, int8_kv=True)
    serving = BatchedEngine(engine)
    audio = [__import__("base64").standard_b64encode(c.tobytes()) for c in B._pcm_chunks(0)]
    texts = {}
    try:
        for name, cls in B.DRIVERS.items():
            drv = cls(serving, language="en", denoise=True)
            try:
                got: list = []
                drv.drive(1, 3, 0.0, B._Latencies(), got, audio=audio)
                texts[name] = got
            finally:
                drv.close()
    finally:
        engine.disable_slot_serving()
        serving.stop()
    assert texts["inproc"] == texts["grpc"]
    assert texts["inproc"][0][-1][0] == 1                  # the end event last
    assert any(text for end, text in texts["inproc"][0] if end == 0)
