"""Large-v3 parity fixtures: the JAX package at f32 on the CPU, on the
seeded large-v3 f16 ggml files that the chip smoke's ckpt phase writes
(`tools.golden.write_seeded`, seed 0), loaded through the JAX package's
ggml loader. The smoke's ckpt phase holds the port on the card against
both (f32 with TF32 off, and the bf16 engine it serves); these tests
regenerate them with JAX, hold the committed files to what JAX gives again,
and hold the port on the CPU at f32 to the card's f32 bounds. Both are
`slow`: they are made once and committed.

- `tests/golden/large_v3_f32.json`: the CLI's file, cut to 4 encoder and 4
  decoder layers, and a seeded 30 s mel: the encoder states' norm and four
  rows, the first step's top-20 logits and 24 argmax tokens (about 15 s
  and 3.2 GiB of peak RSS).
- `tests/golden/large_v3_32l_f32.json`: the full 32 + 32 file, through the
  JAX engine (`WhisperEngine.from_ggml`, compute dtype f32): the same
  window readings plus the encoder's `projection`, and what the JAX
  `StreamingDecodeServer` returns for three seeded 5 s s16 chunks with the
  denoise, from a greedy pool with plain pages and from the beam = 5 pool
  with int8 cross-KV and self-KV pages (BASELINE config 4's). It records
  the JAX run's seconds and peak RSS (about 20 GiB: `-m slow` on a host
  with the room); the file itself is 3.1 GB in a temporary directory. If
  the fixture is missing, the test writes it."""

import dataclasses
import gc
import json
import os
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.ckpt import ggml as JG
from speaksense_tpu.config import EngineConfig as JConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.runtime.slots import StreamingDecodeServer as JServer
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.slots import StreamingDecodeServer
from speaksense_tpu_torch.tools import golden as G

FIXTURE = Path(__file__).parent / "golden" / "large_v3_f32.json"
FULL_FIXTURE = Path(__file__).parent / "golden" / "large_v3_32l_f32.json"
SEED, MEL_SEED, N_TOKENS, LAYERS = 0, 11, 24, 4


def write_checkpoint(path) -> TW.WhisperDims:
    """The ckpt phase's LAYERS-layer large-v3-width file."""
    dims = dataclasses.replace(TW.MODEL_DIMS["large-v3"], n_audio_layer=LAYERS,
                               n_text_layer=LAYERS)
    G.write_seeded(path, dims, SEED, TG.F16)
    return dims


def jax_readings(params, dims) -> dict:
    """The fixture's readings from the JAX package's f32 parameters (its
    plain encoder attention on the CPU), the same argmax decode as
    `tools.golden.readings`, and the encoder states' `projection`."""
    mel = jnp.asarray(G.seeded_mel(dims.n_mels, MEL_SEED))
    prompt = jnp.asarray([Tokenizer.synthetic(dims.n_vocab).sot_sequence("en")], jnp.int32)
    enc = jax.jit(lambda p, x: JW.encode(p, dims, x))(params, mel)
    P = prompt.shape[1]
    cache = JW.init_cache(dims, 1, enc.shape[1], dtype=jnp.float32, t_text=P + N_TOKENS)
    ck, cv = JW.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    logits, cache = JW.decode_prefill(params, dims, prompt, cache)
    first = logits[0, -1]
    step = jax.jit(lambda p, t, c: JW.decode_step(p, dims, t, c))
    toks = [jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)]
    for _ in range(N_TOKENS - 1):
        out, cache = step(params, toks[-1], cache)
        toks.append(jnp.argmax(out, axis=-1).astype(jnp.int32))
    order = np.argsort(-np.asarray(first), kind="stable")[:20]
    enc = np.asarray(enc)
    return {"enc_norm": float(np.linalg.norm(enc)),
            "enc_rows": enc[0, [0, 500, 1000, 1499], :8].tolist(),
            "top20_ids": order.tolist(), "top20_logits": np.asarray(first)[order].tolist(),
            "tokens": [int(t[0]) for t in toks], "enc_projection": G.projection(enc)}


def header(dims) -> dict:
    return {"source": "JAX package, f32, CPU; tests/test_torch_golden.py",
            "checkpoint": {"dims": dataclasses.asdict(dims), "seed": SEED, "ftype": "f16",
                           "tensors": "speaksense_tpu_torch.tools.golden.seeded_ggml_tensors"},
            "mel_seed": MEL_SEED, "prompt": Tokenizer.synthetic(dims.n_vocab).sot_sequence("en"),
            "n_tokens": N_TOKENS}


def fixture(path) -> dict:
    dims = write_checkpoint(path)
    m = JG.load_ggml(str(path))
    params, jdims = jax.tree.map(jnp.asarray, JG.params_from_ggml(m)), m.dims
    del m
    return {**header(dims), **jax_readings(params, jdims)}


@pytest.mark.slow
def test_large_v3_golden_fixture(tmp_path):
    """JAX gives the committed fixture again (tokens and ids equal, values
    to 1e-5), and the port on the CPU at f32 holds the bounds the card is
    held to (encoder 1e-3 and logits 1e-3 relative L2, tokens equal)."""
    want = json.loads(FIXTURE.read_text())
    got = fixture(tmp_path / "large_v3_4l.bin")
    assert got["tokens"] == want["tokens"] and got["top20_ids"] == want["top20_ids"]
    for key in ("enc_rows", "top20_logits"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)
    assert got["enc_norm"] == pytest.approx(want["enc_norm"], rel=1e-5)
    model = TW.params_from_jax(JG.params_from_ggml(JG.load_ggml(str(tmp_path / "large_v3_4l.bin"))),
                               TW.WhisperDims(**want["checkpoint"]["dims"]), device="cpu",
                               dtype=torch.float32)
    port = G.readings(model, torch.from_numpy(G.seeded_mel(128, want["mel_seed"])),
                      torch.tensor([want["prompt"]]), want["n_tokens"], want["top20_ids"])
    errs = G.errors(port, want)
    assert errs["enc_rows"] <= G.ENC_RTOL and errs["enc_norm"] <= G.ENC_RTOL
    assert errs["logits"] <= G.LOGITS_RTOL and errs["tokens_equal"], errs


# the full-depth fixture's streaming part: three seeded 5 s s16 chunks with
# the denoise, through a 2-slot pool at its default 512-frame bucket (the
# encoder at t = 256), 24 new tokens; greedy with plain pages, and beam = 5
# with BASELINE config 4's int8 cross-KV and self-KV pages
CHUNKS = {"seconds": 5.0, "seeds": [31, 32, 33], "format": "s16", "denoise": True}
SERVERS = {"greedy": dict(n_slots=2, t_mel=512, max_new=24, int8_kv=False, self_int8=False,
                          beam_size=1),
           "beam": dict(n_slots=2, t_mel=512, max_new=24, int8_kv=True, self_int8=True,
                        beam_size=5)}


class PeakRss:
    """This process's resident set sampled every 10 ms (`/proc/self/statm`)
    while the block runs: `gib` is its peak."""

    def __enter__(self):
        self.peak, self._done = self._rss(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def gib(self) -> float:
        return self.peak / 2**30

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        while not self._done.wait(0.01):
            self.peak = max(self.peak, self._rss())


def _depth(fixture: dict) -> str:
    dims = fixture["checkpoint"]["dims"]
    return f"{dims['n_audio_layer']} + {dims['n_text_layer']} layers"


def chunks() -> list:
    return [G.seeded_chunk(CHUNKS["seconds"], s) for s in CHUNKS["seeds"]]


def full_fixture(path) -> dict:
    """The full-depth fixture from the JAX engine at f32 on `path` (the
    ckpt phase's 32 + 32 file): the window readings, then each pool's
    readings from a JAX server stepping one step per dispatch, as the port's
    pool steps (so an int8 pool flushes its ring at the same steps)."""
    with PeakRss() as rss:
        t0 = time.perf_counter()
        eng = JEngine.from_ggml(str(path), config=JConfig(compute_dtype="float32"),
                                use_cache=False)
        out = {**header(eng.dims), **jax_readings(eng.params, eng.dims),
               "projection": {"seed": G.PROJECTION_SEED, "k": G.PROJECTION_K},
               "chunks": CHUNKS, "servers": SERVERS}
        for name, spec in SERVERS.items():
            server = JServer(eng, steps_per_dispatch=1, **spec)
            try:
                out["pool_prompt"] = server._build_prompt("en", "transcribe", None)[0]
                out[name] = G.pool_readings(server, chunks())
            finally:
                server.stop()
        seconds = time.perf_counter() - t0
        del eng, server
        gc.collect()
        jax.clear_caches()
    out["jax_run"] = {"seconds": seconds, "peak_rss_gib": rss.gib}
    print(f"JAX at f32 on the CPU, {_depth(out)} (load, window, both pools): {seconds:.1f} s, "
          f"peak RSS {rss.gib:.2f} GiB")
    return out


def port_full_readings(path, want) -> dict:
    """The same readings from the port on the CPU at f32."""
    with PeakRss() as rss:
        t0 = time.perf_counter()
        eng = TEngine.from_ggml(str(path), config=EngineConfig(compute_dtype="float32"),
                                use_cache=False, device="cpu")
        got = G.readings(eng.model, torch.from_numpy(G.seeded_mel(128, want["mel_seed"])),
                         torch.tensor([want["prompt"]]), want["n_tokens"], want["top20_ids"])
        for name, spec in want["servers"].items():
            server = StreamingDecodeServer(eng, **spec)
            try:
                assert server._build_prompt("en", "transcribe", None)[0] == want["pool_prompt"]
                got[name] = G.pool_readings(server, chunks())
            finally:
                server.stop()
        seconds = time.perf_counter() - t0
        del eng, server
        gc.collect()
    print(f"the port at f32 on the CPU, {_depth(want)} (load, window, both pools): "
          f"{seconds:.1f} s, peak RSS {rss.gib:.2f} GiB")
    return got


@pytest.mark.slow
def test_large_v3_full_depth_fixture(tmp_path):
    """The full-depth fixture: JAX gives the committed file again (tokens
    equal, values to 1e-5; written if missing), and the port on the CPU at
    f32 holds the bounds the card is held to at f32: encoder rows, norm and
    projection 1e-3 and first-step logits 1e-3 relative L2 with the 24
    tokens equal; each pool's tokens equal per chunk, its mean
    log-probability and no-speech probability within POOL_LOGPROB_ATOL and
    POOL_NO_SPEECH_ATOL (POOL_INT8_LOGPROB_ATOL for the int8 pages)."""
    path = tmp_path / "ggml-large-v3.bin"
    G.write_seeded(path, TW.MODEL_DIMS["large-v3"], SEED, TG.F16)
    got = full_fixture(path)
    assert _depth(got) == "32 + 32 layers"
    if not FULL_FIXTURE.exists():
        FULL_FIXTURE.write_text(json.dumps(got, indent=1) + "\n")
    want = json.loads(FULL_FIXTURE.read_text())
    for key in ("checkpoint", "mel_seed", "prompt", "chunks", "servers", "pool_prompt", "tokens",
                "top20_ids"):
        assert got[key] == want[key], key
    for key in ("enc_rows", "top20_logits", "enc_projection"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)
    assert got["enc_norm"] == pytest.approx(want["enc_norm"], rel=1e-5)
    for pool in SERVERS:
        for g, w in zip(got[pool], want[pool], strict=True):
            assert g["tokens"] == w["tokens"] and g["n_sampled"] == w["n_sampled"]
            assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-5)
            assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=1e-6)
    del got
    errs = G.errors(port_full_readings(path, want), want)
    print(f"the port at f32 on the CPU against the fixture: {json.dumps(errs)}")
    assert max(errs["enc_rows"], errs["enc_norm"], errs["enc_projection"]) <= G.ENC_RTOL, errs
    assert errs["logits"] <= G.LOGITS_RTOL and errs["tokens_equal"], errs
    for pool in SERVERS:
        e = errs[pool]
        assert all(e["tokens_equal"]), (pool, e)
        assert e["avg_logprob"] <= G.pool_logprob_atol(want["servers"][pool]), (pool, e)
        assert e["no_speech_prob"] <= G.POOL_NO_SPEECH_ATOL, (pool, e)
