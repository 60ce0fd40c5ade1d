"""The port's benchmark on the card: the counterpart of the repository's
root `bench.py`, with its six modes on the port's own functions.

    python -m speaksense_tpu_torch.tools.bench                 # window + companions
    python -m speaksense_tpu_torch.tools.bench --mode sessions
    python -m speaksense_tpu_torch.tools.bench --device cpu --mode window ...

Modes (`--mode`, the reference's BENCH_MODE):
  window    (default) the headline `window_step` (bench.py:843-915): B 30 s
            windows through `W.encode` (the flash kernel), int8 cross-KV
            (`W.compute_cross_kv(..., int8=True)`), self-KV pages of
            t_cap = ceil((3 + tokens + 1) / 128) * 128 columns (int8 with
            its ring by default, `W.new_cache`), `W.decode_prefill` of a
            3-token prompt and a fixed-length argmax decode through
            `W.decode_step`'s ring path, which quantizes the ring into the
            pages every ring_width steps. No logit rules and no EOT stop, as in the
            reference. Warm-up once, then `--iters` runs, each ending in the
            fetch of the tokens to the host; `value` is the best run's audio
            seconds per wall second (the reference's figure, beside the
            TPU history), the median beside it, and one more run under
            torch.profiler gives the device busy share and the top kernels.
            The default run also runs two companions first: greedy serve
            and beam = 5 serve (repeats 2, `--e2e-beam-chunks` chunks, 3
            paced), both through the in-process driver unless
            `--serve-driver grpc`. Unlike the reference, a failed companion
            fails the run (no `serve_error` with exit 0).
  beam      `transcribe_window_beam` (models/beam.py) on B = 8 windows at
            beam 5, 224 tokens, int8 cross-KV (bench.py:688-738).
  sessions  64 threads each drive a `serving/stream.py` StreamSession (8
            chunks of 5 s, device denoise) against a 64-slot pool (t_mel
            512, 96 tokens, int8 KV); the ladder is armed, as in the
            reference (bench.py:490-562).
  serve     streams through the serving stack (bench.py:100-487): firehose
            `--serve-repeats` times, then paced at real time (one latency
            sample per response, most-recent-send attribution), a mid-load
            paced row, and a short run with the ladder armed. The stream
            driver is an argument: `grpc` (the reference's client against
            the port's `serving/grpc_server.py`; needs grpcio) or `inproc`
            (the same base64 chunks fed to StreamSession's ingest and
            settle, as the gRPC handler pipelines them, each response timed
            from the chunk's ingest). The card has no grpcio, so it runs
            `inproc`; the metric string names the driver.
  batch     16 files of 60 s through `TaskManager`, the scheduler's 4
            workers and `TranscribeProcessor` over `SqliteTaskStorage` and
            the window batcher (bench.py:565-686); audio seconds per wall
            second, and each task's wall from its stored timestamps.
  slots     the 64-slot pool driven directly, without sessions: 4 x S
            windows of t_mel 512 and 96 tokens (bench.py:23-98).

Every mode reports its best run (`value`, as the reference quotes it), the
median and every run: window and beam after a warm-up, sessions, batch and
slots over `--iters` runs too (the reference runs those once); serve
repeats its firehose `--serve-repeats` times and quotes the last.

Flags and the reference's environment variables (same defaults; the port
reads no environment variable of its own):
  --mode BENCH_MODE, --model BENCH_MODEL (large-v3), --batch BENCH_BATCH
  (64 window, 8 beam), --decode-tokens BENCH_DECODE_TOKENS (200 window, 224
  beam), --iters BENCH_ITERS (3), --int8-kv BENCH_INT8_KV (on),
  --int8-self-kv BENCH_INT8_SELF_KV (on), --int8-w BENCH_INT8_W (off),
  --beam BENCH_BEAM (5), --e2e BENCH_E2E (on), --e2e-beam BENCH_E2E_BEAM
  (on), --e2e-beam-chunks BENCH_E2E_BEAM_CHUNKS (6);
  serve and sessions: --serve-streams (64), --serve-chunks (8),
  --serve-paced-chunks (6), --serve-repeats (2), --serve-tokens (96),
  --serve-denoise (on), --serve-slots (on), --serve-beam (0),
  --serve-beam-slots (32), --serve-int8w (off), --serve-int8self (on for
  beam), --serve-fallback (off), --serve-nothresh (on), --serve-prompt
  (16), --serve-cond (on), --serve-maxbatch (8), --serve-paced-mid
  (streams / 2), --serve-thresh-phase (on), --serve-thresh-streams (16),
  --serve-thresh-chunks (2), each BENCH_SERVE_<NAME>;
  batch: --batch-files (16), --batch-seconds (60), --batch-workers (4),
  --batch-fast (off), each BENCH_BATCH_<NAME>;
  slots: --slots BENCH_SLOTS (64), --slots-tmel (512), --slots-tokens (96),
  --windows BENCH_WINDOWS (4 x slots), --slots-mel BENCH_SLOTS_MEL (off).
No counterpart: BENCH_KV_WRITE and BENCH_FUSE_QKV (the reference's XLA
write layouts and q/k/v fusion: the port writes each column in place and
always fuses q/k/v), BENCH_SERVE_K (k steps a dispatch: the port's pool
steps once a call), SPEAKSENSE_ADMIT_BUCKETS (the port admits up to 8 rows
without buckets). The port's own: --serve-driver, --seed (weights and
data), --device (cuda; a run that finds no card raises), --out (the
sidecar file).

Output: the last line is one short JSON object (the headline keys and,
for the default run, the companions' RTFs and latencies) naming the
sidecar JSON that holds everything (by default under chiprun_out/bench/,
which .gitignore lists). Every result carries nproc and the card's name
and power limit (`nvidia-smi`), or "cpu". The weights are random: the
figures are the port's regression figures, not the north star's 30x.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import gc
import os
import tempfile
import threading
import time
import wave
from queue import Queue

import numpy as np
import torch

from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.ops import flash as F
from speaksense_tpu_torch.tools import measure as M

CHUNK_S = 5.0
PROMPT_LEN = 3
NEUTRAL = dict(compression_ratio_thold=1e9, logprob_thold=-1e9, entropy_thold=-1.0)
# the quality counters every serve phase records (bench.py:305-306)
QKEYS = ("asr_fallback_retries_total", "asr_pool_fallback_retries_total",
         "asr_no_speech_suppressed_total", "asr_slot_bucket_fallbacks_total")
# the spread between best and median above which a result says so
SPREAD_NOTE = 0.2


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def random_model(dims: W.WhisperDims, device: torch.device, seed: int) -> W.Whisper:
    """Random bf16 weights drawn on the device from an explicit generator."""
    return W.init_random(dims, torch.Generator(device=device).manual_seed(seed),
                         device=device, dtype=torch.bfloat16)


def _engine(dims, device, seed: int, **config):
    from speaksense_tpu_torch.asr.engine import WhisperEngine

    return WhisperEngine(random_model(dims, device, seed), Tokenizer.synthetic(dims.n_vocab),
                         config=EngineConfig(**config), name="random", seed=seed)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _rtf(audio_s: float, wall_s: float) -> float:
    return audio_s / wall_s


def _spread_note(best: float, median: float) -> str | None:
    """A note when the median run is more than SPREAD_NOTE slower than the
    best: the host moved, and neither figure alone stands for the run."""
    if median > best * (1 + SPREAD_NOTE):
        return (f"median {median:.3f} s is {100 * (median / best - 1):.0f}% above the best "
                f"{best:.3f} s: report both")
    return None


def _counters() -> dict:
    from speaksense_tpu_torch.utils.metrics import REGISTRY

    c = REGISTRY.snapshot()["counters"]
    return {k: c.get(k, 0.0) for k in QKEYS}


def _qdelta(a: dict, b: dict) -> dict:
    return {k.replace("asr_", "").replace("_total", ""): b[k] - a[k] for k in QKEYS}


def _in_threads(fn, n: int) -> float:
    """fn() in n threads at once; the wall seconds until all end. The
    first exception raised in a thread is raised here."""
    errors: list = []

    def guarded():
        try:
            fn()
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=guarded, daemon=True) for _ in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall


def _pcm_chunks(seed: int, n: int = 8) -> list[np.ndarray]:
    """n distinct 5 s s16 chunks (identical consecutive chunks would be
    suppressed by the stitching, bench.py:241-247)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(CHUNK_S * 16000)) * 1500).astype(np.int16)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# window: the headline
# ---------------------------------------------------------------------------

@torch.no_grad()
def window_step(model: W.Whisper, mel: torch.Tensor, prompt: torch.Tensor,
                decode_tokens: int, int8_kv: bool = True, int8_self_kv: bool = True
                ) -> torch.Tensor:
    """encode + cross-KV + prefill + a fixed-length argmax decode of B
    windows (the reference's `window_step`, bench.py:843-915): no logit
    rules, no EOT stop. The self-KV pages hold t_cap columns. With
    int8_self_kv they are int8 and the decode writes a ring of ring_width
    rows that `W.decode_step` quantizes into them every ring_width steps,
    as the reference's ring decode; bf16 pages take each column in place
    (the port's layout, not the reference's TPU ring). Returns every
    row's tokens (B, decode_tokens + 1): the prefill's argmax, then each
    step's (the reference returns the last column)."""
    dims = model.dims
    B, P = prompt.shape
    enc = W.encode(model, mel)
    t_cap = min(dims.n_text_ctx, -(-(P + decode_tokens + 1) // 128) * 128)
    cache = W.new_cache(model, W.compute_cross_kv(model, enc, int8=int8_kv), t_cap,
                        self_int8=int8_self_kv,
                        ring_width=D.ring_width(decode_tokens) if int8_self_kv else None)
    toks = [W.decode_prefill(model, prompt, cache)[:, -1].argmax(-1)]
    plen = torch.full((B,), P, dtype=torch.long, device=prompt.device)
    for step in range(decode_tokens):
        toks.append(W.decode_step(model, toks[-1], cache, step, plen, P).argmax(-1))
    return torch.stack(toks, dim=1)


def _repeat(run, iters: int, device) -> tuple:
    """A warm-up run, `iters` timed runs (each ends in a fetch to the
    host) and one more under the profiler. Returns (the warm-up's output,
    the timed runs' outputs, their spread, the profile)."""
    first = run()
    outs, times = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        outs.append(run())
        times.append(time.perf_counter() - t0)
    return first, outs, M.spread(times), M.profile(run, device)


def _walls_result(audio_s: float, walls: list[float]) -> dict:
    """`value` (the best run's RTF, as the reference quotes its headline),
    the median run's and every run of a mode timed `--iters` times."""
    sp = M.spread(walls)
    return {"value": _rtf(audio_s, sp["best_s"]), "unit": "x_realtime",
            "vs_baseline": _rtf(audio_s, sp["best_s"]) / 30.0,
            "median_rtf": _rtf(audio_s, sp["median_s"]), **sp,
            "spread_note": _spread_note(sp["best_s"], sp["median_s"])}


def _rtf_result(metric: str, audio_s: float, sp: dict, prof: dict) -> dict:
    """The reference's keys for a repeated run (`value`: the best run's
    RTF) with the median, every run, the device busy share and profile."""
    return {"metric": metric, "value": _rtf(audio_s, sp["best_s"]), "unit": "x_realtime",
            "vs_baseline": _rtf(audio_s, sp["best_s"]) / 30.0,
            "median_rtf": _rtf(audio_s, sp["median_s"]), "busy_share": prof["busy_share"],
            **sp, "spread_note": _spread_note(sp["best_s"], sp["median_s"]), "profile": prof}


def bench_window(args, dims, device) -> dict:
    B = args.batch or 64
    n = args.decode_tokens or 200
    model = random_model(dims, device, args.seed)
    if args.int8_w:
        W.quantize_block_weights(model)
    g = torch.Generator(device=device).manual_seed(args.seed)
    mel = torch.randn((B, 3000, dims.n_mels), generator=g, device=device).to(torch.bfloat16)
    prompt = torch.zeros((B, PROMPT_LEN), dtype=torch.long, device=device)

    def run():
        return window_step(model, mel, prompt, n, args.int8_kv, args.int8_self_kv).cpu()

    launches0 = F.flash_attention_full.launches
    first, outs, sp, prof = _repeat(run, args.iters, device)
    launches = F.flash_attention_full.launches - launches0
    metric = (f"{args.model} batched transcription real-time factor (audio-s/s, B={B}, {n} "
              f"tok/window{', int8 cross-KV' if args.int8_kv else ''}"
              f"{', int8 self-KV' if args.int8_self_kv else ''}"
              f"{', int8 weights' if args.int8_w else ''}; port, {device.type})")
    return {**_rtf_result(metric, B * 30.0, sp, prof),
            "tokens_same": all(torch.equal(t, first) for t in outs),
            "tokens": first.tolist(), "flash_launches": launches,
            "flash_runs": args.iters + 2,
            "batch": B, "decode_tokens": n}


# ---------------------------------------------------------------------------
# beam
# ---------------------------------------------------------------------------

def bench_beam(args, dims, device) -> dict:
    from speaksense_tpu_torch.models.beam import transcribe_window_beam

    B, K = args.batch or 8, args.beam
    n = args.decode_tokens or 224
    model = random_model(dims, device, args.seed)
    tok = Tokenizer.synthetic(dims.n_vocab)
    cfg = D.RuleConfig.from_tokenizer(tok, max_new_tokens=n)
    suppress = torch.as_tensor(tok.suppress_mask(), device=device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    mel = torch.randn((B, 3000, dims.n_mels), generator=g, device=device).to(torch.bfloat16)
    prompt = torch.as_tensor(tok.sot_sequence("en"), device=device).repeat(B, 1)

    def run():
        return transcribe_window_beam(model, cfg, suppress, mel, prompt, beam_size=K,
                                      cross_kv_int8=args.int8_kv)["tokens"].cpu()

    _, _, sp, prof = _repeat(run, args.iters, device)
    metric = (f"{args.model} beam-search transcription real-time factor (B={B}, beam={K}, {n} "
              f"max tokens/window{', int8 cross-KV' if args.int8_kv else ''}; port, "
              f"{device.type})")
    return _rtf_result(metric, B * 30.0, sp, prof)


# ---------------------------------------------------------------------------
# sessions and serve: the stream drivers
# ---------------------------------------------------------------------------

class _Latencies:
    """Most-recent-send attribution (bench.py:258-267): a response's sample
    is its arrival minus the last send before it."""

    def __init__(self):
        self.samples: list[float] = []
        self.responses = 0
        self.sends = 0
        self.lock = threading.Lock()

    def stream(self, sends: list[float], arrivals: list[float]) -> None:
        j, out = 0, []
        for t in arrivals:
            while j + 1 < len(sends) and sends[j + 1] <= t:
                j += 1
            out.append(t - sends[j])
        with self.lock:
            self.samples.extend(out)
            self.responses += len(arrivals)
            self.sends += len(sends)


class InProcessDriver:
    """Streams fed to the port's StreamSession in this process, pipelined as
    the gRPC handler pipelines them (`serving/grpc_server.py`): per stream,
    one thread ingests each chunk's base64 bytes (its send time) and queues
    the pending chunks, at most `max_inflight`, and another settles them in
    order and records each response's arrival; `end` flushes the tail."""

    name = "in-process StreamSession driver"

    def __init__(self, engine, language: str = "en", denoise: bool = True,
                 condition: bool = True, max_inflight: int = 8):
        self.engine = engine
        self.kw = dict(language=language, denoise=denoise, condition=condition)
        self.max_inflight = max_inflight

    def close(self) -> None:
        pass

    def _one(self, audio_b64s, chunks: int, pace_s: float, lat: _Latencies,
             texts: list | None) -> None:
        from speaksense_tpu_torch.serving.stream import StreamSession

        session = StreamSession(self.engine, **self.kw)
        q: Queue = Queue(maxsize=self.max_inflight)
        sends: list[float] = []

        def ingest():
            try:
                for c in range(chunks):
                    sends.append(time.perf_counter())
                    for p in session.ingest(audio_b64s[c % len(audio_b64s)]):
                        q.put(("chunk", p))
                    if pace_s:
                        time.sleep(pace_s)
                q.put(("finish", None))
            except Exception as e:     # handed to the settling thread, which raises it
                q.put(("error", e))

        feeder = threading.Thread(target=ingest, daemon=True)
        feeder.start()
        arrivals, got = [], []
        try:
            while True:
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                events = session.settle(payload) if kind == "chunk" else session.finish()
                for ev in events:
                    if ev.end == 0:
                        arrivals.append(time.perf_counter())
                    got.append((ev.end, ev.text))
                if kind == "finish":
                    break
        finally:
            feeder.join(60)
        lat.stream(sends, arrivals)
        if texts is not None:
            texts.append(got)

    def drive(self, n: int, chunks: int, pace_s: float, lat: _Latencies,
              texts: list | None = None, audio=None) -> float:
        """n concurrent streams of `chunks` chunks, sent every pace_s
        seconds (0: back to back). Returns the wall seconds."""
        return _in_threads(lambda: self._one(audio, chunks, pace_s, lat, texts), n)


class GrpcDriver:
    """The reference's gRPC client (bench.py:254-297) against the port's
    `serving/grpc_server.py` GrpcServer on a loopback port, both on one
    asyncio loop in a thread of their own."""

    name = "gRPC driver"
    SERVICE_PATH = "/asr.Asr/Transcribe"

    def __init__(self, engine, language: str = "en", denoise: bool = True,
                 condition: bool = True):
        import grpc

        from speaksense_tpu_torch.serving.grpc_server import GrpcServer

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = GrpcServer(engine, port=0, registry=None, language=language,
                                 denoise=denoise, condition=condition)
        self._run(self.server.start())
        self.channel = self._run(self._open(grpc))

    async def _open(self, grpc):
        return grpc.aio.insecure_channel(f"127.0.0.1:{self.server.port}")

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def close(self) -> None:
        try:
            self._run(self.channel.close())
            self._run(self.server.stop(grace=0.5))
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()

    async def _one(self, audio_b64s, chunks, pace_s, lat: _Latencies, texts):
        from speaksense_tpu_torch.serving.pb import asr_pb2

        sends: list[float] = []

        async def gen():
            for c in range(chunks):
                sends.append(time.perf_counter())
                yield asr_pb2.TranscribeRequest(type=asr_pb2.PCM, end=0,
                                                audio=audio_b64s[c % len(audio_b64s)])
                if pace_s:
                    await asyncio.sleep(pace_s)
            yield asr_pb2.TranscribeRequest(type=asr_pb2.PCM, end=1, audio=b"")

        call = self.channel.stream_stream(
            self.SERVICE_PATH,
            request_serializer=asr_pb2.TranscribeRequest.SerializeToString,
            response_deserializer=asr_pb2.TranscribeResponse.FromString)
        arrivals, got = [], []
        async for resp in call(gen()):
            if resp.end == 0:
                arrivals.append(time.perf_counter())
            got.append((resp.end, resp.text.decode("utf-8")))
        lat.stream(sends, arrivals)
        if texts is not None:
            texts.append(got)

    def drive(self, n: int, chunks: int, pace_s: float, lat: _Latencies,
              texts: list | None = None, audio=None) -> float:
        async def all_streams():
            t0 = time.perf_counter()
            await asyncio.gather(*[self._one(audio, chunks, pace_s, lat, texts)
                                   for _ in range(n)])
            return time.perf_counter() - t0

        return self._run(all_streams())


DRIVERS = {"inproc": InProcessDriver, "grpc": GrpcDriver}


def _pool_snap(engine) -> tuple | None:
    srv = engine._slot_server
    if srv is None:
        return None
    p = srv.pool
    return (p.admit_calls, p.admit_rows, p.step_calls, p.occupancy_sum)


def _pool_stats(s0, s1) -> dict:
    if not (s0 and s1):
        return {}
    d_admits, d_rows, d_steps, d_occ = (b - a for a, b in zip(s0, s1))
    return {"admit_avg_batch": d_rows / max(1, d_admits),
            "avg_occupancy": d_occ / max(1, d_steps),
            "step_calls": d_steps, "admit_calls": d_admits}


def _quantiles(samples: list[float]):
    s = sorted(samples)
    if not s:
        return lambda p: None
    return lambda p: s[min(len(s) - 1, int(p * len(s)))]


def bench_sessions(args, dims, device) -> dict:
    """bench.py:490-562: StreamSession threads against the pool, no
    transport."""
    n_streams, n_chunks = args.serve_streams, args.serve_chunks
    engine = _engine(dims, device, args.seed, cross_kv_int8=True)
    engine.enable_slot_serving(n_slots=n_streams, t_mel=512, max_new=args.serve_tokens,
                               int8_kv=True)
    b64 = base64.standard_b64encode(_pcm_chunks(args.seed, 1)[0].tobytes())
    try:
        from speaksense_tpu_torch.serving.stream import StreamSession

        def one_stream():
            s = StreamSession(engine, language="en", denoise=args.serve_denoise)
            for _ in range(n_chunks):
                s.feed(b64)
            s.finish()

        one_stream()                                # warm-up
        walls = []
        for _ in range(args.iters):                 # the last run's counters are quoted
            c0, q0 = _pool_snap(engine), _counters()
            walls.append(_in_threads(one_stream, n_streams))
            c1, q1 = _pool_snap(engine), _counters()
    finally:
        engine.disable_slot_serving()
    return {
        "metric": f"{args.model} session-level serving real-time factor ({n_streams} threads, "
                  f"{CHUNK_S:.0f}s chunks, no gRPC, denoise="
                  f"{'on' if args.serve_denoise else 'off'}; port, {device.type})",
        **_walls_result(n_streams * n_chunks * CHUNK_S, walls),
        **_pool_stats(c0, c1), "quality_counters": _qdelta(q0, q1),
    }


def bench_serve(args, dims, device, driver: str | None = None, **overrides) -> dict:
    """bench.py:100-487 on `driver` ("inproc" or "grpc"): warm-up, the
    firehose `repeats` times, paced at real time, a mid-load paced row, and
    a short run with the ladder armed. `overrides` replace flags, as the
    default run's beam companion does (beam, repeats, chunks,
    paced_chunks)."""
    from speaksense_tpu_torch.runtime.batcher import BatchedEngine

    def knob(name):
        return overrides.get(name, getattr(args, f"serve_{name}"))

    driver = driver or args.serve_driver
    n_streams, n_chunks = knob("streams"), knob("chunks")
    paced_chunks, repeats = knob("paced_chunks"), max(1, knob("repeats"))
    max_new, denoise, use_slots = knob("tokens"), knob("denoise"), knob("slots")
    beam, beam_slots, int8_w = knob("beam"), knob("beam_slots"), knob("int8w")
    int8_self = knob("int8self")
    if int8_self is None:
        int8_self = beam > 1
    max_prompt, cond_on, max_batch = knob("prompt"), knob("cond"), knob("maxbatch")
    thresh_armed = knob("fallback") or not knob("nothresh")
    mid = knob("paced_mid")
    mid = max(1, n_streams // 2) if mid is None else mid

    engine = _engine(dims, device, args.seed, cross_kv_int8=True, weights_int8=int8_w,
                     beam_size=beam, max_batch_size=max_batch,
                     **({} if thresh_armed else NEUTRAL))
    if use_slots:
        engine.enable_slot_serving(n_slots=beam_slots if beam > 1 else n_streams, t_mel=512,
                                   max_new=max_new, int8_kv=True, self_int8=int8_self,
                                   beam_size=beam, max_prompt=max_prompt)
    serving = BatchedEngine(engine)
    audio = [base64.standard_b64encode(c.tobytes()) for c in _pcm_chunks(args.seed)]
    drv = DRIVERS[driver](serving, language="en", denoise=denoise, condition=cond_on)
    runs, paced, mid_lat, thresh_real = [], _Latencies(), _Latencies(), None
    try:
        t_w0 = time.perf_counter()
        drv.drive(1, n_chunks, 0.0, _Latencies(), audio=audio)
        drv.drive(8, n_chunks, 0.0, _Latencies(), audio=audio)
        warm_wall = time.perf_counter() - t_w0
        for _ in range(repeats):
            s0, q0 = _pool_snap(engine), _counters()
            wall = drv.drive(n_streams, n_chunks, 0.0, _Latencies(), audio=audio)
            runs.append((wall, s0, _pool_snap(engine), q0, _counters()))
        paced_wall = drv.drive(n_streams, paced_chunks, CHUNK_S, paced, audio=audio)
        if 0 < mid < n_streams:
            drv.drive(mid, paced_chunks, CHUNK_S, mid_lat, audio=audio)
        if not thresh_armed and beam <= 1 and knob("thresh_phase"):
            # arm whisper's default gates on the live engine (host reads of
            # engine.config) for a short firehose (bench.py:369-393)
            dflt = EngineConfig()
            for k in NEUTRAL:
                setattr(engine.config, k, getattr(dflt, k))
            ts, tc = knob("thresh_streams"), knob("thresh_chunks")
            q0 = _counters()
            t_wall = drv.drive(ts, tc, 0.0, _Latencies(), audio=audio)
            thresh_real = {"rtf": _rtf(ts * tc * CHUNK_S, t_wall), "streams": ts,
                           "chunks": tc, **_qdelta(q0, _counters())}
    finally:
        drv.close()
        engine.disable_slot_serving()
        serving.stop()
    run_rtfs = [_rtf(n_streams * n_chunks * CHUNK_S, w) for w, *_ in runs]
    # the last firehose run is quoted (steady state), every run is kept
    wall, s0, s1, q0, q1 = runs[-1]
    rtf = _rtf(n_streams * n_chunks * CHUNK_S, wall)
    q, qm = _quantiles(paced.samples), _quantiles(mid_lat.samples)
    return {
        "metric": f"{args.model} END-TO-END serving real-time factor through the "
                  f"{DRIVERS[driver].name} ({n_streams} concurrent streams, {CHUNK_S:.0f}s "
                  f"chunks, " + ("slot pool, " if use_slots else f"window batcher "
                                 f"B={max_batch}, ")
                  + (f"beam={beam}, " if beam > 1 else "")
                  + ("quality thresholds real, " if thresh_armed else
                     "quality fallback armed but thresholds neutralized (synthetic weights; "
                     "see thresh_real phase), ")
                  + ("int8 weights, " if int8_w else "") + ("int8 self-KV, " if int8_self else "")
                  + (f"conditioned prompt={max_prompt}, " if max_prompt > 16 else "")
                  + f"denoise={'on' if denoise else 'off'}, rules+stitching on; port, "
                    f"{device.type})",
        "value": rtf, "unit": "x_realtime", "vs_baseline": rtf / 30.0,
        "driver": driver,
        "firehose_runs": run_rtfs,
        "firehose_best": max(run_rtfs), "firehose_median": float(np.median(run_rtfs)),
        "p50_chunk_latency_s": q(0.50), "p95_chunk_latency_s": q(0.95),
        "paced_samples": len(paced.samples),
        "paced_streams": n_streams,
        "paced_responses_per_chunk": paced.responses / max(1, paced.sends),
        "p50_chunk_latency_mid_s": qm(0.50), "p95_chunk_latency_mid_s": qm(0.95),
        "paced_mid_streams": mid if mid_lat.sends else None,
        "paced_mid_responses_per_chunk": (mid_lat.responses / mid_lat.sends
                                          if mid_lat.sends else None),
        "warmup_wall_s": warm_wall, "paced_wall_s": paced_wall,
        "knobs": {"streams": n_streams, "chunks": n_chunks, "paced_chunks": paced_chunks,
                  "tokens": max_new, "denoise": denoise, "slots": use_slots, "beam": beam,
                  "int8_w": int8_w, "int8_self": int8_self, "repeats": repeats,
                  "thresh_armed": thresh_armed,
                  "beam_slots": beam_slots if (beam > 1 and use_slots) else None,
                  "max_prompt": max_prompt, "condition": cond_on},
        "quality_counters": _qdelta(q0, q1),
        **({"thresh_real": thresh_real} if thresh_real is not None else {}),
        **_pool_stats(s0, s1),
    }


# ---------------------------------------------------------------------------
# batch: the durable task queue
# ---------------------------------------------------------------------------

def bench_batch(args, dims, device) -> dict:
    """bench.py:565-686: WAV files through the task manager, the
    scheduler's workers and TranscribeProcessor over SQLite and the window
    batcher. Each task's wall is read from its stored timestamps (created
    to completed)."""
    import shutil

    from speaksense_tpu_torch.runtime.batcher import BatchedEngine
    from speaksense_tpu_torch.schedule.manager import TaskManager
    from speaksense_tpu_torch.schedule.processors import TranscribeProcessor
    from speaksense_tpu_torch.schedule.scheduler import create_scheduler
    from speaksense_tpu_torch.schedule.types import (
        CallbackType, PathType, TaskConfig, TaskParams, TaskStatus, TaskType,
        TranscribeParams,
    )
    from speaksense_tpu_torch.storage.sqlite import SqliteTaskStorage

    n_files, file_s, n_workers = args.batch_files, args.batch_seconds, args.batch_workers
    cfg = dict(cross_kv_int8=True)
    if args.batch_fast:
        # random weights on random audio otherwise climb the whole ladder at
        # 224 tokens a window (bench.py:609-616); not for real numbers
        cfg.update(max_decode_len=64, **NEUTRAL)
    engine = BatchedEngine(_engine(dims, device, args.seed, **cfg))
    rng = np.random.default_rng(args.seed)
    tmp = tempfile.mkdtemp(prefix="speaksense_bench_")
    paths = []
    for i in range(n_files):
        pcm = (rng.standard_normal(int(file_s * 16000)) * 1500).astype(np.int16)
        p = os.path.join(tmp, f"f{i}.wav")
        with wave.open(p, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        paths.append(p)
    storage = SqliteTaskStorage(os.path.join(tmp, "tasks.db"))
    manager = TaskManager(storage)
    manager.register_processor(TranscribeProcessor(engine, audio_dir=tmp))

    def task(path):
        return manager.create_task(TaskConfig(
            task_type=TaskType.TRANSCRIBE, input_path=str(path), path_type=PathType.LOCAL,
            callback_type=CallbackType.none(),
            params=TaskParams.transcribe(TranscribeParams(language="en")))).id

    def wait_done(ids, timeout=3600):
        deadline, done_at = time.time() + timeout, {}
        while time.time() < deadline and len(done_at) < len(ids):
            for tid in ids:
                if tid in done_at:
                    continue
                st = manager.get_task_status(tid)
                if st is not None and st.kind == TaskStatus.COMPLETED:
                    done_at[tid] = time.time()
                elif st is not None and st.kind == TaskStatus.FAILED:
                    raise RuntimeError(f"task {tid} failed: {st.error}")
            time.sleep(0.05)
        if len(done_at) < len(ids):
            raise TimeoutError(f"{len(ids) - len(done_at)} tasks unfinished")
        return done_at

    scheduler = create_scheduler(manager, [TaskType.TRANSCRIBE],
                                 workers={TaskType.TRANSCRIBE: n_workers})
    try:
        wait_done([task(paths[0])])                 # warm-up
        walls = []
        for _ in range(args.iters):                 # the last run's latencies are quoted
            t0 = time.time()
            ids = [task(p) for p in paths]
            done_at = wait_done(ids)
            walls.append(max(done_at.values()) - t0)
        stored = []
        for tid in ids:
            t = manager.get_task(tid)
            stored.append((t.completed_at - t.created_at).total_seconds())
    finally:
        scheduler.stop()
        engine.stop()
        storage.close()
        shutil.rmtree(tmp, ignore_errors=True)
    lat = sorted(v - t0 for v in done_at.values())
    stored.sort()
    return {
        "metric": f"{args.model} END-TO-END batch-task pipeline real-time factor ({n_files} x "
                  f"{file_s:.0f}s files, {n_workers} concurrent task workers, durable queue, "
                  f"long-form seek + conditioning, window batcher"
                  f"{', fast: 64 tokens, ladder neutralized' if args.batch_fast else ''}; "
                  f"port, {device.type})",
        **_walls_result(n_files * file_s, walls),
        "p50_task_latency_s": lat[len(lat) // 2],
        "p95_task_latency_s": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
        "task_wall_stored_s": {"p50": stored[len(stored) // 2], "max": stored[-1],
                               "all": stored},
    }


# ---------------------------------------------------------------------------
# slots: the pool alone
# ---------------------------------------------------------------------------

def bench_slots(args, dims, device) -> dict:
    """bench.py:23-98: S-slot pool, 4 x S windows submitted at once (s16
    PCM by default, the production ingestion; `--slots-mel` host mels)."""
    from speaksense_tpu_torch.runtime.slots import StreamingDecodeServer

    S, t_mel, max_new = args.slots, args.slots_tmel, args.slots_tokens
    n_windows = args.windows or 4 * S
    engine = _engine(dims, device, args.seed, cross_kv_int8=True)
    server = StreamingDecodeServer(engine, n_slots=S, t_mel=t_mel, max_new=max_new,
                                   int8_kv=True)
    rng = np.random.default_rng(args.seed)
    chunk_s = t_mel * 160 / 16000.0
    if args.slots_mel:
        payload = rng.standard_normal((t_mel, dims.n_mels)).astype(np.float32)
        sub = server.submit
    else:
        payload = (rng.standard_normal(int(t_mel * 160)) * 1500).astype(np.int16)
        sub = server.submit_audio
    try:
        sub(payload).result(timeout=3600)           # warm-up
        walls = []
        for _ in range(args.iters):
            a0 = (server.pool.admit_calls, server.pool.step_calls)
            t0 = time.perf_counter()
            futs = [sub(payload) for _ in range(n_windows)]
            for f in futs:
                f.result(timeout=3600)
            walls.append(time.perf_counter() - t0)
            a1 = (server.pool.admit_calls, server.pool.step_calls)
    finally:
        server.stop()
    return {
        "metric": f"{args.model} slot-pool streaming serving real-time factor ({S} concurrent "
                  f"streams, {chunk_s:.1f}s chunks, int8 cross-KV, {max_new} tok/chunk; "
                  f"port, {device.type})",
        **_walls_result(n_windows * chunk_s, walls),
        "admit_calls": a1[0] - a0[0], "step_calls": a1[1] - a0[1],
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

MODES = {"window": bench_window, "beam": bench_beam, "sessions": bench_sessions,
         "serve": bench_serve, "batch": bench_batch, "slots": bench_slots}
HEADLINE = ("metric", "value", "unit", "vs_baseline", "median_rtf", "busy_share",
            "spread_note", "card", "nproc", "note")
COMPANIONS = ("serve_rtf", "serve_p50_chunk_latency_s", "serve_p95_chunk_latency_s",
              "beam_serve_rtf", "beam_p50_chunk_latency_s", "beam_p95_chunk_latency_s",
              "serve_driver")


def parser() -> argparse.ArgumentParser:
    on = argparse.BooleanOptionalAction
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="window")
    ap.add_argument("--model", default="large-v3", choices=tuple(W.MODEL_DIMS))
    ap.add_argument("--batch", type=int, default=None, help="64 (window), 8 (beam)")
    ap.add_argument("--decode-tokens", type=int, default=None, help="200 (window), 224 (beam)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--int8-kv", action=on, default=True)
    ap.add_argument("--int8-self-kv", action=on, default=True)
    ap.add_argument("--int8-w", action=on, default=False)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--e2e", action=on, default=True)
    ap.add_argument("--e2e-beam", action=on, default=True)
    ap.add_argument("--e2e-beam-chunks", type=int, default=6)
    ap.add_argument("--serve-driver", choices=tuple(DRIVERS), default="inproc")
    ap.add_argument("--serve-streams", type=int, default=64)
    ap.add_argument("--serve-chunks", type=int, default=8)
    ap.add_argument("--serve-paced-chunks", type=int, default=6)
    ap.add_argument("--serve-repeats", type=int, default=2)
    ap.add_argument("--serve-tokens", type=int, default=96)
    ap.add_argument("--serve-denoise", action=on, default=True)
    ap.add_argument("--serve-slots", action=on, default=True)
    ap.add_argument("--serve-beam", type=int, default=0)
    ap.add_argument("--serve-beam-slots", type=int, default=32)
    ap.add_argument("--serve-int8w", action=on, default=False)
    ap.add_argument("--serve-int8self", action=on, default=None, help="on for beam > 1")
    ap.add_argument("--serve-fallback", action=on, default=False)
    ap.add_argument("--serve-nothresh", action=on, default=True)
    ap.add_argument("--serve-prompt", type=int, default=16)
    ap.add_argument("--serve-cond", action=on, default=True)
    ap.add_argument("--serve-maxbatch", type=int, default=8)
    ap.add_argument("--serve-paced-mid", type=int, default=None, help="streams / 2")
    ap.add_argument("--serve-thresh-phase", action=on, default=True)
    ap.add_argument("--serve-thresh-streams", type=int, default=16)
    ap.add_argument("--serve-thresh-chunks", type=int, default=2)
    ap.add_argument("--batch-files", type=int, default=16)
    ap.add_argument("--batch-seconds", type=float, default=60.0)
    ap.add_argument("--batch-workers", type=int, default=4)
    ap.add_argument("--batch-fast", action=on, default=False)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--slots-tmel", type=int, default=512)
    ap.add_argument("--slots-tokens", type=int, default=96)
    ap.add_argument("--windows", type=int, default=None, help="4 x slots")
    ap.add_argument("--slots-mel", action=on, default=False)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="the sidecar JSON (default chiprun_out/bench/)")
    return ap


def run(args, dims: W.WhisperDims | None = None) -> dict:
    """One mode (and, for the default window run, its companions first, as
    the reference runs them). `dims` replaces the model's dimensions (the
    tests' tiny models). Returns the whole result, stamped with the card."""
    device = M.resolve_device(args.device)
    if dims is not None and dims != W.MODEL_DIMS[args.model]:
        args.model = (f"d={dims.n_audio_state} {dims.n_audio_layer}+{dims.n_text_layer}-layer "
                      f"model")
    dims = dims or W.MODEL_DIMS[args.model]
    result: dict = {}
    if args.mode == "window" and args.e2e:
        serve = bench_serve(args, dims, device)
        _free(device)
        result["serve"] = serve
        if args.e2e_beam:
            result["beam_serve"] = bench_serve(args, dims, device, beam=5, repeats=2,
                                               chunks=args.e2e_beam_chunks, paced_chunks=3)
            _free(device)
    head = MODES[args.mode](args, dims, device)
    _free(device)
    result = {**head, **result, **M.stamp(device), "note": M.RANDOM_WEIGHTS_NOTE}
    for key, rtf, lat in (("serve", "serve_rtf", "serve"), ("beam_serve", "beam_serve_rtf", "beam")):
        comp = result.get(key)
        if comp is not None:
            result[rtf] = comp["value"]
            result[f"{lat}_p50_chunk_latency_s"] = comp["p50_chunk_latency_s"]
            result[f"{lat}_p95_chunk_latency_s"] = comp["p95_chunk_latency_s"]
            result["serve_driver"] = comp["driver"]
    return result


def main(argv=None, dims: W.WhisperDims | None = None) -> dict:
    args = parser().parse_args(argv)
    result = run(args, dims)
    return M.emit(result, HEADLINE + COMPANIONS, args.out, f"bench_{args.mode}")


if __name__ == "__main__":
    main()
