"""The port's REST front door against the JAX package's: both aiohttp apps
run on ephemeral loopback ports over their own stacks (SQLite stores, auth,
task manager), and the same request script (every route, auth failures, bad
JSON, the pending-only priority rule, rate limits and revocation) gets equal
status codes and JSON bodies, ids and timestamps aside. Then one
`/asr/transcribe` task runs end to end on tiny real engines with the JAX
weights carried across: the port's `TranscribeProcessor` on the port's
window batcher gives the JAX processor's stored segments and text, exactly,
in float32."""

import asyncio
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from aiohttp import ClientSession, web

from test_torch_schedule import PACKAGES, normalize

MODULES = ("asr.fake", "audio.io", "auth", "schedule.manager", "schedule.processors",
           "schedule.types", "serving.rest", "storage.sqlite")


def _stack(pkg: str, tmp, engine=None, **processor):
    """One package's REST context over a fresh SQLite file: (ctx, admin key,
    modules). No worker runs: the script sees tasks as it leaves them."""
    P = SimpleNamespace(**{m.replace(".", "_"): importlib.import_module(f"{pkg}.{m}")
                           for m in MODULES})
    tasks = P.storage_sqlite.SqliteTaskStorage(tmp / f"{pkg}.sqlite")
    keys = P.storage_sqlite.SqliteKeyStorage(tmp / f"{pkg}.sqlite")
    auth = P.auth.Auth(keys, keys)
    admin = auth.initialize_admin_key()
    manager = P.schedule_manager.TaskManager(tasks)
    manager.usage_hook = auth.record_usage
    manager.register_processor(P.schedule_processors.TranscribeProcessor(
        engine or P.asr_fake.FakeAsrEngine(), audio_dir=str(tmp), **processor))
    return P.serving_rest.AppContext(auth=auth, task_manager=manager), admin.key, P


async def _serve(ctx, build_app):
    runner = web.AppRunner(build_app(ctx))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


async def _request(client, method, path, **kw):
    async with client.request(method, path, **kw) as resp:
        text = await resp.text()
        body = json.loads(text) if resp.content_type == "application/json" else resp.content_type
        return resp.status, body


async def _script(ctx, admin: str, wav: str, base: str) -> tuple[list, dict]:
    """The request script against one app; returns (responses, id labels)."""
    labels = {admin: "<admin>", base: "<base>"}
    out = []
    admin_h = {"Authorization": f"Bearer {admin}"}
    async with ClientSession(base) as c:
        async def call(method, path, **kw):
            r = await _request(c, method, path, **kw)
            out.append((method, path.replace(base, ""), r))
            return r

        await call("POST", "/auth/api-keys", json={"name": "x"})
        await call("POST", "/auth/api-keys", headers=admin_h, data="not json")
        await call("POST", "/auth/api-keys", headers=admin_h, json={"name": "x"})
        _, body = await call("POST", "/auth/api-keys", headers=admin_h, json={
            "name": "svc", "permissions": ["Transcribe"], "expires_in_days": 7,
            "rate_limit": {"requests_per_minute": 4, "requests_per_hour": 0,
                           "requests_per_day": 0}})
        key = body["data"]["key_info"]["key"]
        labels[key] = "<key>"
        key_h = {"Authorization": f"Bearer {key}"}
        await call("POST", "/auth/api-keys", headers=key_h, json={"name": "y"})
        for path in (f"/auth/api-keys/{key}/stats", f"/auth/api-keys/{key}/usage",
                     "/auth/api-keys/key-nope/stats", "/auth/api-keys/key-nope/usage"):
            await call("GET", path, headers=admin_h)
        await call("GET", f"/auth/api-keys/{key}/stats")

        req = {"path": wav, "path_type": "Local", "callback_url": f"{base}/callback/http",
               "language": "en", "filter_dirty_words": True}
        await call("POST", "/asr/transcribe", json=req)
        await call("POST", "/asr/transcribe", headers=admin_h, data="{bad")
        await call("POST", "/asr/transcribe", headers=admin_h, json={"path": wav})
        await call("POST", "/asr/transcribe", headers=admin_h, json={**req, "path_type": "Ftp"})
        await call("POST", "/asr/transcribe", headers=admin_h, json={**req, "language": "de"})
        _, body = await call("POST", "/asr/transcribe", headers=key_h, json=req)
        labels[body["body"]] = "<task>"
        task = body["body"]
        await call("GET", f"/schedule/tasks/{task}")
        await call("GET", f"/schedule/tasks/{task}/status")

        raw = {"task_type": "Transcribe", "input_path": wav, "path_type": "Local",
               "callback_type": {"type": "None"}, "priority": "Low", "timeout": 60,
               "params": {"type": "Transcribe", "params": {"language": "ja"}},
               "api_key": key}
        _, body = await call("POST", "/schedule/tasks", json=raw)
        task2 = body["data"]["id"]
        labels[task2] = "<task2>"
        await call("POST", "/schedule/tasks", json={"task_type": "Transcribe"})
        await call("POST", "/schedule/tasks", data="[")
        await call("POST", "/schedule/tasks", json={**raw, "task_type": "Nope"})
        await call("POST", f"/schedule/tasks/{task2}/priority", json={"priority": "Critical"})
        await call("POST", f"/schedule/tasks/{task2}/priority", json={"priority": "Urgent"})
        await call("POST", f"/schedule/tasks/{task2}/priority", data="x")
        await call("POST", "/schedule/tasks/nope/priority", json={"priority": "High"})
        await call("GET", f"/schedule/tasks/{task2}")
        # a claimed task's priority is fixed (the route is pending-only)
        claimed = await asyncio.to_thread(ctx.task_manager.get_next_task)
        assert claimed.id == task2
        await call("POST", f"/schedule/tasks/{task2}/priority", json={"priority": "Low"})
        await call("GET", f"/schedule/tasks/{task2}/status")
        for path in ("/schedule/tasks/stats", "/schedule/tasks/stats?index=1&size=10",
                     "/schedule/tasks/nope", "/schedule/tasks/nope/status", "/health",
                     "/metrics"):
            await call("GET", path)
        await call("POST", "/callback/http", json={"task_id": "t", "status": "Completed"})

        # the per-minute limit (4: one spent above), then revocation
        for _ in range(4):
            await call("POST", "/asr/transcribe", headers=key_h, json=req)
        await call("GET", f"/auth/api-keys/{key}/stats", headers=admin_h)
        await call("DELETE", f"/auth/api-keys/{key}", headers=key_h)
        await call("DELETE", f"/auth/api-keys/{key}", headers=admin_h)
        await call("POST", "/asr/transcribe", headers=key_h, json=req)
        await call("GET", "/schedule/tasks/stats")
    return out, labels


def test_rest_routes_match_jax(tmp_path):
    from speaksense_tpu.audio.io import write_wav

    wav = tmp_path / "in.wav"
    write_wav(wav, 0.3 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000))

    async def run(pkg):
        ctx, admin, P = _stack(pkg, tmp_path)
        runner, base = await _serve(ctx, P.serving_rest.build_app)
        try:
            out, labels = await _script(ctx, admin, str(wav), base)
        finally:
            await runner.cleanup()
            ctx.task_manager.storage.close()
            ctx.auth.key_storage.close()
        return normalize(out, labels)

    want, got = asyncio.run(run(PACKAGES[0])), asyncio.run(run(PACKAGES[1]))
    statuses = [r[2][0] for r in got]
    assert {200, 201, 400, 401, 404, 500} <= set(statuses)
    redacted = next(r[2][1] for r in got if r[1] == "/schedule/tasks/<task>")
    assert redacted["data"]["config"]["api_key"] == "[redacted]"
    assert got[-2][2] == [401, {"code": 401, "message": "Authentication failed",
                                "body": "API key suspended"}]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, w[:2]


# the tiny engine pair of tests/test_torch_engine.py, fewer decode steps
DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2,
            n_text_layer=2)
NO_FALLBACK = dict(compute_dtype="float32", max_decode_len=64, best_of=1,
                   logprob_thold=-1e9, entropy_thold=-1.0, compression_ratio_thold=1e9)


@pytest.fixture()
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_transcribe_task_end_to_end_matches_jax(tmp_path, _one_torch_thread):
    """POST /asr/transcribe, a worker thread claims and processes the task
    through each package's TranscribeProcessor (VAD segmentation on, as a
    deployment may set it) and posts the callback to the app's echo route:
    the stored results are equal, exactly."""
    from speaksense_tpu.asr.engine import WhisperEngine as JEngine
    from speaksense_tpu.audio.io import write_wav
    from speaksense_tpu.config import EngineConfig as JConfig
    from speaksense_tpu.models import whisper as JW
    from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
    from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
    from speaksense_tpu_torch.config import EngineConfig as TConfig
    from speaksense_tpu_torch.models import whisper as TW
    from speaksense_tpu_torch.models.tokenizer import Tokenizer
    from speaksense_tpu_torch.runtime.batcher import BatchedEngine

    params = JW.init_params_np(JW.WhisperDims(**DIMS), seed=2)
    jeng = JEngine(params, JW.WhisperDims(**DIMS), JTokenizer.synthetic(DIMS["n_vocab"]),
                   config=JConfig(**NO_FALLBACK))
    teng = BatchedEngine(TEngine.from_jax_params(
        params, TW.WhisperDims(**DIMS), Tokenizer.synthetic(DIMS["n_vocab"]),
        config=TConfig(**NO_FALLBACK), device="cpu"), max_batch=2, max_wait_ms=1.0)
    rng = np.random.default_rng(7)
    t = np.arange(16000 * 6) / 16000
    speech = (0.2 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2)
              + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    speech[16000 * 5:] = 0.0
    wav = tmp_path / "speech.wav"
    write_wav(wav, speech)

    async def run(pkg, engine):
        ctx, admin, P = _stack(pkg, tmp_path, engine, vad_segmentation=True)
        runner, base = await _serve(ctx, P.serving_rest.build_app)
        try:
            async with ClientSession(base) as c:
                status, body = await _request(c, "POST", "/asr/transcribe", json={
                    "path": str(wav), "path_type": "Local", "language": "en",
                    "callback_url": f"{base}/callback/http", "emotion_recognition": True},
                    headers={"Authorization": f"Bearer {admin}"})
                assert (status, body["code"]) == (200, 0)
                m = ctx.task_manager
                task = await asyncio.to_thread(m.get_next_task)
                result = await asyncio.to_thread(m.process_task, task)
                await asyncio.to_thread(m.complete_task, task, result)
                _, stored = await _request(c, "GET", f"/schedule/tasks/{body['body']}")
                stats = await asyncio.to_thread(ctx.auth.get_key_stats, admin)
        finally:
            await runner.cleanup()
            ctx.task_manager.storage.close()
            ctx.auth.key_storage.close()
        return stored["data"], stats.total_audio_seconds

    try:
        (want, want_s), (got, got_s) = asyncio.run(run(PACKAGES[0], jeng)), asyncio.run(
            run(PACKAGES[1], teng))
    finally:
        teng.stop()
    assert got["status"] == want["status"] == "Completed"
    assert got["result"] == want["result"]
    assert got["result"]["result"]["segments"] and got["result"]["result"]["n_tokens"] > 0
    assert got_s == want_s == 6.0
    assert teng.windows_run == 1

