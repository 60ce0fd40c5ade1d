"""The port's composition root against the JAX package's: `main()`'s flags
reach the same config and `serve` arguments, `build_context` wires the same
stack (orphan recovery before the workers start), multi-chip serving is
refused, `python -m speaksense_tpu_torch.main --fake-engine` serves REST and
gRPC and drains on SIGTERM, and everything the task path needs imports and
runs where aiohttp, grpcio, protobuf and requests are missing, as on the
GPU image."""

import base64
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import speaksense_tpu.main as JM
import speaksense_tpu_torch.main as TM

REPO = Path(__file__).resolve().parent.parent

FLAG_SETS = {
    "defaults": [],
    "every_flag": ["--model", "m.bin", "--http-port", "7201", "--grpc-port", "7301",
                   "--batch", "16", "--int8-kv", "--int8-self-kv", "--int8-weights",
                   "--beam-size", "5", "--tp", "1", "--dp", "1", "--slot-serving",
                   "--slot-prompt", "64", "--no-condition", "--slot-tokens", "64",
                   "--slots", "32"],
    "fake": ["--fake-engine"],
}


def _captured_main(module, argv, monkeypatch):
    """Run `module.main()` on argv with `serve` and the log setup replaced;
    returns the config and keyword arguments `serve` was given."""
    seen = {}

    async def noop():
        pass

    def serve(config, **kwargs):
        seen.update(config=dataclasses.asdict(config), kwargs=kwargs)
        return noop()

    monkeypatch.setattr(module, "serve", serve)
    monkeypatch.setattr(module.logsetup, "init", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["main", *argv])
    module.main()
    return seen


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_main_flags_match_jax(flags, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no .env file is read
    want = _captured_main(JM, FLAG_SETS[flags], monkeypatch)
    got = _captured_main(TM, FLAG_SETS[flags] + ["--device", "cpu"], monkeypatch)
    assert got["kwargs"].pop("device") == "cpu"
    assert got == want
    if flags == "defaults":
        assert TM.parse_args([]).device == "cuda"
    if flags == "every_flag":
        assert want["config"]["engine"]["beam_size"] == 5
        assert want["kwargs"]["condition"] is False


@pytest.mark.parametrize("how", ["tp", "dp", "coordinator"])
def test_multi_gpu_serving_is_refused(how, monkeypatch, tmp_path):
    """Multi-GPU serving is ported; what it cannot serve is refused before
    anything starts: --tp/--dp above the local cards (none here), as the
    JAX server refuses them, and a coordinator without this host's
    SPEAKSENSE_PROCESS_ID."""
    monkeypatch.chdir(tmp_path)
    argv = {"tp": ["--tp", "2"], "dp": ["--dp", "2"], "coordinator": []}[how]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if how == "coordinator":
        monkeypatch.setenv("SPEAKSENSE_COORDINATOR", "10.0.0.1:1234")
        monkeypatch.setenv("SPEAKSENSE_NUM_PROCESSES", "2")
        monkeypatch.delenv("SPEAKSENSE_PROCESS_ID", raising=False)
    monkeypatch.setattr(TM.logsetup, "init", lambda *a, **k: None)
    match = "SPEAKSENSE_PROCESS_ID" if how == "coordinator" else "exceeds 1 local devices"
    with pytest.raises(ValueError, match=match):
        TM.main(argv)
    assert not (tmp_path / "asr_data").exists()


def _wav(path, seconds=3.0):
    from speaksense_tpu_torch.audio.io import write_wav

    t = np.arange(int(16000 * seconds)) / 16000
    write_wav(path, 0.3 * np.sin(2 * np.pi * 330 * t))


def test_build_context_wiring_matches_jax(tmp_path):
    """Both packages' build_context on a database holding a task left in
    Processing by an earlier process: the same processors and workers, the
    admin key, usage accounting, and the orphan requeued and then served."""
    outcomes = []
    for name, module in (("speaksense_tpu", JM), ("speaksense_tpu_torch", TM)):
        side = tmp_path / name
        side.mkdir()
        _wav(side / "in.wav")
        config = module.Config(sqlite_path=f"sqlite://{side}/db.sqlite",
                               audio_path=str(side / "audio"))
        config.task_workers = 2
        types = __import__(f"{name}.schedule.types", fromlist=["x"])
        sqlite = __import__(f"{name}.storage.sqlite", fromlist=["x"])
        fake = __import__(f"{name}.asr.fake", fromlist=["x"])
        store = sqlite.SqliteTaskStorage(config.sqlite_file)
        orphan = types.Task.new(types.TaskConfig(
            task_type=types.TaskType.TRANSCRIBE, input_path=str(side / "in.wav"),
            path_type=types.PathType.LOCAL, callback_type=types.CallbackType.none(),
            params=types.TaskParams.transcribe(types.TranscribeParams(language="en"))))
        orphan.status = types.TaskStatus.processing()
        store.create(orphan)
        store.close()
        ctx, scheduler = module.build_context(config, fake.FakeAsrEngine())
        try:
            deadline = time.monotonic() + 30
            while ctx.task_manager.get_task(orphan.id).status.kind != "Completed":
                assert time.monotonic() < deadline, "the orphan was not served"
                time.sleep(0.05)
            manager = ctx.task_manager
            admins = [k for k in ctx.auth.key_storage.list()
                      if "Admin" in [p.value for p in k.permissions]]
            outcomes.append((
                sorted((t.value, type(p).__name__) for t, p in manager.processors.items()),
                [str(w.task_type) for w in scheduler.workers],
                manager.usage_hook.__func__.__name__, manager.usage_hook.__self__ is ctx.auth,
                len(admins), manager.get_task(orphan.id).result.to_json(),
                dict(manager.get_task_stats())))
        finally:
            scheduler.stop()
            ctx.task_manager.storage.close()
            ctx.auth.key_storage.close()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][1] == ["Transcribe", "Transcribe", "NoiseReduction",
                              "VoiceprintRecognition"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_fake_engine_end_to_end(tmp_path):
    """The server as a user starts it: one transcribe task through REST (with
    the admin key it logs), one stream through gRPC, then SIGTERM drains it."""
    import grpc

    from speaksense_tpu_torch.serving.grpc_server import SERVICE_PATH
    from speaksense_tpu_torch.serving.pb import asr_pb2

    http_port, grpc_port = _free_port(), _free_port()
    _wav(tmp_path / "in.wav")
    env = {**os.environ, "PYTHONPATH": str(REPO), "ASR_HTTP_PORT": str(http_port),
           "ASR_GRPC_PORT": str(grpc_port), "ETCD_ENDPOINT": "http://127.0.0.1:1",
           "ASR_SQLITE_PATH": f"sqlite://{tmp_path}/db.sqlite",
           "ASR_AUDIO_PATH": str(tmp_path / "audio")}
    base = f"http://127.0.0.1:{http_port}"
    with open(tmp_path / "server.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "speaksense_tpu_torch.main",
                                 "--fake-engine"], cwd=tmp_path, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            assert time.monotonic() < deadline, (tmp_path / "server.log").read_text()
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=1) as r:
                    assert json.load(r) == {"status": "ok"}
                break
            except OSError:
                time.sleep(0.1)
        text = (tmp_path / "server.log").read_text()
        admin = text.split("Generated initial admin API key: ")[1].split()[0]
        req = urllib.request.Request(
            f"{base}/asr/transcribe", method="POST",
            data=json.dumps({"path": str(tmp_path / "in.wav"), "path_type": "Local",
                             "callback_url": f"{base}/callback/http",
                             "language": "en"}).encode(),
            headers={"Authorization": f"Bearer {admin}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            task_id = json.load(r)["body"]
        while True:
            with urllib.request.urlopen(f"{base}/schedule/tasks/{task_id}", timeout=5) as r:
                task = json.load(r)["data"]
            if task["status"] == "Completed":
                break
            assert time.monotonic() < deadline, task
            time.sleep(0.1)
        assert task["result"]["result"]["text"].startswith("seg0-")
        pcm = base64.b64encode((np.ones(16000, np.int16) * 900).tobytes())
        with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as ch:
            call = ch.stream_stream(SERVICE_PATH,
                                    request_serializer=asr_pb2.TranscribeRequest.SerializeToString,
                                    response_deserializer=asr_pb2.TranscribeResponse.FromString)
            responses = list(call(iter([asr_pb2.TranscribeRequest(end=1, audio=pcm)]),
                                  timeout=30))
        assert responses[-1].end == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = (tmp_path / "server.log").read_text()
    assert "shutdown signal received; draining" in text, text
    assert "Traceback" not in text, text


_WITHOUT_SERVER_PACKAGES = r"""
import json, sys, threading, time, http.server
from pathlib import Path

BLOCKED = ("aiohttp", "grpc", "google.protobuf", "requests")


class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is not installed here")
        return None


sys.meta_path.insert(0, Block())
tmp = Path(sys.argv[1])
from speaksense_tpu_torch.asr.fake import FakeAsrEngine
from speaksense_tpu_torch.audio.io import write_wav
from speaksense_tpu_torch.config import Config
from speaksense_tpu_torch.main import build_context
from speaksense_tpu_torch.schedule.types import (
    CallbackType, PathType, TaskConfig, TaskParams, TranscribeParams, TaskType)
from speaksense_tpu_torch.serving import rest

import numpy as np
write_wav(tmp / "clip.wav", 0.3 * np.sin(2 * np.pi * 300 * np.arange(48000) / 16000))
posts = []


class Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = (tmp / "clip.wav").read_bytes()
        self.send_response(200)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        posts.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}"
config = Config(sqlite_path=f"sqlite://{tmp}/db.sqlite", audio_path=str(tmp / "audio"))
ctx, scheduler = build_context(config, FakeAsrEngine())
try:
    task = ctx.task_manager.create_task(TaskConfig(
        task_type=TaskType.TRANSCRIBE, input_path=f"{url}/clip.wav", path_type=PathType.URL,
        callback_type=CallbackType.http(f"{url}/cb"),
        params=TaskParams.transcribe(TranscribeParams(language="en"))))
    deadline = time.monotonic() + 30
    while not posts:
        assert time.monotonic() < deadline, ctx.task_manager.get_task(task.id).to_json()
        time.sleep(0.05)
finally:
    scheduler.stop()
    srv.shutdown()
assert posts[0]["task_id"] == task.id and posts[0]["status"] == "Completed", posts
assert ctx.task_manager.get_task(task.id).status.kind == "Completed"
try:
    rest.build_app(ctx)
    raise AssertionError("the REST app built without aiohttp")
except ImportError:
    pass
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "speaksense_tpu")
                or any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not loaded, loaded
print("ok")
"""


def test_task_path_runs_without_the_server_packages(tmp_path):
    """What `chip_smoke.py --phase serve` drives on the GPU image (which has
    no aiohttp, grpcio, protobuf or requests): build_context and a URL task
    with an HTTP callback, with those packages blocked from import."""
    out = subprocess.run([sys.executable, "-c", _WITHOUT_SERVER_PACKAGES, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
