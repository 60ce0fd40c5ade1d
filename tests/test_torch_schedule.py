"""The port's task queue, SQLite stores and API-key auth against the JAX
package's: the same sequence of calls runs through each package's stack,
each on its own SQLite file with its own `FakeAsrEngine`, and the task
states (`to_json()`), claim order, retry and failure transitions, orphan
recovery, stale claims, timeouts, stats, key stats and usage and the rate
limiter's refusals are equal, exactly, once ids and timestamps are replaced
by labels. A database written by one package reads back in the other; URL
inputs are downloaded and HTTP callbacks posted over a loopback server."""

import datetime as dt
import http.server
import importlib
import json
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("speaksense_tpu", "speaksense_tpu_torch")
MODULES = ("asr", "asr.fake", "audio.io", "auth", "auth.types", "schedule.manager",
           "schedule.processors", "schedule.types", "storage.sqlite")


def _pkg(name: str) -> SimpleNamespace:
    """One package's modules of this slice, by short name."""
    return SimpleNamespace(**{m.replace(".", "_"): importlib.import_module(f"{name}.{m}")
                              for m in MODULES})


_TIME = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d")
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def normalize(obj, labels: dict):
    """Replace ids by their labels (other uuids by "<id>") and timestamps by
    "<t>", recursively."""
    if isinstance(obj, dict):
        return {normalize(k, labels): normalize(v, labels) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v, labels) for v in obj]
    if isinstance(obj, str):
        for raw, label in labels.items():
            obj = obj.replace(raw, label)
        return "<t>" if _TIME.match(obj) else _UUID.sub("<id>", obj)
    return obj


class Loopback:
    """A loopback HTTP server: GET serves `files` by path (404 otherwise),
    POST records the JSON body under its path."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.posts: list[tuple[str, dict, str]] = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = outer.files.get(self.path)
                self.send_response(200 if body is not None else 404)
                self.end_headers()
                self.wfile.write(body or b"not found")

            def do_POST(self):
                n = int(self.headers["Content-Length"])
                outer.posts.append((self.path, json.loads(self.rfile.read(n)),
                                    self.headers["Content-Type"]))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(scope="module")
def loopback():
    srv = Loopback()
    yield srv
    srv.close()


def _tone(seconds: float, f0: float = 220.0) -> np.ndarray:
    t = np.arange(int(16000 * seconds)) / 16000
    rng = np.random.default_rng(int(f0))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    return (0.3 * np.sin(2 * np.pi * f0 * t) * env
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _run_sequence(P: SimpleNamespace, tmp, loopback: Loopback) -> list:
    """The scenario, through one package's stack; returns its trace."""
    T = P.schedule_types
    tmp.mkdir()
    wavs = {}
    for i, f0 in enumerate((180.0, 240.0, 300.0)):
        wavs[i] = tmp / f"in{i}.wav"
        P.audio_io.write_wav(wavs[i], _tone(6.0 + 4 * i, f0))
    loopback.files[f"/{tmp.name}/clip.wav"] = wavs[0].read_bytes()
    db = tmp / "db.sqlite"
    tasks = P.storage_sqlite.SqliteTaskStorage(db)
    keys = P.storage_sqlite.SqliteKeyStorage(db)
    auth = P.auth.Auth(keys, keys)
    manager = P.schedule_manager.TaskManager(tasks)
    manager.usage_hook = auth.record_usage
    proc = P.schedule_processors
    manager.register_processor(proc.TranscribeProcessor(P.asr_fake.FakeAsrEngine(),
                                                        audio_dir=str(tmp)))
    manager.register_processor(proc.NoiseReductionProcessor(audio_dir=str(tmp)))
    manager.register_processor(proc.VoiceprintProcessor(audio_dir=str(tmp)))
    trace, labels, events = [], {str(tmp): "<tmp>", tmp.name: "<side>"}, []
    manager.register_function("sink", events.append)

    def label(raw, name):
        labels[raw] = name
        return name

    def state(task_id):
        return manager.get_task(task_id).to_json()

    def transcribe(path, priority="Normal", callback=None, path_type="Local", **params):
        return T.TaskConfig(
            task_type=T.TaskType.TRANSCRIBE, input_path=str(path),
            path_type=T.PathType(path_type),
            callback_type=callback or T.CallbackType.none(),
            params=T.TaskParams.transcribe(T.TranscribeParams(**params)),
            priority=T.TaskPriority(priority))

    try:
        admin = auth.initialize_admin_key()
        label(admin.key, "admin")
        trace.append(("second admin bootstrap", auth.initialize_admin_key()))
        user = auth.create_api_key("svc", [P.auth.Permission.TRANSCRIBE],
                                   P.auth.RateLimit(requests_per_minute=3), expires_in_days=7)
        label(user.key, "user")
        trace.append(("keys", sorted((k.to_json() for k in keys.list()),
                                     key=lambda k: k["name"])))

        # validation refusals
        for bad in (dict(language="de"), dict(path="")):
            try:
                cfg = transcribe(bad.get("path", wavs[0]), language=bad.get("language"))
                manager.create_task(cfg)
            except ValueError as e:
                trace.append(("refused", str(e)))

        # claim order by priority, then creation
        ids = {}
        for name, prio in (("low", "Low"), ("normal", "Normal"), ("critical", "Critical"),
                           ("high", "High"), ("normal2", "Normal")):
            ids[name] = manager.create_task(transcribe(wavs[0], prio, language="en")).id
            label(ids[name], name)
        nr = manager.create_task(T.TaskConfig(
            task_type=T.TaskType.NOISE_REDUCTION, input_path=str(wavs[1]),
            path_type=T.PathType.LOCAL, callback_type=T.CallbackType.function("sink"),
            params=T.TaskParams(T.TaskType.NOISE_REDUCTION, {})))
        label(nr.id, "nr")
        vp = manager.create_task(T.TaskConfig(
            task_type=T.TaskType.VOICEPRINT_RECOGNITION, input_path=str(wavs[1]),
            path_type=T.PathType.LOCAL, callback_type=T.CallbackType.event(),
            params=T.TaskParams(T.TaskType.VOICEPRINT_RECOGNITION,
                                {"compare_with": str(wavs[2]), "threshold": 0.5})))
        label(vp.id, "vp")
        bus = manager.event_bus.subscribe()
        trace.append(("priority of a pending task", manager.update_task_priority(
            ids["low"], T.TaskPriority.HIGH)))
        trace.append(("stats", dict(manager.get_task_stats())))
        order = []
        claimed = {}
        while (task := manager.get_next_task(T.TaskType.TRANSCRIBE)) is not None:
            order.append(labels[task.id])
            claimed[labels[task.id]] = task
        trace.append(("claim order", order))
        trace.append(("claimed again", manager.get_next_task(T.TaskType.TRANSCRIBE)))
        trace.append(("priority of a claimed task", manager.update_task_priority(
            ids["normal"], T.TaskPriority.LOW)))

        # complete one, fail one through its retries
        t = claimed["critical"]
        manager.complete_task(t, manager.process_task(t))
        trace.append(("completed", state(t.id)))
        t = claimed["high"]
        for attempt in range(5):
            manager.handle_task_failure(t, f"boom {attempt}")
            trace.append((f"failure {attempt}", state(t.id)))
            if t.status.kind == "Failed":
                break
            t = manager.get_next_task(T.TaskType.TRANSCRIBE)
            trace.append(("reclaimed", labels[t.id]))

        # the other types, with a function and an event callback
        for tid in (nr.id, vp.id):
            task = manager.get_next_task(manager.get_task(tid).config.task_type)
            manager.complete_task(task, manager.process_task(task))
            trace.append(("completed", state(tid)))
        trace.append(("function callback", events))
        trace.append(("event callback", vars(bus.get(timeout=5))))

        # stale claims go back to Retrying
        t = claimed["normal"]
        manager._processing[t.id] = time.monotonic() - P.schedule_manager.STALE_CLAIM_SECONDS - 1
        trace.append(("stale", manager.cleanup_stale_claims(), state(t.id)))

        # timeouts: a claimed task whose started_at lies past its timeout
        tid = manager.create_task(transcribe(wavs[1], "Critical", language="ja")).id
        label(tid, "slow")
        tasks._conn.execute("UPDATE tasks SET timeout = 5 WHERE id = ?", (tid,))
        tasks._conn.commit()
        t = manager.get_next_task(T.TaskType.TRANSCRIBE)
        trace.append(("claimed for timeout", labels[t.id]))
        tasks._conn.execute("UPDATE tasks SET started_at = ? WHERE id = ?",
                            ("2000-01-01 00:00:00.000000", tid))
        tasks._conn.commit()
        trace.append(("timeouts", manager.check_timeouts(), state(tid)))

        # orphans: rows left in Processing by an earlier process
        tasks.update(ids["low"], T.TaskStatus.processing())
        tasks.update(ids["normal2"], T.TaskStatus.processing())
        fresh = P.schedule_manager.TaskManager(tasks)
        trace.append(("orphans", fresh.recover_orphaned_tasks(), state(ids["low"]),
                      state(ids["normal2"])))

        # a URL input with an HTTP callback, attributed to a key
        cb = T.CallbackType.http(f"{loopback.url}/{tmp.name}/cb")
        cfg = transcribe(f"{loopback.url}/{tmp.name}/clip.wav", callback=cb, path_type="Url",
                         language="zh", filter_dirty_words=True, emotion_recognition=True)
        cfg.api_key = user.key
        tid = manager.create_task(cfg).id
        label(tid, "url")
        while (t := manager.get_next_task(T.TaskType.TRANSCRIBE)).id != tid:
            manager.complete_task(t, manager.process_task(t))
        manager.complete_task(t, manager.process_task(t))
        trace.append(("url task", state(tid), sorted(p.name for p in tmp.iterdir())))
        bad = transcribe(f"{loopback.url}/{tmp.name}/missing.wav", callback=cb, path_type="Url")
        bad.max_retries = 0
        tid = manager.create_task(bad).id
        label(tid, "404")
        t = manager.get_next_task(T.TaskType.TRANSCRIBE)
        try:
            manager.process_task(t)
        except Exception as e:  # the HTTP error of each package's client
            assert "404" in str(e), e
            manager.handle_task_failure(t, "HTTP 404")
        trace.append(("404 task", state(tid)))
        trace.append(("callbacks", [(p, body, ctype) for p, body, ctype in loopback.posts
                                    if p.startswith(f"/{tmp.name}/")]))

        trace.append(("stats", dict(manager.get_task_stats())))
        trace.append(("cleanup", manager.cleanup_old_tasks(dt.timedelta(days=-1)),
                      dict(manager.get_task_stats())))

        # key checks: every refusal kind, then the per-minute limiter
        outcomes = []
        for header, perm in ((None, "Transcribe"), ("Bearer ", "Transcribe"),
                             ("Bearer key-nope", "Transcribe"),
                             (f"Bearer {user.key}", "Admin")):
            try:
                auth.verify_api_key(header, P.auth.Permission(perm))
                outcomes.append("ok")
            except P.auth.AuthError as e:
                outcomes.append(str(e))
        for _ in range(5):
            try:
                auth.verify_api_key(f"Bearer {user.key}", P.auth.Permission.TRANSCRIBE)
                outcomes.append("ok")
            except P.auth.AuthError as e:
                outcomes.append(e.kind)
        trace.append(("verify", outcomes))
        auth.record_usage(user.key, tokens=7, audio_seconds=1.5)
        trace.append(("key stats", auth.get_key_stats(user.key).to_json()))
        report = auth.get_key_usage_report(user.key).to_json()
        trace.append(("usage report", report))
        auth.revoke_api_key(user.key)
        expired = auth.create_api_key("old", [P.auth.Permission.TRANSCRIBE],
                                      P.auth.RateLimit(), expires_in_days=-1)
        label(expired.key, "expired")
        for key in (user.key, expired.key):
            try:
                auth.verify_api_key(f"Bearer {key}", P.auth.Permission.TRANSCRIBE)
            except P.auth.AuthError as e:
                trace.append(("refused key", e.kind))
        try:
            auth.get_key_stats("key-nope")
        except KeyError as e:
            trace.append(("unknown key", str(e)))
    finally:
        tasks.close()
        keys.close()
    return normalize(json.loads(json.dumps(trace, default=repr)), labels)


def test_task_queue_stores_and_auth_match_jax(tmp_path, loopback):
    jax_trace = _run_sequence(_pkg(PACKAGES[0]), tmp_path / "side_reference", loopback)
    port_trace = _run_sequence(_pkg(PACKAGES[1]), tmp_path / "side_port", loopback)
    # the scenario covered what it claims to
    got = dict((step[0], step[1:]) for step in port_trace)
    assert got["claim order"] == [["critical", "low", "high", "normal", "normal2"]]
    assert got["404 task"][0]["status"] == {"Failed": "HTTP 404"}
    assert got["verify"][0][-2:] == ["rate limit exceeded"] * 2
    assert got["key stats"][0]["total_audio_seconds"] == pytest.approx(6.0 + 1.5)
    assert len(got["callbacks"][0]) == 2
    for want, have in zip(jax_trace, port_trace):
        assert have == want, want[0]
    assert len(port_trace) == len(jax_trace)


@pytest.mark.parametrize("writer", PACKAGES)
def test_database_reads_back_in_the_other_package(tmp_path, writer):
    """Rows written by one package's stores read back equal in the other's."""
    W, R = _pkg(writer), _pkg(PACKAGES[1 - PACKAGES.index(writer)])
    db = tmp_path / "db.sqlite"
    T = W.schedule_types
    tasks, keys = W.storage_sqlite.SqliteTaskStorage(db), W.storage_sqlite.SqliteKeyStorage(db)
    try:
        auth = W.auth.Auth(keys, keys)
        key = auth.create_api_key("svc", [W.auth.Permission.TRANSCRIBE],
                                  W.auth.RateLimit(requests_per_minute=5), expires_in_days=3)
        auth.verify_api_key(f"Bearer {key.key}", W.auth.Permission.TRANSCRIBE)
        auth.record_usage(key.key, tokens=4, audio_seconds=2.25)
        cfg = T.TaskConfig(task_type=T.TaskType.TRANSCRIBE, input_path="a.wav",
                           path_type=T.PathType.LOCAL,
                           callback_type=T.CallbackType.http("http://127.0.0.1:9/cb"),
                           params=T.TaskParams.transcribe(T.TranscribeParams(language="en")),
                           priority=T.TaskPriority.HIGH, timeout=30, api_key=key.key)
        done, failed = T.Task.new(cfg), T.Task.new(cfg)
        done.status, done.result = T.TaskStatus.completed(), T.TaskResult.transcribe(
            T.TranscribeTaskResult(text="hi", segments=[T.ResultSegment("hi", None, 0.0, 1.5,
                                                                        "calm")],
                                   n_tokens=3, audio_seconds=1.5))
        tasks.create(done)
        tasks.create(failed)
        tasks.update(failed.id, T.TaskStatus.failed("bad input"))
        written = ([t.to_json() for t in tasks.list(1, 10)], key.to_json(),
                   auth.get_key_stats(key.key).to_json())
    finally:
        tasks.close()
        keys.close()
    tasks, keys = R.storage_sqlite.SqliteTaskStorage(db), R.storage_sqlite.SqliteKeyStorage(db)
    try:
        auth = R.auth.Auth(keys, keys)
        read = ([t.to_json() for t in tasks.list(1, 10)], keys.get(key.key).to_json(),
                auth.get_key_stats(key.key).to_json())
        assert read == written
        assert tasks.count_by_status() == {"Completed": 1, "Failed": 1}
        assert [t.id for t in tasks.get_by_status("Failed")] == [failed.id]
    finally:
        tasks.close()
        keys.close()


def test_fake_engine_and_rate_limiter_match_jax():
    """The fake engine's content-hash transcripts are byte-equal, and the
    limiters refuse at the same counts over a moving window."""
    J, P = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])
    audio = _tone(12.3)
    for params in (dict(), dict(language="ja"), dict(stream_mode=True)):
        want = J.asr_fake.FakeAsrEngine().transcribe(audio, J.asr.AsrParams(**params))
        got = P.asr_fake.FakeAsrEngine().transcribe(audio, P.asr.AsrParams(**params))
        assert [s.to_dict() for s in got.segments] == [s.to_dict() for s in want.segments]
        assert (got.full_text, got.language, got.n_tokens) == (
            want.full_text, want.language, want.n_tokens)
    pcm = (audio * 32767).astype(np.int16)
    assert (P.asr_fake.FakeAsrEngine().transcribe(pcm, P.asr.AsrParams()).full_text
            == J.asr_fake.FakeAsrEngine().transcribe(pcm, J.asr.AsrParams()).full_text)
    jrl = importlib.import_module("speaksense_tpu.auth.ratelimit")
    prl = importlib.import_module("speaksense_tpu_torch.auth.ratelimit")
    times = [0.0, 1.0, 2.0, 30.0, 59.9, 60.0, 60.5, 61.0, 120.0, 121.0, 121.5]
    for limit in (0, 1, 3):
        j, p = jrl.MinuteRateLimiter(limit), prl.MinuteRateLimiter(limit)
        assert [p.check(now=t) for t in times] == [j.check(now=t) for t in times]
    jm, pm = jrl.RateLimiterMap(max_keys=2), prl.RateLimiterMap(max_keys=2)
    calls = [("a", 2), ("a", 2), ("a", 2), ("b", 1), ("c", 1), ("a", 3), ("a", 3), ("b", 1)]
    assert [pm.check(*c) for c in calls] == [jm.check(*c) for c in calls]
