"""SQLite task/key storage (stdlib sqlite3; reference uses SeaORM+sqlx).

The port's own copy of `speaksense_tpu/storage/sqlite.py`,
with the same names and behaviour.

Table DDL is identical to the reference so an existing storage.db drops in:
- tasks (the reference's src/storage/task/sqlite.rs:32-52)
- api_keys + api_key_stats (the reference's src/storage/key/sqlite.rs:29-61)

Storage formats match SeaORM's: status/config/result/permissions/rate_limit
as JSON TEXT ('"Pending"', '{"Failed": "..."}'), priority/retries
denormalized, datetimes as UTC text (SQLite strftime-parsable, which the
timeout sweep query relies on — task/sqlite.rs:136-160).

Deliberate fix over the reference (SURVEY.md §7 quirks): status strings are
JSON-encoded consistently on both write and query, and the claim query also
picks up Retrying tasks — in the reference, a Retrying task was never re-run
because claims filtered on Pending only.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import sqlite3
import threading
from pathlib import Path
from typing import Optional

from speaksense_tpu_torch.auth.types import ApiKeyInfo, ApiKeyStats, KeyStatus
from speaksense_tpu_torch.schedule.types import (
    Task, TaskConfig, TaskResult, TaskStatus, TaskPriority, dt_from_json,
)
from speaksense_tpu_torch.storage import ApiKeyStatsStorage, KeyStorage, TaskStorage

log = logging.getLogger(__name__)

_TASKS_DDL = """
CREATE TABLE IF NOT EXISTS tasks (
    id TEXT PRIMARY KEY NOT NULL,
    status TEXT NOT NULL,
    config TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    started_at TEXT,
    completed_at TEXT,
    result TEXT,
    error TEXT,
    priority INTEGER NOT NULL,
    retry_count INTEGER NOT NULL,
    max_retries INTEGER NOT NULL,
    timeout INTEGER
)
"""

_KEYS_DDL = """
CREATE TABLE IF NOT EXISTS api_keys (
    key TEXT PRIMARY KEY NOT NULL,
    name TEXT NOT NULL,
    created_at TEXT NOT NULL,
    expires_at TEXT,
    permissions TEXT NOT NULL,
    rate_limit TEXT NOT NULL,
    status TEXT NOT NULL
)
"""

_KEY_STATS_DDL = """
CREATE TABLE IF NOT EXISTS api_key_stats (
    key TEXT PRIMARY KEY NOT NULL,
    requests_today INTEGER NOT NULL DEFAULT 0,
    requests_this_hour INTEGER NOT NULL DEFAULT 0,
    requests_this_minute INTEGER NOT NULL DEFAULT 0,
    last_request_at TEXT,
    total_requests INTEGER NOT NULL DEFAULT 0,
    total_tokens INTEGER NOT NULL DEFAULT 0,
    total_audio_seconds INTEGER NOT NULL DEFAULT 0,
    updated_at TEXT NOT NULL
)
"""

# Side table for the 30-day per-day request history. The reference keeps
# this map only in memory (auth/stats.rs:38-49) and loses it on every DB
# round-trip — its Model->ApiKeyStats conversion rebuilds the map from
# today's counter alone (key/mod.rs:92-104), so GET /usage returns one day.
# A separate table keeps api_key_stats DDL byte-identical (drop-in DB
# compat) while making the history durable.
_KEY_DAILY_DDL = """
CREATE TABLE IF NOT EXISTS api_key_daily_usage (
    key TEXT NOT NULL,
    date TEXT NOT NULL,
    requests INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (key, date)
)
"""


def _dt_to_db(dt: _dt.datetime | None) -> str | None:
    if dt is None:
        return None
    return dt.astimezone(_dt.timezone.utc).strftime("%Y-%m-%d %H:%M:%S.%f")


def _dt_from_db(s: str | None) -> _dt.datetime | None:
    if not s:
        return None
    s = s.replace("T", " ").replace("Z", "+00:00")
    dt = _dt.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt


def _status_db(status: TaskStatus) -> str:
    return json.dumps(status.to_json(), ensure_ascii=False)


class _SqliteBase:
    def __init__(self, path: str | Path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA busy_timeout=5000")
        self._lock = threading.RLock()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class SqliteTaskStorage(_SqliteBase, TaskStorage):
    def __init__(self, path: str | Path):
        super().__init__(path)
        with self._lock:
            self._conn.execute(_TASKS_DDL)
            self._conn.commit()

    # -- row mapping ---------------------------------------------------------

    @staticmethod
    def _to_row(task: Task) -> tuple:
        return (
            task.id,
            _status_db(task.status),
            json.dumps(task.config.to_json(), ensure_ascii=False),
            _dt_to_db(task.created_at),
            _dt_to_db(task.updated_at),
            _dt_to_db(task.started_at),
            _dt_to_db(task.completed_at),
            json.dumps(task.result.to_json(), ensure_ascii=False) if task.result else None,
            task.error,
            task.config.priority.ordinal,
            task.config.retry_count,
            task.config.max_retries,
            task.config.timeout,
        )

    @staticmethod
    def _from_row(row: tuple) -> Task:
        (tid, status, config, created, updated, started, completed,
         result, error, priority, retry_count, max_retries, timeout) = row
        cfg = TaskConfig.from_json(json.loads(config))
        cfg.priority = TaskPriority.from_ordinal(int(priority))
        cfg.retry_count = int(retry_count)
        cfg.max_retries = int(max_retries)
        cfg.timeout = timeout
        return Task(
            id=tid,
            status=TaskStatus.from_json(json.loads(status)),
            config=cfg,
            created_at=_dt_from_db(created),
            updated_at=_dt_from_db(updated),
            started_at=_dt_from_db(started),
            completed_at=_dt_from_db(completed),
            result=TaskResult.from_json(json.loads(result)) if result else None,
            error=error,
        )

    _COLS = ("id, status, config, created_at, updated_at, started_at, "
             "completed_at, result, error, priority, retry_count, max_retries, timeout")

    # -- TaskStorage ---------------------------------------------------------

    def create(self, task: Task) -> None:
        """Upsert on id (reference create is insert-or-update, sqlite.rs:60-78)."""
        row = self._to_row(task)
        with self._lock:
            self._conn.execute(
                f"INSERT INTO tasks ({self._COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?) "
                "ON CONFLICT(id) DO UPDATE SET status=excluded.status, "
                "updated_at=excluded.updated_at, started_at=excluded.started_at, "
                "completed_at=excluded.completed_at, result=excluded.result, "
                "error=excluded.error, retry_count=excluded.retry_count",
                row)
            self._conn.commit()

    def list(self, index: int = 1, size: int = 20) -> list[Task]:
        index, size = max(index, 1), min(max(size, 1), 100)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM tasks ORDER BY created_at ASC LIMIT ? OFFSET ?",
                (size, (index - 1) * size)).fetchall()
        return [self._from_row(r) for r in rows]

    def get_pending_by_priority(self, limit: int,
                                task_type: Optional[str] = None) -> list[Task]:
        """Pending/Retrying tasks by priority; task_type (a TaskType value
        string) filters in SQL so one type's backlog can't shadow another's
        within the LIMIT window (the reference claims any type and lets the
        worker drop mismatches — task_manager.rs:85-119 + worker.rs:52-54 —
        which wedges the claimed task; we filter before claiming)."""
        pending = _status_db(TaskStatus.pending())
        retrying = _status_db(TaskStatus.retrying())
        sql = (f"SELECT {self._COLS} FROM tasks WHERE status IN (?, ?) ")
        args: list = [pending, retrying]
        if task_type is not None:
            sql += "AND json_extract(config, '$.task_type') = ? "
            args.append(task_type)
        sql += "ORDER BY priority ASC, created_at ASC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        return [self._from_row(r) for r in rows]

    def get(self, task_id: str) -> Optional[Task]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {self._COLS} FROM tasks WHERE id = ?", (task_id,)).fetchone()
        return self._from_row(row) if row else None

    def update(self, task_id: str, status: TaskStatus) -> None:
        """Status transition; stamps started_at on Processing and completed_at
        on Completed (sqlite.rs:110-127)."""
        now = _dt_to_db(_dt.datetime.now(_dt.timezone.utc))
        sets = ["status = ?", "updated_at = ?"]
        args: list = [_status_db(status), now]
        if status.kind == TaskStatus.PROCESSING:
            sets.append("started_at = ?")
            args.append(now)
        if status.kind == TaskStatus.COMPLETED:
            sets.append("completed_at = ?")
            args.append(now)
        if status.kind == TaskStatus.FAILED:
            sets.append("error = ?")
            args.append(status.error)
        args.append(task_id)
        with self._lock:
            self._conn.execute(f"UPDATE tasks SET {', '.join(sets)} WHERE id = ?", args)
            self._conn.commit()

    def claim(self, task_id: str) -> bool:
        """Atomic Pending/Retrying -> Processing CAS (see TaskStorage.claim):
        the WHERE status guard makes concurrent same-type workers safe — the
        loser's UPDATE matches zero rows and it moves to the next candidate."""
        now = _dt_to_db(_dt.datetime.now(_dt.timezone.utc))
        with self._lock:
            cur = self._conn.execute(
                "UPDATE tasks SET status = ?, updated_at = ?, started_at = ? "
                "WHERE id = ? AND status IN (?, ?)",
                (_status_db(TaskStatus.processing()), now, now, task_id,
                 _status_db(TaskStatus.pending()),
                 _status_db(TaskStatus.retrying())))
            self._conn.commit()
        return cur.rowcount > 0

    def set_result(self, task_id: str, result: TaskResult) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE tasks SET result = ?, updated_at = ? WHERE id = ?",
                (json.dumps(result.to_json(), ensure_ascii=False),
                 _dt_to_db(_dt.datetime.now(_dt.timezone.utc)), task_id))
            self._conn.commit()

    def update_priority(self, task_id: str, priority: TaskPriority) -> None:
        """Persists the denormalized priority column AND the config JSON —
        the reference's upsert forgot the config column (SURVEY.md §7 quirks,
        sqlite.rs:64-73)."""
        with self._lock:
            row = self._conn.execute("SELECT config FROM tasks WHERE id = ?",
                                     (task_id,)).fetchone()
            if not row:
                return
            cfg = json.loads(row[0])
            cfg["priority"] = priority.value
            self._conn.execute(
                "UPDATE tasks SET priority = ?, config = ?, updated_at = ? WHERE id = ?",
                (priority.ordinal, json.dumps(cfg, ensure_ascii=False),
                 _dt_to_db(_dt.datetime.now(_dt.timezone.utc)), task_id))
            self._conn.commit()

    def delete(self, task_id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM tasks WHERE id = ?", (task_id,))
            self._conn.commit()

    def get_timeouted(self) -> list[Task]:
        processing = _status_db(TaskStatus.processing())
        now = int(_dt.datetime.now(_dt.timezone.utc).timestamp())
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM tasks WHERE status = ? "
                "AND started_at IS NOT NULL AND timeout IS NOT NULL "
                "AND (strftime('%s', started_at) + timeout) < ?",
                (processing, now)).fetchall()
        return [self._from_row(r) for r in rows]

    def cleanup_old(self, before: _dt.datetime) -> int:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM tasks WHERE (status LIKE '%Completed%' OR status LIKE '%Failed%') "
                "AND updated_at < ?", (_dt_to_db(before),))
            self._conn.commit()
        return cur.rowcount

    def get_by_status(self, status_kind: str) -> list[Task]:
        if status_kind == TaskStatus.FAILED:
            # Failed rows embed the error message ({"Failed": "<msg>"}) so
            # an equality match against the empty-message form never hits;
            # match the tagged-enum prefix instead
            where, arg = "status LIKE ?", '{"Failed":%'
        else:
            where, arg = "status = ?", _status_db(TaskStatus(status_kind))
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM tasks WHERE {where} "
                # ascending ordinal = Critical first (types.py convention,
                # same as get_pending_by_priority)
                "ORDER BY priority ASC, created_at ASC", (arg,)).fetchall()
        return [self._from_row(r) for r in rows]

    def count_by_status(self) -> dict[str, int]:
        """Aggregate counts for /schedule/tasks/stats."""
        with self._lock:
            rows = self._conn.execute("SELECT status, COUNT(*) FROM tasks GROUP BY status").fetchall()
        out: dict[str, int] = {}
        for status_json, n in rows:
            kind = TaskStatus.from_json(json.loads(status_json)).kind
            out[kind] = out.get(kind, 0) + n
        return out


class SqliteKeyStorage(_SqliteBase, KeyStorage, ApiKeyStatsStorage):
    """api_keys + api_key_stats on one connection (reference opens a second
    connection to the same file, key/sqlite.rs:20)."""

    def __init__(self, path: str | Path):
        super().__init__(path)
        with self._lock:
            self._conn.execute(_KEYS_DDL)
            self._conn.execute(_KEY_STATS_DDL)
            self._conn.execute(_KEY_DAILY_DDL)
            self._conn.commit()

    # -- KeyStorage ----------------------------------------------------------

    def get(self, api_key: str) -> Optional[ApiKeyInfo]:
        with self._lock:
            row = self._conn.execute(
                "SELECT key, name, created_at, expires_at, permissions, rate_limit, status "
                "FROM api_keys WHERE key = ?", (api_key,)).fetchone()
        return self._key_from_row(row) if row else None

    @staticmethod
    def _key_from_row(row: tuple) -> ApiKeyInfo:
        key, name, created, expires, permissions, rate_limit, status = row
        from speaksense_tpu_torch.auth.types import Permission, RateLimit

        return ApiKeyInfo(
            key=key, name=name,
            created_at=_dt_from_db(created),
            expires_at=_dt_from_db(expires),
            permissions=[Permission(p) for p in json.loads(permissions or "[]")],
            rate_limit=RateLimit.from_json(json.loads(rate_limit or "{}")),
            status=KeyStatus(json.loads(status)) if status else KeyStatus.EXPIRED,
        )

    def create(self, api_key: str, info: ApiKeyInfo) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO api_keys "
                "(key, name, created_at, expires_at, permissions, rate_limit, status) "
                "VALUES (?,?,?,?,?,?,?)",
                (api_key, info.name, _dt_to_db(info.created_at), _dt_to_db(info.expires_at),
                 json.dumps([p.value for p in info.permissions]),
                 json.dumps(info.rate_limit.to_json()),
                 json.dumps(info.status.value)))
            self._conn.commit()

    def remove(self, api_key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM api_keys WHERE key = ?", (api_key,))
            self._conn.execute("DELETE FROM api_key_stats WHERE key = ?", (api_key,))
            self._conn.execute("DELETE FROM api_key_daily_usage WHERE key = ?", (api_key,))
            self._conn.commit()

    def list(self) -> list[ApiKeyInfo]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, name, created_at, expires_at, permissions, rate_limit, status "
                "FROM api_keys").fetchall()
        return [self._key_from_row(r) for r in rows]

    def update_status(self, api_key: str, status: KeyStatus) -> None:
        with self._lock:
            self._conn.execute("UPDATE api_keys SET status = ? WHERE key = ?",
                               (json.dumps(status.value), api_key))
            self._conn.commit()

    # -- ApiKeyStatsStorage --------------------------------------------------

    def get_stats(self, api_key: str) -> Optional[ApiKeyStats]:
        with self._lock:
            row = self._conn.execute(
                "SELECT requests_today, last_request_at, total_requests, "
                "total_tokens, total_audio_seconds "
                "FROM api_key_stats WHERE key = ?", (api_key,)).fetchone()
        if not row:
            return None
        today_count, last, total, total_tokens, total_audio = row
        today = _dt.datetime.now(_dt.timezone.utc).date().isoformat()
        with self._lock:
            daily = self._conn.execute(
                "SELECT date, requests FROM api_key_daily_usage WHERE key = ? "
                "ORDER BY date", (api_key,)).fetchall()
        if daily:
            per_day = {d: int(n) for d, n in daily}
            today_count = per_day.get(today, 0)
        else:  # pre-history DBs: reference behavior (key/mod.rs:92-104)
            per_day = {today: int(today_count)}
        stats = ApiKeyStats(total_requests=int(total),
                            requests_today=int(today_count),
                            total_tokens=int(total_tokens or 0),
                            total_audio_seconds=float(total_audio or 0.0))
        if last:
            stats.last_used_at = _dt_from_db(last)
        stats.requests_per_day = per_day
        return stats

    def update_stats(self, api_key: str, stats: ApiKeyStats) -> None:
        now_dt = _dt.datetime.now(_dt.timezone.utc)
        now = _dt_to_db(now_dt)
        cutoff = (now_dt - _dt.timedelta(days=30)).date().isoformat()
        with self._lock:
            self._conn.execute(
                "INSERT INTO api_key_stats (key, requests_today, requests_this_hour, "
                "requests_this_minute, last_request_at, total_requests, total_tokens, "
                "total_audio_seconds, updated_at) VALUES (?,?,0,0,?,?,?,?,?) "
                # total_tokens/total_audio_seconds are ADDITIVE-ONLY here:
                # they advance via add_usage's increment UPDATE, and a
                # snapshot write-back would clobber increments accumulated
                # since the caller's get_stats (concurrent streams ending
                # while a bump_stats-style RMW is in flight)
                "ON CONFLICT(key) DO UPDATE SET requests_today=excluded.requests_today, "
                "last_request_at=excluded.last_request_at, "
                "total_requests=excluded.total_requests, "
                "updated_at=excluded.updated_at",
                (api_key, stats.requests_today, _dt_to_db(stats.last_used_at),
                 stats.total_requests, int(stats.total_tokens),
                 float(stats.total_audio_seconds), now))
            # durable 30-day history (pruned like ApiKeyStats.update,
            # auth/stats.rs:46-48)
            for date, n in stats.requests_per_day.items():
                if date >= cutoff:
                    self._conn.execute(
                        "INSERT INTO api_key_daily_usage (key, date, requests) "
                        "VALUES (?,?,?) ON CONFLICT(key, date) DO UPDATE SET "
                        "requests=excluded.requests", (api_key, date, int(n)))
            self._conn.execute(
                "DELETE FROM api_key_daily_usage WHERE key = ? AND date < ?",
                (api_key, cutoff))
            self._conn.commit()

    def bump_stats(self, api_key: str) -> None:
        """Auth hot path override (see ApiKeyStatsStorage.bump_stats): one
        increment upsert on today's daily row + one counter-row upsert,
        instead of reading and rewriting the whole 30-day history per
        request. Pruning runs only on date rollover."""
        now_dt = _dt.datetime.now(_dt.timezone.utc)
        now = _dt_to_db(now_dt)
        today = now_dt.date().isoformat()
        cutoff = (now_dt - _dt.timedelta(days=30)).date().isoformat()
        with self._lock:
            self._conn.execute(
                "INSERT INTO api_key_daily_usage (key, date, requests) "
                "VALUES (?,?,1) ON CONFLICT(key, date) DO UPDATE SET "
                "requests = requests + 1", (api_key, today))
            (today_n,) = self._conn.execute(
                "SELECT requests FROM api_key_daily_usage WHERE key = ? AND "
                "date = ?", (api_key, today)).fetchone()
            rollover = today_n == 1  # first request of a new day
            self._conn.execute(
                "INSERT INTO api_key_stats (key, requests_today, "
                "requests_this_hour, requests_this_minute, last_request_at, "
                "total_requests, total_tokens, total_audio_seconds, "
                "updated_at) VALUES (?,?,0,0,?,1,0,0,?) "
                "ON CONFLICT(key) DO UPDATE SET "
                "requests_today = excluded.requests_today, "
                "last_request_at = excluded.last_request_at, "
                "total_requests = total_requests + 1, "
                "updated_at = excluded.updated_at",
                (api_key, int(today_n), now, now))
            if rollover:
                self._conn.execute(
                    "DELETE FROM api_key_daily_usage WHERE key = ? AND date < ?",
                    (api_key, cutoff))
            self._conn.commit()

    def add_usage(self, api_key: str, tokens: int = 0,
                  audio_seconds: float = 0.0) -> None:
        """Served-work accounting fast path: one increment upsert on the
        stats row (total_tokens / total_audio_seconds, the columns the
        reference reserves at key_stats_entity.rs:14-15 and never fills)."""
        now = _dt_to_db(_dt.datetime.now(_dt.timezone.utc))
        with self._lock:
            self._conn.execute(
                "INSERT INTO api_key_stats (key, requests_today, "
                "requests_this_hour, requests_this_minute, last_request_at, "
                "total_requests, total_tokens, total_audio_seconds, "
                "updated_at) VALUES (?,0,0,0,?,0,?,?,?) "
                "ON CONFLICT(key) DO UPDATE SET "
                "total_tokens = total_tokens + excluded.total_tokens, "
                "total_audio_seconds = total_audio_seconds + "
                "excluded.total_audio_seconds, "
                "updated_at = excluded.updated_at",
                (api_key, now, int(tokens), float(audio_seconds), now))
            self._conn.commit()
