"""Durable storage interfaces (reference src/storage/).

The port's own copy of `speaksense_tpu/storage/__init__.py`,
with the same names and behaviour.

TaskStorage (9 methods — the reference's src/storage/task/mod.rs:11-21),
KeyStorage (the reference's src/storage/key/mod.rs:20-26) and
ApiKeyStatsStorage (:30-33), with SQLite implementations sharing the
reference's table DDL so an existing storage.db keeps working.
"""

from __future__ import annotations

import abc
import datetime as _dt
import threading as _threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # avoid a schedule<->storage import cycle at runtime
    from speaksense_tpu_torch.schedule.types import Task


def _processing_status():
    from speaksense_tpu_torch.schedule.types import TaskStatus

    return TaskStatus.processing()


class TaskStorage(abc.ABC):
    @abc.abstractmethod
    def create(self, task: "Task") -> None: ...

    @abc.abstractmethod
    def list(self, index: int, size: int) -> "list[Task]": ...

    @abc.abstractmethod
    def get_pending_by_priority(self, limit: int,
                                task_type: "str | None" = None) -> "list[Task]": ...

    @abc.abstractmethod
    def count_by_status(self) -> "dict[str, int]": ...

    @abc.abstractmethod
    def get(self, task_id: str) -> "Optional[Task]": ...

    @abc.abstractmethod
    def update(self, task_id: str, status) -> None: ...

    def claim(self, task_id: str) -> bool:
        """Atomically transition task_id Pending/Retrying -> Processing;
        False if it was already taken. The in-memory guard alone is not
        enough under concurrent same-type workers: a candidate snapshot can
        go claim->process->complete (guard entry popped) while another
        worker still holds the stale Pending row. Default is the
        unconditional update (single-worker semantics); atomic backends
        override."""
        self.update(task_id, _processing_status())
        return True

    @abc.abstractmethod
    def delete(self, task_id: str) -> None: ...

    @abc.abstractmethod
    def get_timeouted(self) -> "list[Task]": ...

    @abc.abstractmethod
    def cleanup_old(self, before: _dt.datetime) -> int: ...

    @abc.abstractmethod
    def get_by_status(self, status_kind: str) -> "list[Task]": ...


class KeyStorage(abc.ABC):
    @abc.abstractmethod
    def get(self, api_key: str): ...

    @abc.abstractmethod
    def create(self, api_key: str, info) -> None: ...

    @abc.abstractmethod
    def remove(self, api_key: str) -> None: ...

    @abc.abstractmethod
    def list(self): ...

    @abc.abstractmethod
    def update_status(self, api_key: str, status) -> None: ...


class ApiKeyStatsStorage(abc.ABC):
    # serializes the default read-modify-write helpers below: without it,
    # two threads (gRPC stream end + REST verify) interleave get_stats ->
    # mutate -> update_stats and one increment is silently lost. Class-level
    # (shared across instances) is deliberate: these defaults are the
    # non-hot fallback — the SQL backend overrides both with single-UPDATE
    # increments that rely on its own connection lock instead.
    _rmw_lock = _threading.Lock()

    @abc.abstractmethod
    def get_stats(self, api_key: str): ...

    @abc.abstractmethod
    def update_stats(self, api_key: str, stats) -> None: ...

    def bump_stats(self, api_key: str) -> None:
        """Record one request NOW — the auth hot path (every verified call,
        auth/service.py). Default is the reference's read-modify-write
        shape (service.rs:124-132); SQL backends override with an
        increment-style fast path so a counter bump doesn't re-read and
        rewrite the whole 30-day history per request."""
        from speaksense_tpu_torch.auth.types import ApiKeyStats

        with self._rmw_lock:
            stats = self.get_stats(api_key) or ApiKeyStats()
            stats.update()
            self.update_stats(api_key, stats)

    def add_usage(self, api_key: str, tokens: int = 0,
                  audio_seconds: float = 0.0) -> None:
        """Accumulate served-work counters (total_tokens /
        total_audio_seconds — the columns the reference reserves at
        key_stats_entity.rs:14-15 and never fills). SQL backends override
        with a single increment UPDATE."""
        from speaksense_tpu_torch.auth.types import ApiKeyStats

        with self._rmw_lock:
            stats = self.get_stats(api_key) or ApiKeyStats()
            stats.total_tokens += int(tokens)
            stats.total_audio_seconds += float(audio_seconds)
            self.update_stats(api_key, stats)
