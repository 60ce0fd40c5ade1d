"""TaskManager: registry, lifecycle, claims, retries, callbacks, sweeps.

The port's own copy of `speaksense_tpu/schedule/manager.py`,
with the same names and behaviour.

Mirror of the reference's src/schedule/scheduler/task_manager.rs:
- processor registry by TaskType (:55-59)
- create_task validates then persists Pending (:61-83)
- get_next_task claims from get_pending_by_priority(10) guarded by an
  in-memory processing map (:85-119)
- retry bookkeeping to max_retries -> Retrying/Failed (:140-159); unlike the
  reference, Retrying tasks ARE re-claimed (the persisted retry_count now
  advances too — both SURVEY.md §7 quirk fixes)
- 30-min stale-claim cleanup (:161-179) and DB timeout sweep (:275-284)
- status/stats/cleanup/priority APIs (:182-224, 287-308)
- callback dispatch by CallbackType (:226-256)
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional

from speaksense_tpu_torch.schedule.callback import (
    EventBus, EventCallback, FunctionCallback, HttpCallback, TaskCallback,
)
from speaksense_tpu_torch.schedule.processors import TaskProcessor
from speaksense_tpu_torch.schedule.types import (
    CallbackType, Task, TaskConfig, TaskPriority, TaskResult, TaskStatus,
    TaskType, utcnow,
)

if TYPE_CHECKING:  # type-only: a runtime import closes the cycle
    # storage.sqlite -> schedule.types (package __init__) -> manager
    from speaksense_tpu_torch.storage.sqlite import SqliteTaskStorage

log = logging.getLogger(__name__)

STALE_CLAIM_SECONDS = 30 * 60  # task_manager.rs:161-179


class TaskStats(dict):
    """Status-kind -> count (task_manager.rs:316-322)."""


class TaskManager:
    def __init__(self, storage: SqliteTaskStorage):
        self.storage = storage
        self.processors: dict[TaskType, TaskProcessor] = {}
        self.functions: dict[str, Callable[[dict], None]] = {}
        self.event_bus = EventBus()
        self._processing: dict[str, float] = {}  # task_id -> claim monotonic time
        self._lock = threading.Lock()
        # usage_hook(api_key, tokens, audio_seconds): completion-time usage
        # accounting (main.py wires Auth.record_usage — fills the
        # total_tokens/total_audio_seconds columns the reference reserves at
        # key_stats_entity.rs:14-15 and never writes)
        self.usage_hook: Optional[Callable[[str, int, float], None]] = None

    # -- registry ------------------------------------------------------------

    def register_processor(self, processor: TaskProcessor) -> None:
        self.processors[processor.task_type] = processor

    def register_function(self, name: str, fn: Callable[[dict], None]) -> None:
        """Target registry for CallbackType::Function."""
        self.functions[name] = fn

    # -- lifecycle -----------------------------------------------------------

    def create_task(self, config: TaskConfig) -> Task:
        processor = self.processors.get(config.task_type)
        if processor is None:
            raise ValueError(f"no processor registered for {config.task_type}")
        processor.validate_params(config)
        task = Task.new(config)
        self.storage.create(task)
        log.info("created task %s (%s)", task.id, config.task_type)
        return task

    def get_next_task(self, task_type: Optional[TaskType] = None) -> Optional[Task]:
        """Claim the highest-priority pending/retrying task not already being
        processed. task_type filters BEFORE claiming — the reference claims
        any type and lets the worker drop mismatches (task_manager.rs:85-119,
        worker.rs:52-54), leaving the task wedged in Processing until the
        stale sweep; filtering here makes multi-processor deployments safe."""
        candidates = self.storage.get_pending_by_priority(
            10, task_type=task_type.value if task_type else None)
        with self._lock:
            for task in candidates:
                if task.id in self._processing:
                    continue
                # atomic CAS in storage: the candidate snapshot is stale by
                # now, and a fast task may have been claimed AND completed
                # by a sibling worker (its _processing entry already popped)
                # — the in-memory guard alone cannot see that
                if not self.storage.claim(task.id):
                    continue
                self._processing[task.id] = time.monotonic()
                task.status = TaskStatus.processing()
                task.started_at = utcnow()
                return task
        return None

    def process_task(self, task: Task) -> TaskResult:
        processor = self.processors.get(task.config.task_type)
        if processor is None:
            raise ValueError(f"no processor for {task.config.task_type}")
        try:
            return processor.process(task)
        finally:
            with self._lock:
                self._processing.pop(task.id, None)

    def complete_task(self, task: Task, result: TaskResult) -> None:
        task.result = result
        task.status = TaskStatus.completed()
        task.completed_at = utcnow()
        task.updated_at = utcnow()
        self.storage.create(task)  # upsert with result (worker.rs:60-65)
        if self.usage_hook is not None and task.config.api_key:
            inner = getattr(result, "result", None)
            tokens = int(getattr(inner, "n_tokens", 0) or 0)
            audio_s = float(getattr(inner, "audio_seconds", 0.0) or 0.0)
            if tokens or audio_s:
                try:
                    self.usage_hook(task.config.api_key, tokens, audio_s)
                except Exception as e:  # accounting must not kill the worker
                    log.error("usage accounting for %s failed: %s", task.id, e)
        try:
            self.handle_callback(task)
        except Exception as e:  # callbacks must not kill the worker
            log.error("callback for task %s failed: %s", task.id, e)

    def handle_task_failure(self, task: Task, error: str) -> None:
        """Retry up to max_retries, then Failed (task_manager.rs:140-159).
        The retry counter is persisted via the config JSON so restarts don't
        reset it (reference only advanced an in-memory copy)."""
        with self._lock:
            self._processing.pop(task.id, None)
        task.config.retry_count += 1
        if task.config.retry_count <= task.config.max_retries:
            task.status = TaskStatus.retrying()
            task.updated_at = utcnow()
            self.storage.create(task)
            log.warning("task %s failed (attempt %d/%d), will retry: %s",
                        task.id, task.config.retry_count, task.config.max_retries, error)
        else:
            task.status = TaskStatus.failed(error)
            task.error = error
            task.updated_at = utcnow()
            self.storage.create(task)
            log.error("task %s permanently failed: %s", task.id, error)
            try:
                cb = self._callback_for(task)
                if cb:
                    cb.on_error(task, error)
            except Exception as e:
                log.error("error callback for %s failed: %s", task.id, e)

    # -- sweeps --------------------------------------------------------------

    def cleanup_stale_claims(self) -> int:
        """Requeue claims older than 30 min so crashed workers don't wedge
        their tasks forever. Persists Retrying (re-claimable) — dropping
        only the in-memory entry would leave the DB row Processing, which
        neither the pending query nor the claim CAS ever touches again
        (the reference has the same wedge,
        task_manager.rs:161-179)."""
        cutoff = time.monotonic() - STALE_CLAIM_SECONDS
        with self._lock:
            stale = [tid for tid, t in self._processing.items() if t < cutoff]
            for tid in stale:
                del self._processing[tid]
        for tid in stale:
            self.storage.update(tid, TaskStatus.retrying())
        return len(stale)

    def recover_orphaned_tasks(self) -> int:
        """Startup recovery: rows stuck in Processing from a previous
        process (no in-memory claim can exist for them) go back to
        Retrying so workers re-claim them. Call BEFORE spawning workers.
        The durable queue otherwise strands them forever: Pending queries
        and the claim CAS both exclude Processing, and the timeout sweep
        needs a non-NULL per-task timeout (REST tasks default to None)."""
        orphans = self.storage.get_by_status(TaskStatus.PROCESSING)
        for task in orphans:
            self.storage.update(task.id, TaskStatus.retrying())
        if orphans:
            log.info("recovered %d orphaned Processing task(s) from a "
                     "previous run", len(orphans))
        return len(orphans)

    def check_timeouts(self) -> int:
        """DB sweep: Processing rows whose started_at + timeout elapsed ->
        TimedOut (task_manager.rs:275-284)."""
        timed_out = self.storage.get_timeouted()
        for task in timed_out:
            self.storage.update(task.id, TaskStatus.timed_out())
            with self._lock:
                self._processing.pop(task.id, None)
        return len(timed_out)

    # -- queries -------------------------------------------------------------

    def get_task(self, task_id: str) -> Optional[Task]:
        return self.storage.get(task_id)

    def get_task_status(self, task_id: str) -> Optional[TaskStatus]:
        task = self.storage.get(task_id)
        return task.status if task else None

    def get_task_stats(self) -> TaskStats:
        return TaskStats(self.storage.count_by_status())

    def cleanup_old_tasks(self, older_than: _dt.timedelta) -> int:
        return self.storage.cleanup_old(utcnow() - older_than)

    def update_task_priority(self, task_id: str, priority: TaskPriority) -> bool:
        """Pending-only (web/handlers/schedule.rs semantics)."""
        task = self.storage.get(task_id)
        if task is None or task.status.kind != TaskStatus.PENDING:
            return False
        self.storage.update_priority(task_id, priority)
        return True

    # -- callbacks -----------------------------------------------------------

    def _callback_for(self, task: Task) -> Optional[TaskCallback]:
        ct = task.config.callback_type
        if ct.kind == CallbackType.HTTP and ct.url:
            return HttpCallback(ct.url)
        if ct.kind == CallbackType.FUNCTION and ct.name:
            fn = self.functions.get(ct.name)
            if fn is None:
                log.warning("no function registered for callback %r", ct.name)
                return None
            return FunctionCallback(fn)
        if ct.kind == CallbackType.EVENT:
            return EventCallback(self.event_bus)
        return None

    def handle_callback(self, task: Task) -> None:
        cb = self._callback_for(task)
        if cb is None or task.result is None:
            return
        cb.on_complete(task, task.result)
