"""TaskScheduler + TaskWorker threads.

The port's own copy of `speaksense_tpu/schedule/scheduler.py`,
with the same names and behaviour.

Mirror of the reference's src/schedule/scheduler/mod.rs + worker.rs: one
worker thread per TaskType polling at 1 s (claim -> process -> persist result
-> callback), plus a 60 s timeout-sweep loop. The reference's worker marked
failures Failed directly, bypassing the retry machinery (worker.rs:77-83);
ours routes failures through TaskManager.handle_task_failure so retries work.
"""

from __future__ import annotations

import logging
import threading
import time

from speaksense_tpu_torch.schedule.manager import TaskManager
from speaksense_tpu_torch.schedule.types import TaskType

log = logging.getLogger(__name__)


class TaskWorker:
    def __init__(self, manager: TaskManager, task_type: TaskType,
                 poll_interval: float = 1.0):
        self.manager = manager
        self.task_type = task_type
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"task-worker-{self.task_type}", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout)

    def _run(self) -> None:
        log.info("worker for %s started", self.task_type)
        while not self._stop.is_set():
            try:
                if not self._process_next():
                    self._stop.wait(self.poll_interval)
            except Exception as e:
                log.error("worker error: %s", e, exc_info=True)
                self._stop.wait(0.1)

    def _process_next(self) -> bool:
        task = self.manager.get_next_task(self.task_type)
        if task is None:
            return False
        log.info("processing %s task %s", self.task_type, task.id)
        try:
            result = self.manager.process_task(task)
        except Exception as e:
            self.manager.handle_task_failure(task, str(e))
            return True
        self.manager.complete_task(task, result)
        return True


class TaskScheduler:
    def __init__(self, manager: TaskManager, sweep_interval: float = 60.0):
        self.manager = manager
        self.sweep_interval = sweep_interval
        self.workers: list[TaskWorker] = []
        self._stop = threading.Event()
        self._sweeper: threading.Thread | None = None

    def spawn_worker(self, task_type: TaskType, poll_interval: float = 1.0) -> TaskWorker:
        worker = TaskWorker(self.manager, task_type, poll_interval)
        self.workers.append(worker)
        worker.start()
        return worker

    def run(self) -> None:
        """Start the timeout/stale sweep loop (scheduler/mod.rs:34-44)."""
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         name="task-sweeper", daemon=True)
        self._sweeper.start()

    def _sweep_loop(self) -> None:
        while not self._stop.is_set():
            try:
                n_timeout = self.manager.check_timeouts()
                n_stale = self.manager.cleanup_stale_claims()
                if n_timeout or n_stale:
                    log.info("sweep: %d timed out, %d stale claims", n_timeout, n_stale)
            except Exception as e:
                log.error("sweep error: %s", e)
            self._stop.wait(self.sweep_interval)

    def stop(self) -> None:
        self._stop.set()
        for w in self.workers:
            w.stop()
        if self._sweeper:
            self._sweeper.join(5.0)


def create_scheduler(manager: TaskManager,
                     task_types: list[TaskType] | None = None,
                     workers: dict[TaskType, int] | None = None) -> TaskScheduler:
    """Helper mirroring schedule/mod.rs:22-33.

    workers: per-type worker count (default 1, the reference's model). The
    reference is capped at one worker per type because each whisper.cpp call
    owns the backend; here N Transcribe workers' windows coalesce in the
    shared BatchedEngine, so parallel claims raise batch occupancy — typed
    SQL claims (manager.get_next_task) make concurrent workers safe."""
    scheduler = TaskScheduler(manager)
    for t in task_types or [TaskType.TRANSCRIBE]:
        for _ in range(max(1, (workers or {}).get(t, 1))):
            scheduler.spawn_worker(t)
    scheduler.run()
    return scheduler
