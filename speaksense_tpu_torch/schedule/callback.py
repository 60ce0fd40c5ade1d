"""Task callbacks (mirror the reference's src/schedule/callback/mod.rs).

The port's own copy of `speaksense_tpu/schedule/callback.py`,
with the same names and behaviour.

TaskCallback interface (on_status_change / on_complete / on_error), with:
- HttpCallback: POST {task_id, status, data} JSON (status serde-encoded, so
  "Completed" or {"Failed": "..."}; data = TaskResult JSON on complete);
- FunctionCallback: wraps a host-registered callable;
- EventCallback: in-process pub/sub. The reference's EventCallback cloned
  into a *fresh* channel so original subscribers never saw events
  (SURVEY.md §2 'Callbacks' quirk); this EventBus shares one subscriber list.
"""

from __future__ import annotations

import abc
import json
import logging
import queue
import threading
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable

from speaksense_tpu_torch.schedule.types import Task, TaskResult, TaskStatus
from speaksense_tpu_torch.utils.http import urlopen

log = logging.getLogger(__name__)


class TaskCallback(abc.ABC):
    @abc.abstractmethod
    def on_status_change(self, task: Task, status: TaskStatus) -> None: ...

    @abc.abstractmethod
    def on_complete(self, task: Task, result: TaskResult) -> None: ...

    @abc.abstractmethod
    def on_error(self, task: Task, error: str) -> None: ...


class HttpCallback(TaskCallback):
    def __init__(self, callback_url: str, timeout: float = 30.0):
        self.callback_url = callback_url
        self.timeout = timeout

    def _send(self, payload: dict) -> None:
        """POST the payload as JSON, as `requests.post(url, json=payload)`
        does in the JAX package (same body and Content-Type); a status of
        400 or more raises."""
        log.info("sending callback to %s", self.callback_url)
        req = urllib.request.Request(
            self.callback_url, data=json.dumps(payload, allow_nan=False).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        with urlopen(req, self.timeout):
            pass

    def on_status_change(self, task: Task, status: TaskStatus) -> None:
        self._send({"task_id": task.id, "status": status.to_json(), "data": status.to_json()})

    def on_complete(self, task: Task, result: TaskResult) -> None:
        self._send({"task_id": task.id, "status": "Completed", "data": result.to_json()})

    def on_error(self, task: Task, error: str) -> None:
        self._send({"task_id": task.id, "status": {"Failed": error}, "data": error})


class FunctionCallback(TaskCallback):
    """Wraps a callable(event: dict) (callback/mod.rs:99-141)."""

    def __init__(self, fn: Callable[[dict], None]):
        self.fn = fn

    def on_status_change(self, task: Task, status: TaskStatus) -> None:
        self.fn({"kind": "status_change", "task_id": task.id, "status": status.to_json()})

    def on_complete(self, task: Task, result: TaskResult) -> None:
        self.fn({"kind": "complete", "task_id": task.id, "result": result.to_json()})

    def on_error(self, task: Task, error: str) -> None:
        self.fn({"kind": "error", "task_id": task.id, "error": error})


@dataclass
class TaskEvent:
    kind: str
    task_id: str
    payload: Any = None


class EventBus:
    """Broadcast channel for task events."""

    def __init__(self):
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()

    def subscribe(self, maxsize: int = 256) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def publish(self, event: TaskEvent) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(event)
            except queue.Full:
                log.warning("event subscriber queue full; dropping %s", event.kind)


class EventCallback(TaskCallback):
    def __init__(self, bus: EventBus):
        self.bus = bus

    def on_status_change(self, task: Task, status: TaskStatus) -> None:
        self.bus.publish(TaskEvent("status_change", task.id, status.to_json()))

    def on_complete(self, task: Task, result: TaskResult) -> None:
        self.bus.publish(TaskEvent("complete", task.id, result.to_json()))

    def on_error(self, task: Task, error: str) -> None:
        self.bus.publish(TaskEvent("error", task.id, error))
