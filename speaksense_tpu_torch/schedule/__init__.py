"""Task pipeline: durable queue -> scheduler/workers -> processors -> callbacks.

The port's own copy of `speaksense_tpu/schedule/__init__.py`,
with the same names and behaviour.

Rebuild of the reference's src/schedule/ (TaskManager, TaskScheduler,
TaskWorker, TranscribeProcessor, callbacks) with the same JSON wire/storage
formats (serde-tagged enums) and lifecycle semantics.
"""

from speaksense_tpu_torch.schedule.types import (  # noqa: F401
    Task,
    TaskConfig,
    TaskParams,
    TaskPriority,
    TaskResult,
    TaskStatus,
    TaskType,
    CallbackType,
    PathType,
    TranscribeParams,
    TranscribeTaskResult,
    ResultSegment,
)
from speaksense_tpu_torch.schedule.manager import TaskManager  # noqa: F401
from speaksense_tpu_torch.schedule.scheduler import TaskScheduler  # noqa: F401
