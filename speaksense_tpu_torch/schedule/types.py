"""Task value types with serde-compatible JSON codecs.

The port's own copy of `speaksense_tpu/schedule/types.py`,
with the same names and behaviour.

Wire/storage formats must match the reference byte-for-byte so existing
clients, stored rows, and callback receivers keep working
(the reference's src/schedule/types.rs):

- enums serialize as bare strings ("Pending", "Normal", "Url");
- TaskStatus::Failed carries its message: {"Failed": "msg"};
- TaskParams / TaskResult / CallbackType are serde internally-tagged:
  {"type": "Transcribe", "params": {...}}, {"type": "Transcribe",
  "result": {...}}, {"type": "Http", "config": {"url": ...}};
- datetimes are RFC3339 UTC strings (chrono serde default).
"""

from __future__ import annotations

import datetime as _dt
import enum
import json
import uuid
from dataclasses import dataclass, field
from typing import Any


from speaksense_tpu_torch.utils.timeutil import dt_from_json, dt_to_json, utcnow  # noqa: F401,E402


class TaskType(str, enum.Enum):
    TRANSCRIBE = "Transcribe"
    VOICEPRINT_RECOGNITION = "VoiceprintRecognition"
    NOISE_REDUCTION = "NoiseReduction"

    def __str__(self) -> str:
        return self.value


class TaskPriority(str, enum.Enum):
    """Stored as ordinal i32; ascending sort => Critical first
    (types.rs:22-27, sqlite.rs:92-102)."""

    CRITICAL = "Critical"
    HIGH = "High"
    NORMAL = "Normal"
    LOW = "Low"

    @property
    def ordinal(self) -> int:
        return ["Critical", "High", "Normal", "Low"].index(self.value)

    @classmethod
    def from_ordinal(cls, i: int) -> "TaskPriority":
        return list(cls)[i]


class PathType(str, enum.Enum):
    URL = "Url"
    LOCAL = "Local"


@dataclass
class TaskStatus:
    """Pending/Processing/Completed/Failed(msg)/Retrying/TimedOut.
    JSON: bare string, except Failed -> {"Failed": msg}."""

    kind: str
    error: str | None = None

    PENDING = "Pending"
    PROCESSING = "Processing"
    COMPLETED = "Completed"
    FAILED = "Failed"
    RETRYING = "Retrying"
    TIMED_OUT = "TimedOut"

    @classmethod
    def pending(cls):
        return cls(cls.PENDING)

    @classmethod
    def processing(cls):
        return cls(cls.PROCESSING)

    @classmethod
    def completed(cls):
        return cls(cls.COMPLETED)

    @classmethod
    def failed(cls, msg: str):
        return cls(cls.FAILED, msg)

    @classmethod
    def retrying(cls):
        return cls(cls.RETRYING)

    @classmethod
    def timed_out(cls):
        return cls(cls.TIMED_OUT)

    def to_json(self) -> Any:
        if self.kind == self.FAILED:
            return {self.FAILED: self.error or ""}
        return self.kind

    @classmethod
    def from_json(cls, v: Any) -> "TaskStatus":
        if isinstance(v, dict):
            (kind, err), = v.items()
            return cls(kind, err)
        return cls(str(v))

    def __str__(self) -> str:  # Display form (no quotes), types.rs Display
        if self.kind == self.FAILED:
            return f'Failed("{self.error or ""}")'
        return self.kind

    def __eq__(self, other) -> bool:
        if isinstance(other, TaskStatus):
            return self.kind == other.kind
        return self.kind == other


@dataclass
class TranscribeParams:
    language: str | None = None
    speaker_diarization: bool = False
    emotion_recognition: bool = False
    filter_dirty_words: bool = False

    def to_json(self) -> dict:
        return {"language": self.language, "speaker_diarization": self.speaker_diarization,
                "emotion_recognition": self.emotion_recognition,
                "filter_dirty_words": self.filter_dirty_words}

    @classmethod
    def from_json(cls, d: dict) -> "TranscribeParams":
        return cls(language=d.get("language"),
                   speaker_diarization=bool(d.get("speaker_diarization", False)),
                   emotion_recognition=bool(d.get("emotion_recognition", False)),
                   filter_dirty_words=bool(d.get("filter_dirty_words", False)))


@dataclass
class TaskParams:
    """serde(tag="type", content="params") enum."""

    type: TaskType
    params: TranscribeParams | dict

    @classmethod
    def transcribe(cls, p: TranscribeParams) -> "TaskParams":
        return cls(TaskType.TRANSCRIBE, p)

    def to_json(self) -> dict:
        p = self.params.to_json() if hasattr(self.params, "to_json") else (self.params or {})
        return {"type": self.type.value, "params": p}

    @classmethod
    def from_json(cls, d: dict) -> "TaskParams":
        t = TaskType(d["type"])
        p = d.get("params") or {}
        if t is TaskType.TRANSCRIBE:
            return cls(t, TranscribeParams.from_json(p))
        return cls(t, p)


@dataclass
class ResultSegment:
    """types.rs:133-138 — note field names start_time/end_time and optional
    speaker_id (unlike the engine-level TranscribeSegment)."""

    text: str
    speaker_id: int | None = None
    start_time: float = 0.0
    end_time: float = 0.0
    # set only when TranscribeParams.emotion_recognition is on (the flag the
    # reference accepts but never reads, web/handlers/asr.rs:36-46); emitted
    # conditionally so the on-disk JSON stays byte-identical when off
    emotion: str | None = None

    def to_json(self) -> dict:
        d = {"text": self.text, "speaker_id": self.speaker_id,
             "start_time": self.start_time, "end_time": self.end_time}
        if self.emotion is not None:
            d["emotion"] = self.emotion
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ResultSegment":
        return cls(text=d.get("text", ""), speaker_id=d.get("speaker_id"),
                   start_time=float(d.get("start_time", 0.0)),
                   end_time=float(d.get("end_time", 0.0)),
                   emotion=d.get("emotion"))


@dataclass
class TranscribeTaskResult:
    text: str = ""
    segments: list[ResultSegment] = field(default_factory=list)
    # usage accounting (additive fields): decoder tokens sampled and audio
    # seconds processed — TaskManager.complete_task forwards them to
    # Auth.record_usage for the creating API key
    n_tokens: int = 0
    audio_seconds: float = 0.0

    def to_json(self) -> dict:
        d = {"text": self.text, "segments": [s.to_json() for s in self.segments]}
        if self.n_tokens or self.audio_seconds:
            d["n_tokens"] = self.n_tokens
            d["audio_seconds"] = self.audio_seconds
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TranscribeTaskResult":
        return cls(text=d.get("text", ""),
                   segments=[ResultSegment.from_json(s) for s in d.get("segments", [])],
                   n_tokens=int(d.get("n_tokens", 0)),
                   audio_seconds=float(d.get("audio_seconds", 0.0)))


@dataclass
class TaskResult:
    """serde(tag="type", content="result") enum."""

    type: TaskType
    result: TranscribeTaskResult | dict

    @classmethod
    def transcribe(cls, r: TranscribeTaskResult) -> "TaskResult":
        return cls(TaskType.TRANSCRIBE, r)

    def to_json(self) -> dict:
        r = self.result.to_json() if hasattr(self.result, "to_json") else (self.result or {})
        return {"type": self.type.value, "result": r}

    @classmethod
    def from_json(cls, d: dict) -> "TaskResult":
        t = TaskType(d["type"])
        r = d.get("result") or {}
        if t is TaskType.TRANSCRIBE:
            return cls(t, TranscribeTaskResult.from_json(r))
        return cls(t, r)


@dataclass
class CallbackType:
    """serde(tag="type", content="config") enum: Http{url} / Function{name} /
    Event / None."""

    kind: str
    url: str | None = None
    name: str | None = None

    HTTP = "Http"
    FUNCTION = "Function"
    EVENT = "Event"
    NONE = "None"

    @classmethod
    def http(cls, url: str) -> "CallbackType":
        return cls(cls.HTTP, url=url)

    @classmethod
    def function(cls, name: str) -> "CallbackType":
        return cls(cls.FUNCTION, name=name)

    @classmethod
    def event(cls) -> "CallbackType":
        return cls(cls.EVENT)

    @classmethod
    def none(cls) -> "CallbackType":
        return cls(cls.NONE)

    def to_json(self) -> dict:
        if self.kind == self.HTTP:
            return {"type": self.HTTP, "config": {"url": self.url}}
        if self.kind == self.FUNCTION:
            return {"type": self.FUNCTION, "config": {"name": self.name}}
        return {"type": self.kind}

    @classmethod
    def from_json(cls, d: dict) -> "CallbackType":
        kind = d.get("type", cls.NONE)
        cfg = d.get("config") or {}
        return cls(kind, url=cfg.get("url"), name=cfg.get("name"))


@dataclass
class TaskConfig:
    task_type: TaskType
    input_path: str
    path_type: PathType
    callback_type: CallbackType
    params: TaskParams
    priority: TaskPriority = TaskPriority.NORMAL
    retry_count: int = 0
    max_retries: int = 3
    timeout: int | None = None  # seconds
    # API key the task was created under (REST bearer key) — completion
    # advances its total_tokens/total_audio_seconds usage counters
    # (TaskManager.usage_hook). Additive field: absent in reference task
    # JSON, tolerated by serde-style readers.
    api_key: str | None = None

    def to_json(self) -> dict:
        d = {
            "task_type": self.task_type.value,
            "input_path": self.input_path,
            "path_type": self.path_type.value,
            "callback_type": self.callback_type.to_json(),
            "params": self.params.to_json(),
            "priority": self.priority.value,
            "retry_count": self.retry_count,
            "max_retries": self.max_retries,
            "timeout": self.timeout,
        }
        if self.api_key:
            d["api_key"] = self.api_key
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TaskConfig":
        return cls(
            task_type=TaskType(d["task_type"]),
            input_path=d["input_path"],
            path_type=PathType(d.get("path_type", "Local")),
            callback_type=CallbackType.from_json(d.get("callback_type") or {"type": "None"}),
            params=TaskParams.from_json(d["params"]),
            priority=TaskPriority(d.get("priority", "Normal")),
            retry_count=int(d.get("retry_count", 0)),
            max_retries=int(d.get("max_retries", 3)),
            timeout=d.get("timeout"),
            api_key=d.get("api_key"),
        )


@dataclass
class Task:
    """Lifecycle record (types.rs:75-85)."""

    id: str
    status: TaskStatus
    config: TaskConfig
    created_at: _dt.datetime = field(default_factory=utcnow)
    updated_at: _dt.datetime = field(default_factory=utcnow)
    started_at: _dt.datetime | None = None
    completed_at: _dt.datetime | None = None
    result: TaskResult | None = None
    error: str | None = None

    @classmethod
    def new(cls, config: TaskConfig) -> "Task":
        return cls(id=str(uuid.uuid4()), status=TaskStatus.pending(), config=config)

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "status": self.status.to_json(),
            "config": self.config.to_json(),
            "created_at": dt_to_json(self.created_at),
            "updated_at": dt_to_json(self.updated_at),
            "started_at": dt_to_json(self.started_at),
            "completed_at": dt_to_json(self.completed_at),
            "result": self.result.to_json() if self.result else None,
            "error": self.error,
        }

    def to_public_json(self) -> dict:
        """to_json with the creator's bearer key REDACTED — the form every
        REST handler must return. config.api_key exists only for usage
        attribution on completion (TaskManager.usage_hook); serving it from
        GET /schedule/tasks/{id} (an unauthenticated route, reference
        parity) would hand the creator's full key to anyone who learns a
        task id. At-rest plaintext in the tasks table matches the
        reference's own api_keys table (raw keys, same DB file)."""
        d = self.to_json()
        if d["config"].get("api_key"):
            d["config"] = dict(d["config"], api_key="[redacted]")
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Task":
        return cls(
            id=d["id"],
            status=TaskStatus.from_json(d["status"]),
            config=TaskConfig.from_json(d["config"]),
            created_at=dt_from_json(d["created_at"]) or utcnow(),
            updated_at=dt_from_json(d["updated_at"]) or utcnow(),
            started_at=dt_from_json(d.get("started_at")),
            completed_at=dt_from_json(d.get("completed_at")),
            result=TaskResult.from_json(d["result"]) if d.get("result") else None,
            error=d.get("error"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), ensure_ascii=False)
