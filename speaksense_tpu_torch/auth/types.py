"""Auth value types (mirror the reference's src/auth/types.rs, stats.rs,
error.rs). JSON/DB formats match serde output: enums as bare strings,
permission lists as JSON arrays, datetimes RFC3339.

The port's own copy of `speaksense_tpu/auth/types.py`,
with the same names and behaviour."""

from __future__ import annotations

import datetime as _dt
import enum
from dataclasses import dataclass, field

from speaksense_tpu_torch.utils.timeutil import dt_from_json, dt_to_json, utcnow


class Permission(str, enum.Enum):
    TRANSCRIBE = "Transcribe"
    SPEAKER_DIARIZATION = "SpeakerDiarization"
    EMOTION_RECOGNITION = "EmotionRecognition"
    ADMIN = "Admin"


class KeyStatus(str, enum.Enum):
    ACTIVE = "Active"
    SUSPENDED = "Suspended"
    EXPIRED = "Expired"


@dataclass
class RateLimit:
    requests_per_minute: int = 0
    requests_per_hour: int = 0
    requests_per_day: int = 0

    def to_json(self) -> dict:
        return {"requests_per_minute": self.requests_per_minute,
                "requests_per_hour": self.requests_per_hour,
                "requests_per_day": self.requests_per_day}

    @classmethod
    def from_json(cls, d: dict) -> "RateLimit":
        return cls(int(d.get("requests_per_minute", 0)),
                   int(d.get("requests_per_hour", 0)),
                   int(d.get("requests_per_day", 0)))


@dataclass
class ApiKeyInfo:
    key: str
    name: str
    created_at: _dt.datetime = field(default_factory=utcnow)
    expires_at: _dt.datetime | None = None
    permissions: list[Permission] = field(default_factory=list)
    rate_limit: RateLimit = field(default_factory=RateLimit)
    status: KeyStatus = KeyStatus.ACTIVE

    def to_json(self) -> dict:
        return {
            "key": self.key, "name": self.name,
            "created_at": dt_to_json(self.created_at),
            "expires_at": dt_to_json(self.expires_at),
            "permissions": [p.value for p in self.permissions],
            "rate_limit": self.rate_limit.to_json(),
            "status": self.status.value,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ApiKeyInfo":
        return cls(
            key=d["key"], name=d["name"],
            created_at=dt_from_json(d.get("created_at")) or utcnow(),
            expires_at=dt_from_json(d.get("expires_at")),
            permissions=[Permission(p) for p in d.get("permissions", [])],
            rate_limit=RateLimit.from_json(d.get("rate_limit") or {}),
            status=KeyStatus(d.get("status", "Active")),
        )


@dataclass
class ApiKeyStats:
    """Usage counters with a 30-day per-day map (stats.rs:7-49)."""

    total_requests: int = 0
    requests_today: int = 0
    last_used_at: _dt.datetime = field(default_factory=utcnow)
    requests_per_day: dict[str, int] = field(default_factory=dict)
    # served-work accounting: the reference reserves these columns
    # (key_stats_entity.rs:14-15) but never fills them; here every completed
    # transcription (REST batch task or authenticated gRPC stream chunk)
    # advances them (Auth.record_usage)
    total_tokens: int = 0
    total_audio_seconds: float = 0.0

    def update(self) -> None:
        today = utcnow().date().isoformat()
        self.total_requests += 1
        self.last_used_at = utcnow()
        self.requests_per_day[today] = self.requests_per_day.get(today, 0) + 1
        self.requests_today = self.requests_per_day[today]
        cutoff = (utcnow() - _dt.timedelta(days=30)).date().isoformat()
        self.requests_per_day = {d: n for d, n in self.requests_per_day.items() if d >= cutoff}

    def to_json(self) -> dict:
        return {"total_requests": self.total_requests,
                "requests_today": self.requests_today,
                "last_used_at": dt_to_json(self.last_used_at),
                "requests_per_day": dict(self.requests_per_day),
                "total_tokens": self.total_tokens,
                "total_audio_seconds": self.total_audio_seconds}


@dataclass
class UsageSummary:
    average_daily_requests: float = 0.0
    peak_daily_requests: int = 0
    days_until_expiry: int = 0

    def to_json(self) -> dict:
        return self.__dict__.copy()


@dataclass
class ApiKeyUsageReport:
    key_info: ApiKeyInfo
    stats: ApiKeyStats
    usage_summary: UsageSummary

    def to_json(self) -> dict:
        return {"key_info": self.key_info.to_json(), "stats": self.stats.to_json(),
                "usage_summary": self.usage_summary.to_json()}


class AuthError(Exception):
    """7 variants (error.rs:4-12)."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"{kind}{': ' + detail if detail else ''}")

    MISSING_KEY = "missing API key"
    INVALID_KEY = "invalid API key"
    SUSPENDED = "API key suspended"
    EXPIRED = "API key expired"
    PERMISSION_DENIED = "permission denied"
    RATE_LIMITED = "rate limit exceeded"
    STORAGE = "storage error"
