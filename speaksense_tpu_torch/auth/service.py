"""Auth service (mirror the reference's src/auth/service.rs:23-200).

The port's own copy of `speaksense_tpu/auth/service.py`,
with the same names and behaviour.

verify: "Bearer X" parse (split-on-space-last) -> key lookup -> status check
-> expiry check -> permission check -> per-minute rate limit -> stats upsert.
create: key-{uuid4}. revoke: -> Suspended. Admin bootstrap at startup creates
an Admin+Transcribe+SpeakerDiarization key at 100/min and logs it once.
"""

from __future__ import annotations

import datetime as _dt
import logging
import uuid

from speaksense_tpu_torch.auth.ratelimit import RateLimiterMap
from speaksense_tpu_torch.auth.types import (
    ApiKeyInfo, ApiKeyStats, ApiKeyUsageReport, AuthError, KeyStatus,
    Permission, RateLimit, UsageSummary,
)
from speaksense_tpu_torch.utils.timeutil import utcnow
from speaksense_tpu_torch.storage import ApiKeyStatsStorage, KeyStorage

log = logging.getLogger(__name__)


class Auth:
    def __init__(self, key_storage: KeyStorage, stats_storage: ApiKeyStatsStorage):
        self.key_storage = key_storage
        self.stats_storage = stats_storage
        self.rate_limiters = RateLimiterMap()

    def verify_api_key(self, header_value: str | None, required: Permission) -> None:
        """Raises AuthError on any failure (service.rs:41-90)."""
        if not header_value:
            raise AuthError(AuthError.MISSING_KEY)
        api_key = header_value.split(" ")[-1]
        if not api_key:
            raise AuthError(AuthError.INVALID_KEY)

        info = self.key_storage.get(api_key)
        if info is None:
            raise AuthError(AuthError.INVALID_KEY)

        if info.status is KeyStatus.SUSPENDED:
            raise AuthError(AuthError.SUSPENDED)
        if info.status is KeyStatus.EXPIRED:
            raise AuthError(AuthError.EXPIRED)
        if info.expires_at is not None and info.expires_at < utcnow():
            raise AuthError(AuthError.EXPIRED)
        if required not in info.permissions:
            raise AuthError(AuthError.PERMISSION_DENIED)
        if not self.rate_limiters.check(api_key, info.rate_limit.requests_per_minute):
            raise AuthError(AuthError.RATE_LIMITED)
        self._update_key_stats(api_key)

    def create_api_key(self, name: str, permissions: list[Permission],
                       rate_limit: RateLimit, expires_in_days: int | None = None) -> ApiKeyInfo:
        key = f"key-{uuid.uuid4()}"
        expires_at = (utcnow() + _dt.timedelta(days=expires_in_days)
                      if expires_in_days is not None else None)
        info = ApiKeyInfo(key=key, name=name, created_at=utcnow(), expires_at=expires_at,
                          permissions=list(permissions), rate_limit=rate_limit,
                          status=KeyStatus.ACTIVE)
        self.key_storage.create(key, info)
        return info

    def revoke_api_key(self, api_key: str) -> None:
        self.key_storage.update_status(api_key, KeyStatus.SUSPENDED)

    def _update_key_stats(self, api_key: str) -> None:
        # increment-style fast path (SQL backends avoid re-reading and
        # rewriting the 30-day history on every verified request)
        self.stats_storage.bump_stats(api_key)

    def record_usage(self, api_key: str, tokens: int = 0,
                     audio_seconds: float = 0.0) -> None:
        """Served-work accounting: advance total_tokens /
        total_audio_seconds for a completed transcription (the reference
        reserves these columns, key_stats_entity.rs:14-15, and never fills
        them). Called on batch-task completion (TaskManager.usage_hook) and
        per authenticated gRPC stream chunk."""
        if not (tokens or audio_seconds):
            return
        self.stats_storage.add_usage(api_key, tokens=tokens,
                                     audio_seconds=audio_seconds)

    def get_key_stats(self, api_key: str) -> ApiKeyStats:
        if self.key_storage.get(api_key) is None:
            raise KeyError("API key not found")
        return self.stats_storage.get_stats(api_key) or ApiKeyStats()

    def get_key_usage_report(self, api_key: str) -> ApiKeyUsageReport:
        info = self.key_storage.get(api_key)
        if info is None:
            raise KeyError("API key not found")
        stats = self.stats_storage.get_stats(api_key) or ApiKeyStats()
        days_until_expiry = ((info.expires_at - utcnow()).days
                             if info.expires_at is not None else -1)
        # peak over the durable 30-day history (the whole point of the
        # api_key_daily_usage table); the reference could only report today
        peak = (max(stats.requests_per_day.values())
                if stats.requests_per_day else stats.requests_today)
        return ApiKeyUsageReport(
            key_info=info, stats=stats,
            usage_summary=UsageSummary(
                average_daily_requests=stats.total_requests / 30.0,
                peak_daily_requests=peak,
                days_until_expiry=days_until_expiry,
            ))

    def initialize_admin_key(self) -> ApiKeyInfo | None:
        """Idempotent admin bootstrap (service.rs:170-200)."""
        for info in self.key_storage.list():
            if Permission.ADMIN in info.permissions:
                return None
        admin = self.create_api_key(
            "System Administrator",
            [Permission.ADMIN, Permission.TRANSCRIBE, Permission.SPEAKER_DIARIZATION],
            RateLimit(requests_per_minute=100, requests_per_hour=1000, requests_per_day=10000),
            expires_in_days=None,
        )
        log.warning("🔐 Generated initial admin API key: %s", admin.key)
        log.warning("⚠️  Please save this key securely - it will not be shown again!")
        return admin
