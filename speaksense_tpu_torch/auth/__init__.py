"""API-key auth (reference src/auth/): types, stats, rate limiting, service.

The port's own copy of `speaksense_tpu/auth/__init__.py`,
with the same names and behaviour."""

from speaksense_tpu_torch.auth.types import (  # noqa: F401
    ApiKeyInfo,
    ApiKeyStats,
    ApiKeyUsageReport,
    AuthError,
    KeyStatus,
    Permission,
    RateLimit,
    UsageSummary,
)
from speaksense_tpu_torch.auth.service import Auth  # noqa: F401
