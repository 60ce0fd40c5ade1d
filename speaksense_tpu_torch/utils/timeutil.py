"""UTC datetime helpers shared by storage/auth/schedule (RFC3339 JSON forms,
matching chrono's serde defaults in the reference).

The port's own copy of `speaksense_tpu/utils/timeutil.py`,
with the same names and behaviour."""

from __future__ import annotations

import datetime as _dt


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def dt_to_json(dt: _dt.datetime | None) -> str | None:
    if dt is None:
        return None
    return dt.astimezone(_dt.timezone.utc).isoformat().replace("+00:00", "Z")


def dt_from_json(s: str | None) -> _dt.datetime | None:
    if s is None:
        return None
    return _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
