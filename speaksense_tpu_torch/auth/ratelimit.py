"""In-memory per-key rate limiting.

The port's own copy of `speaksense_tpu/auth/ratelimit.py`,
with the same names and behaviour.

The reference lazily builds one `governor` per-minute limiter per key
(the reference's src/auth/service.rs:77-87; only requests_per_minute is
enforced, types.rs:26-30 note). Same semantics here: N requests per rolling
60 s window, in-memory (resets on restart). The unbounded-map growth noted in
SURVEY.md §3.5 is avoided with a cap + LRU eviction.
"""

from __future__ import annotations

import collections
import threading
import time


class MinuteRateLimiter:
    """Sliding-window limiter: allow at most `limit` events per 60 s."""

    def __init__(self, limit: int, window_s: float = 60.0):
        self.limit = max(int(limit), 0)
        self.window_s = window_s
        self._events: collections.deque[float] = collections.deque()

    def check(self, now: float | None = None) -> bool:
        if self.limit <= 0:
            return True  # unconfigured = unlimited (reference panics on 0)
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_s
        while self._events and self._events[0] <= cutoff:
            self._events.popleft()
        if len(self._events) >= self.limit:
            return False
        self._events.append(now)
        return True


class RateLimiterMap:
    """Per-key limiter registry with LRU eviction."""

    def __init__(self, max_keys: int = 10_000):
        self._limiters: collections.OrderedDict[str, MinuteRateLimiter] = collections.OrderedDict()
        self._lock = threading.Lock()
        self.max_keys = max_keys

    def check(self, key: str, per_minute: int) -> bool:
        with self._lock:
            lim = self._limiters.get(key)
            if lim is None:
                lim = MinuteRateLimiter(per_minute)
                self._limiters[key] = lim
            elif lim.limit != per_minute:
                # config change: adopt the new limit but KEEP the window
                # history — rebuilding the limiter wiped it and granted a
                # fresh full-limit burst
                lim.limit = per_minute
            self._limiters.move_to_end(key)
            while len(self._limiters) > self.max_keys:
                self._limiters.popitem(last=False)
            return lim.check()

    def forget(self, key: str) -> None:
        with self._lock:
            self._limiters.pop(key, None)
