"""Replication bandwidth: per-(bucket, target) throttling + live monitoring.

Role of the reference's internal/bucket/bandwidth package + the admin
bandwidth endpoint (cmd/admin-handlers.go:1935): each replication target
may carry a bandwidth limit (madmin.BucketTarget.BandwidthLimit); the
replication workers throttle replica PUTs against it with a token bucket,
and the monitor reports the currently-observed per-target rate over a
sliding window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from .sanitizer import san_lock, san_rlock


class _TokenBucket:
    """Byte-rate token bucket; consume() sleeps until the bytes fit.

    Burst capacity is one second of the limit, so small objects pass
    without sleeping while sustained traffic converges on the limit.
    """

    def __init__(self, rate_bps: float):
        self.rate = float(rate_bps)
        self.capacity = max(self.rate, 1.0)
        self.tokens = self.capacity
        self.ts = time.monotonic()
        self._lock = san_lock("_TokenBucket._lock")

    def consume(self, n: int) -> float:
        """Take n tokens (n <= capacity; callers chunk larger requests);
        returns seconds slept."""
        n = min(n, int(self.capacity))
        slept = 0.0
        while True:
            with self._lock:
                now = time.monotonic()
                self.tokens = min(self.capacity, self.tokens + (now - self.ts) * self.rate)
                self.ts = now
                if self.tokens >= n:
                    self.tokens -= n
                    return slept
                wait = min((n - self.tokens) / self.rate, 1.0)
            time.sleep(wait)
            slept += wait


class _Window:
    """Sliding-window byte counter (last `span` seconds)."""

    def __init__(self, span_s: float = 30.0):
        self.span = span_s
        self.events: deque[tuple[float, int]] = deque()
        self.total = 0

    def add(self, n: int, now: float) -> None:
        self.events.append((now, n))
        self.total += n
        self._trim(now)

    def rate(self, now: float) -> float:
        self._trim(now)
        if not self.events:
            return 0.0
        span = max(now - self.events[0][0], 1.0)
        return self.total / span

    def _trim(self, now: float) -> None:
        cutoff = now - self.span
        while self.events and self.events[0][0] < cutoff:
            _, n = self.events.popleft()
            self.total -= n


class BandwidthMonitor:
    """Per-(bucket, target-arn) limits, throttles, and observed rates."""

    def __init__(self):
        self._lock = san_lock("BandwidthMonitor._lock")
        self._limits: dict[tuple[str, str], int] = {}
        self._buckets: dict[tuple[str, str], _TokenBucket] = {}
        self._windows: dict[tuple[str, str], _Window] = {}

    def set_limit(self, bucket: str, arn: str, bps: int) -> None:
        key = (bucket, arn)
        with self._lock:
            if bps > 0:
                self._limits[key] = bps
                tb = self._buckets.get(key)
                if tb is None or tb.rate != bps:
                    self._buckets[key] = _TokenBucket(bps)
            else:
                self._limits.pop(key, None)
                self._buckets.pop(key, None)

    def throttle(self, bucket: str, arn: str, n: int) -> float:
        """Block until n bytes fit under the target's limit (no-op when
        unlimited); returns seconds slept. Payloads larger than the burst
        are paced in burst-sized chunks, so one big replica PUT pays the
        full n/rate wait instead of riding the burst through for free."""
        with self._lock:
            tb = self._buckets.get((bucket, arn))
        if tb is None:
            return 0.0
        chunk = max(int(tb.capacity), 1)
        slept = 0.0
        for off in range(0, n, chunk):
            slept += tb.consume(min(chunk, n - off))
        return slept

    def drop(self, bucket: str, arn: str) -> None:
        """Forget a target entirely (target removed): limit, throttle state,
        and observed-rate window -- the report must not list it forever."""
        key = (bucket, arn)
        with self._lock:
            self._limits.pop(key, None)
            self._buckets.pop(key, None)
            self._windows.pop(key, None)

    def record(self, bucket: str, arn: str, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            w = self._windows.setdefault((bucket, arn), _Window())
            w.add(n, now)

    def report(self, bucket: str = "") -> dict:
        """madmin-style bandwidth report: limit + current rate per target."""
        now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            keys = set(self._limits) | set(self._windows)
            for b, arn in sorted(keys):
                if bucket and b != bucket:
                    continue
                w = self._windows.get((b, arn))
                out.setdefault(b, {})[arn] = {
                    "limitInBytesPerSecond": self._limits.get((b, arn), 0),
                    "currentBandwidthInBytesPerSecond": round(w.rate(now), 1) if w else 0.0,
                }
        return out
