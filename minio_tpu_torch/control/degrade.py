"""Graceful-degradation counters: hedge / deadline / shed accounting.

The GLOBAL_METRICS-style process singleton the reaction layer increments
from its hot paths (hedged erasure reads in object/erasure.py, deadline
aborts in dist/transport.py and api/server.py, admission-control sheds in
storage/breaker.py and the S3 entry gate). control/metrics.py renders the
snapshot as the minio_tpu_hedge_* / minio_tpu_deadline_* /
minio_tpu_requests_shed_* Prometheus families.

Kept separate from MetricsSys on purpose: these counters are bumped from
drive-IO threads and the erasure decode loop, where importing the full
metrics module (which pulls runtime/codec) would be a cycle. One lock, a
few dict bumps -- cheap enough for the degraded path, and the healthy path
never touches it.
"""

from __future__ import annotations

import threading
from .sanitizer import san_lock, san_rlock


class DegradeStats:
    """Thread-safe counters for the degradation ladder."""

    def __init__(self):
        self._lock = san_lock("DegradeStats._lock")
        self.hedge_launched = 0  # hedge reads armed (a primary looked slow)
        self.hedge_wins = 0      # hedge results that beat their primary
        self.deadline_aborts: dict[str, int] = {}  # stage -> count
        self.sheds: dict[str, int] = {}  # kind (read/write/drive) -> count
        self.breaker_trips = 0   # circuit breakers tripped open (any drive)
        self.breaker_closes = 0  # breakers re-closed after half-open probe

    def record_hedge(self, launched: int, wins: int) -> None:
        if not launched and not wins:
            return
        with self._lock:
            self.hedge_launched += launched
            self.hedge_wins += wins

    def record_deadline_abort(self, stage: str) -> None:
        with self._lock:
            self.deadline_aborts[stage] = self.deadline_aborts.get(stage, 0) + 1

    def record_shed(self, kind: str) -> None:
        with self._lock:
            self.sheds[kind] = self.sheds.get(kind, 0) + 1

    def record_breaker(self, tripped: bool) -> None:
        with self._lock:
            if tripped:
                self.breaker_trips += 1
            else:
                self.breaker_closes += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hedge_launched": self.hedge_launched,
                "hedge_wins": self.hedge_wins,
                "deadline_aborts": dict(self.deadline_aborts),
                "sheds": dict(self.sheds),
                "breaker_trips": self.breaker_trips,
                "breaker_closes": self.breaker_closes,
            }


GLOBAL_DEGRADE = DegradeStats()
