"""Per-drive circuit breaker + admission control: HealthGatedDrive.

Role of the reference's disk health tracking inside xlStorageDiskIDCheck
(cmd/xl-storage-disk-id-check.go:174 diskHealthTracker: consecutive-failure
counting, the drive taken OFFLINE and probed back with a monitor goroutine)
merged with its per-disk concurrency clamp (errDiskOngoingReq). Layered in
dist/node.py between MeteredDrive and FaultyDisk --
MeteredDrive(HealthGatedDrive(FaultyDisk(LocalDrive))) -- so injected chaos
faults trip the breaker exactly like kernel EIOs would, and the metered
EWMAs time the breaker's fail-fast refusals like any other outcome.

Breaker states:
  CLOSED    -- healthy; calls flow through, outcomes are scored.
  OPEN      -- tripped after N consecutive health-relevant errors or a
               sustained latency EWMA blowout. Every gated call fails fast
               with errors.CircuitOpen (quorum-countable: the erasure layer
               routes around the drive). is_online() reports False so
               reads/writes stop selecting the drive at all.
  HALF_OPEN -- a background probe thread (jittered cool-down between
               attempts, transport.jitter discipline) tries a real
               disk_info() against the inner drive; success re-closes the
               breaker, failure re-opens it with a grown cool-down.

Admission: a bounded in-flight semaphore per drive. When the window is
full the call is refused immediately with errors.DriveBusy instead of
queueing unboundedly -- shed load surfaces as a quorum-countable error the
caller can route around, and the node-level gate (api/server.py) turns
sustained shedding into SlowDown 503s with Retry-After.
"""

from __future__ import annotations

import threading
import time

from ..control.degrade import GLOBAL_DEGRADE
from ..utils import errors
from .metered import _METERED
from ..control.sanitizer import san_lock, san_rlock

# Gate the same call set MeteredDrive times: everything that hits the disk.
_GATED = _METERED

# Errors that count against drive HEALTH. Application-level outcomes
# (FileNotFound on a missing object, VolumeNotFound on a fresh bucket) are
# the drive answering correctly and must never trip the breaker.
_HEALTH_ERRORS = (
    errors.FaultyDisk,
    errors.DiskNotFound,
    errors.DiskAccessDenied,
    errors.DiskFull,
)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_EWMA_ALPHA = 0.3


class CircuitBreaker:
    """Trip/probe state machine for one drive.

    Separable from the StorageAPI wrapper so transport-level health (a
    RemoteDrive's RestClient) could reuse it; HealthGatedDrive owns one.
    """

    def __init__(
        self,
        name: str = "",
        error_threshold: int = 5,
        latency_limit_ms: float = 30_000.0,
        latency_min_samples: int = 16,
        cooldown: float = 2.0,
        max_cooldown: float = 30.0,
        probe=None,
        clock=time.monotonic,
    ):
        self.name = name
        self.error_threshold = error_threshold
        self.latency_limit_ms = latency_limit_ms
        self.latency_min_samples = latency_min_samples
        self.cooldown = cooldown
        self.max_cooldown = max_cooldown
        self._probe = probe  # zero-arg callable; raising = still unhealthy
        self._clock = clock
        self._lock = san_lock("CircuitBreaker._lock")
        self.state = CLOSED
        self.consecutive_errors = 0
        self.trips = 0
        self.ewma_ms: float | None = None
        self.samples = 0
        self._current_cooldown = cooldown
        self._probe_thread: threading.Thread | None = None
        self._closed_evt = threading.Event()  # probe thread exit signal

    # -- outcome scoring -----------------------------------------------------

    def record_success(self, duration_ms: float) -> None:
        with self._lock:
            self.consecutive_errors = 0
            self._score_latency_locked(duration_ms)

    def record_error(self, exc: Exception, duration_ms: float) -> None:
        """Score a failed call. Only health-relevant errors count toward the
        trip threshold; a FileNotFound still proves the drive is answering
        and RESETS the consecutive counter like a success."""
        health = isinstance(exc, _HEALTH_ERRORS) or not isinstance(
            exc, errors.StorageError
        )
        with self._lock:
            if not health:
                self.consecutive_errors = 0
                return
            self.consecutive_errors += 1
            if self.state == CLOSED and self.consecutive_errors >= self.error_threshold:
                self._trip_locked(f"{self.consecutive_errors} consecutive errors")

    def _score_latency_locked(self, duration_ms: float) -> None:
        prev = self.ewma_ms
        self.ewma_ms = (
            duration_ms if prev is None else prev + _EWMA_ALPHA * (duration_ms - prev)
        )
        self.samples += 1
        if (
            self.state == CLOSED
            and self.samples >= self.latency_min_samples
            and self.ewma_ms > self.latency_limit_ms
        ):
            self._trip_locked(f"latency EWMA {self.ewma_ms:.0f}ms over limit")

    # -- state machine -------------------------------------------------------

    def _trip_locked(self, why: str) -> None:
        self.state = OPEN
        self.trips += 1
        self._current_cooldown = self.cooldown
        GLOBAL_DEGRADE.record_breaker(tripped=True)
        import logging

        logging.getLogger("minio_tpu_torch.breaker").warning(
            "circuit OPEN for drive %s: %s", self.name, why
        )
        self._start_probe_locked()

    def _start_probe_locked(self) -> None:
        if self._probe is None:
            return
        if self._probe_thread is not None and self._probe_thread.is_alive():
            return
        self._closed_evt.clear()
        t = threading.Thread(
            target=self._probe_loop, name=f"breaker-probe:{self.name}", daemon=True
        )
        self._probe_thread = t
        t.start()

    def _probe_loop(self) -> None:
        """Background half-open probing: after a jittered cool-down, try one
        real call against the inner drive. Success closes the breaker;
        failure re-opens with a grown cool-down (capped), so a dead drive
        is probed ever more lazily instead of hammered."""
        from ..dist.transport import jitter

        while not self._closed_evt.wait(jitter(self._current_cooldown)):
            with self._lock:
                if self.state == CLOSED:
                    return
                self.state = HALF_OPEN
            try:
                self._probe()
            except Exception:  # noqa: BLE001 - any failure = still sick
                with self._lock:
                    self.state = OPEN
                    self._current_cooldown = min(
                        self._current_cooldown * 2, self.max_cooldown
                    )
                continue
            self.reset()
            return

    def reset(self) -> None:
        """Close the breaker (probe success, or an operator override)."""
        with self._lock:
            was_open = self.state != CLOSED
            self.state = CLOSED
            self.consecutive_errors = 0
            self.ewma_ms = None
            self.samples = 0
            self._current_cooldown = self.cooldown
        self._closed_evt.set()
        if was_open:
            GLOBAL_DEGRADE.record_breaker(tripped=False)
            import logging

            logging.getLogger("minio_tpu_torch.breaker").info(
                "circuit CLOSED for drive %s", self.name
            )

    def close(self) -> None:
        """Teardown: stop probing WITHOUT closing the circuit state (an open
        breaker at shutdown stays open; reset() is the operator path)."""
        self._closed_evt.set()
        t = self._probe_thread
        if t is not None:
            t.join(5.0)

    def allows(self) -> bool:
        return self.state == CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "trips": self.trips,
                "consecutive_errors": self.consecutive_errors,
                "ewma_ms": round(self.ewma_ms, 3) if self.ewma_ms is not None else None,
            }


class HealthGatedDrive:
    """Transparent StorageAPI decorator: circuit breaker + bounded in-flight
    admission in front of the inner drive (the MeteredDrive/FaultyDisk
    __dict__-assignment decorator idiom)."""

    # Class-level defaults; dist/node.py or tests may pass overrides.
    MAX_INFLIGHT = 64

    def __init__(
        self,
        inner,
        breaker: CircuitBreaker | None = None,
        max_inflight: int | None = None,
    ):
        self.__dict__["inner"] = inner
        if breaker is None:
            breaker = CircuitBreaker(
                name=inner.endpoint(),
                probe=lambda: inner.disk_info(),
            )
        elif breaker._probe is None:
            breaker._probe = lambda: inner.disk_info()
        if not breaker.name:
            breaker.name = inner.endpoint()
        self.__dict__["breaker"] = breaker
        self.__dict__["_sem"] = threading.BoundedSemaphore(
            max_inflight if max_inflight is not None else self.MAX_INFLIGHT
        )

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in _GATED or not callable(attr):
            return attr
        breaker: CircuitBreaker = self.breaker
        sem: threading.BoundedSemaphore = self._sem

        def gated(*args, **kwargs):
            if not breaker.allows():
                raise errors.CircuitOpen(f"breaker open: {breaker.name}")
            if not sem.acquire(blocking=False):
                GLOBAL_DEGRADE.record_shed("drive")
                raise errors.DriveBusy(f"drive in-flight window full: {breaker.name}")
            t0 = time.perf_counter()
            try:
                out = attr(*args, **kwargs)
            except Exception as e:
                breaker.record_error(e, (time.perf_counter() - t0) * 1e3)
                raise
            finally:
                sem.release()
            breaker.record_success((time.perf_counter() - t0) * 1e3)
            return out

        return gated

    # walk_dir stays a REAL generator function so MeteredDrive's
    # isgeneratorfunction check keeps timing full iterations through this
    # wrapper (the FaultyDisk discipline). The breaker gates creation and
    # scores the complete walk; admission covers only the iteration window.
    def walk_dir(self, volume: str, base: str = "", recursive: bool = True):
        breaker: CircuitBreaker = self.breaker
        if not breaker.allows():
            raise errors.CircuitOpen(f"breaker open: {breaker.name}")
        if not self._sem.acquire(blocking=False):
            GLOBAL_DEGRADE.record_shed("drive")
            raise errors.DriveBusy(f"drive in-flight window full: {breaker.name}")
        t0 = time.perf_counter()
        try:
            yield from self.inner.walk_dir(volume, base, recursive)
        except Exception as e:
            breaker.record_error(e, (time.perf_counter() - t0) * 1e3)
            raise
        finally:
            self._sem.release()
        breaker.record_success((time.perf_counter() - t0) * 1e3)

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value
        else:
            setattr(self.inner, name, value)

    # -- health surface ------------------------------------------------------

    def is_online(self) -> bool:
        """Offline while the breaker is anything but CLOSED: half-open
        recovery rides the background probe, not live traffic, so one
        flapping drive can't keep poisoning reads while it convalesces."""
        return self.breaker.allows() and self.inner.is_online()

    def breaker_state(self) -> dict:
        """Snapshot for metrics/admin: state, trips, consecutive errors."""
        return self.breaker.snapshot()
