"""Per-drive API metering: latency EWMAs + storage call tracing.

Role of the reference's xlStorageDiskIDCheck (cmd/xl-storage-disk-id-check.go
:68,:74,:585): every StorageAPI call through a drive is timed into a
per-API exponentially-weighted moving average, and published to the trace
hub when someone is watching (`mc admin trace --call storage`), at zero
cost otherwise (NumSubscribers guard, :580-588).
"""

from __future__ import annotations

import inspect
import threading
import time

from ..control.perf import GLOBAL_PERF
from ..control.profiler import COPIED, GLOBAL_PROFILER, MOVED
from ..control.sanitizer import san_lock, san_rlock

# StorageAPI methods that hit the disk (the metered set).
_METERED = frozenset(
    (
        "disk_info make_vol stat_vol list_vols delete_vol write_all read_all "
        "delete create_file append_file append_iov read_file read_file_into "
        "stat_file read_xl "
        "read_version write_metadata update_metadata delete_version "
        "rename_data rename_file list_dir walk_dir verify_file"
    ).split()
)

# Copy-ledger hop classification for the drive boundary: writes hand the
# caller's buffer straight to the OS (moved); reads materialize fresh bytes
# from the page cache (copied).
_WRITE_BYTES = frozenset({"write_all", "create_file", "append_file"})
_READ_BYTES = frozenset({"read_file", "read_all"})

_EWMA_ALPHA = 0.3  # same smoothing idea as the reference's diskMaxTimeout ewma


class MeteredDrive:
    """Transparent StorageAPI decorator. Everything delegates to the inner
    drive; metered methods are timed."""

    def __init__(self, inner, trace=None):
        # __dict__ assignment avoids recursing through __setattr__/__getattr__.
        self.__dict__["inner"] = inner
        self.__dict__["trace"] = trace
        self.__dict__["_lat"] = {}
        self.__dict__["_counts"] = {}
        self.__dict__["_errors"] = {}
        self.__dict__["_lock"] = san_lock("MeteredDrive._lock")

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in _METERED or not callable(attr):
            return attr

        def record(t0: float, c0: float, failed: bool) -> None:
            dt = time.perf_counter() - t0
            ms = dt * 1e3
            # Always-on attribution: storage calls feed the stage ledger
            # directly (one bucket increment) -- drive fan-out pool threads
            # have no span context, so Span.finish can't cover them. The
            # thread_time delta is valid because record runs on the calling
            # thread: wall >> cpu here means the drive (or page cache) is
            # the wait, not the interpreter.
            GLOBAL_PERF.ledger.record("storage", name, dt, time.thread_time() - c0)
            with self._lock:
                if failed:
                    self._errors[name] = self._errors.get(name, 0) + 1
                prev = self._lat.get(name)
                self._lat[name] = (
                    ms if prev is None else prev + _EWMA_ALPHA * (ms - prev)
                )
                self._counts[name] = self._counts.get(name, 0) + 1
            trace = self.trace
            if trace is not None and trace.enabled():
                from ..control import tracing

                # When a request trace is active, the storage call is a span
                # in its tree (per-drive children of the object-layer span);
                # otherwise it stays a flat storage record.
                cur = tracing.current()
                if cur is not None:
                    trace.publish(
                        "span",
                        name=f"storage.{name}",
                        layer="storage",
                        trace=cur.trace_id,
                        span=tracing._new_id(),
                        parent=cur.span_id,
                        call=name,
                        drive=self.inner.endpoint(),
                        duration_ms=round(ms, 3),
                        error=failed or None,
                    )
                else:
                    trace.publish(
                        "storage",
                        call=name,
                        drive=self.inner.endpoint(),
                        duration_ms=round(ms, 3),
                    )

        if inspect.isgeneratorfunction(getattr(type(self.inner), name, None)):
            # Generators (walk_dir): time the FULL iteration and count errors
            # raised mid-stream — timing creation alone would always read 0.
            def timed_gen(*args, **kwargs):
                t0 = time.perf_counter()
                c0 = time.thread_time()
                try:
                    yield from attr(*args, **kwargs)
                except Exception:
                    record(t0, c0, failed=True)
                    raise
                record(t0, c0, failed=False)

            return timed_gen

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                out = attr(*args, **kwargs)
            except Exception:
                record(t0, c0, failed=True)
                raise
            record(t0, c0, failed=False)
            if name == "append_iov":
                iovecs = kwargs.get("iovecs") if len(args) < 3 else args[2]
                if iovecs:
                    GLOBAL_PROFILER.copy.record(
                        "drive-write", MOVED, sum(len(v) for v in iovecs)
                    )
            elif name in _WRITE_BYTES:
                data = kwargs.get("data") if len(args) < 3 else args[2]
                if data is not None:
                    GLOBAL_PROFILER.copy.record("drive-write", MOVED, len(data))
            elif name in _READ_BYTES and out is not None:
                GLOBAL_PROFILER.copy.record("drive-read", COPIED, len(out))
            elif name == "read_file_into" and out:
                # readinto lands bytes in the caller's pooled window: the
                # drive boundary moves them, nothing is materialized fresh.
                GLOBAL_PROFILER.copy.record("drive-read", MOVED, int(out))
            return out

        return timed

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value  # wrapper-owned fields stay here
        else:
            setattr(self.inner, name, value)

    # -- metrics surface (healthinfo / admin info read these) ----------------

    def api_latencies(self) -> dict:
        with self._lock:
            return {
                name: {
                    "ewma_ms": round(self._lat[name], 3),
                    "count": self._counts.get(name, 0),
                    "errors": self._errors.get(name, 0),
                }
                for name in sorted(self._lat)
            }

    def reset_api_latencies(self) -> None:
        """Drop EWMAs/counts/errors (the /perf ?reset= knob): before/after
        measurements need a clean slate, not an average polluted by boot."""
        with self._lock:
            self._lat.clear()
            self._counts.clear()
            self._errors.clear()
