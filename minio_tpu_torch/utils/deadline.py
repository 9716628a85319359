"""End-to-end deadline propagation: a per-request time budget (the JAX
package's utils/deadline.py, copied whole).

Role of the reference's context deadlines (Go threads a context.Context
with a deadline through every layer; gRPC carries it cross-process as
grpc-timeout). Python has no ambient context argument, so the budget rides
a contextvar -- the same vehicle the trace span uses -- which survives
`asyncio.to_thread` for free and is copied into the drive-IO pool per task
by object/metadata.py.

Wire form: the remaining budget in seconds travels as the X-Mtpu-Deadline
header, decremented at each hop (`dist/transport.py` stamps it on every
outgoing RPC; the storage/peer/lock REST servers re-bind it around their
handlers). A 5 s client deadline therefore can never spend 30 s inside a
nested RPC: each hop caps its socket timeout at the remaining budget and
fails fast with DeadlineExceeded once the budget is spent.

The deadline is stored as an ABSOLUTE time.monotonic() instant, so nested
scopes compose by min() and "remaining" never drifts under clock skew
(monotonic is per-process; cross-node hops re-anchor from the header's
relative seconds, which is why the wire form is a duration, not an instant).
"""

from __future__ import annotations

import contextvars
import time

from . import errors

DEADLINE_HEADER = "X-Mtpu-Deadline"

# Budgets below this are noise (a hop can't do anything useful in 1 ms);
# treat them as already expired rather than arming sub-millisecond timeouts.
MIN_BUDGET = 0.001

_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "minio_tpu_deadline", default=None
)


def remaining() -> float | None:
    """Seconds left in the active budget, or None when no deadline is set.
    May be zero or negative once the budget is spent."""
    d = _deadline.get()
    if d is None:
        return None
    return d - time.monotonic()


def check(what: str = "") -> None:
    """Raise DeadlineExceeded if the active budget is spent. Sprinkled at
    loop boundaries in the object layer so a long streaming operation
    notices expiry between windows instead of running to completion."""
    rem = remaining()
    if rem is not None and rem < MIN_BUDGET:
        raise errors.DeadlineExceeded(
            f"deadline exceeded{': ' + what if what else ''} "
            f"({rem * 1e3:.0f} ms over budget)" if rem < 0 else
            f"deadline exceeded{': ' + what if what else ''}"
        )


def header_value() -> str | None:
    """Wire form of the remaining budget ('' semantics: no deadline)."""
    rem = remaining()
    if rem is None:
        return None
    return f"{max(rem, 0.0):.3f}"


def parse_header(value: str | None) -> float | None:
    """Relative seconds from an X-Mtpu-Deadline header; None when absent
    or malformed (a garbled budget must not take down the request)."""
    if not value:
        return None
    try:
        seconds = float(value)
    except ValueError:
        return None
    if seconds != seconds or seconds < 0:  # NaN / negative
        return 0.0
    return seconds


class scope:
    """Bind a deadline for the current context: `with deadline.scope(5.0):`.

    Nested scopes only ever SHRINK the budget (min of the instants) -- an
    inner layer granting itself more time than its caller would defeat
    propagation. `scope(None)` is a no-op passthrough, so call sites can
    bind an optional header value unconditionally.
    """

    __slots__ = ("_seconds", "_token")

    def __init__(self, seconds: float | None):
        self._seconds = seconds
        self._token = None

    def __enter__(self) -> "scope":
        if self._seconds is not None:
            new = time.monotonic() + self._seconds
            cur = _deadline.get()
            self._token = _deadline.set(new if cur is None else min(cur, new))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _deadline.reset(self._token)
            self._token = None
        return False


def bind_header(value: str | None) -> scope:
    """Server-side adoption of a propagated budget (the deadline twin of
    tracing.bind_header): re-anchors the header's relative seconds on this
    process's monotonic clock."""
    return scope(parse_header(value))
