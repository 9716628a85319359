"""Request-scoped distributed tracing: span trees over the pub/sub trace hub.

Role of the reference's madmin trace verbosity levels (`mc admin trace -v`
shows per-layer breakdowns: handler, object layer, storage calls per drive,
internode hops). Here every S3 request gets a trace id (== its
x-amz-request-id), each layer opens spans under the current one, and the
finished spans are published to the SAME hub the admin /trace stream serves
-- a subscriber reassembles the span tree of a request from its
(trace, span, parent) ids.

Context rules:
  * The current span rides a contextvar, so it survives `asyncio.to_thread`
    (which copies the caller's context) for free.
  * Fan-out thread pools do NOT inherit contextvars -- the drive-IO pool in
    object/metadata.py copies the caller's context per task explicitly.
  * Remote hops carry `trace:span` in the X-Mtpu-Trace header
    (dist/transport.py injects, dist/storage_rest.py + dist/peer.py adopt),
    so a distributed PUT yields ONE tree across nodes.

Overhead discipline matches pubsub.py: when nobody subscribes to the hub,
a bare `span()` outside any request returns a shared no-op and no ids are
generated. Request roots (root_span) are ALWAYS real, because every finished
span also feeds the stage ledger (control/perf.py) -- a bucket increment
that stays armed with zero subscribers, so the server can attribute where
request time went without a live trace watcher. Hub publishing remains
subscriber-gated.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import secrets
import threading
import time
from typing import Iterator

from .perf import GLOBAL_PERF
from .pubsub import GLOBAL_TRACE, TraceSys

# Trace context header for internode REST (alongside X-Mtpu-Token).
TRACE_HEADER = "X-Mtpu-Trace"

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "minio_tpu_span", default=None
)

# -- span sampling (MTPU_TRACE_SAMPLE) ----------------------------------------
#
# High-concurrency load (tools/loadgen.py) can root tens of thousands of
# requests per second; buffering every trace in the slow-request capture
# turns the observer into the bottleneck. MTPU_TRACE_SAMPLE in [0, 1] keeps
# 1-in-round(1/rate) request roots "sampled": sampled-out requests STILL
# feed the perf ledger (stage attribution stays exact -- it is bucket
# increments, not span records) and STILL publish to the hub / flight ring
# -- sampling only thins the slow-capture buffering it was built to bound.
# A live /trace watcher opted into the publication cost by subscribing, and
# the flight recorder's black box must never be blinded by the knob.
# Default 1.0 = trace all.

_sample_counter = itertools.count()  # deterministic 1-in-N, not coin flips
_sample_cached: tuple[str, float] = ("", 1.0)  # (raw env value, parsed rate)


def _sample_rate() -> float:
    """Parse MTPU_TRACE_SAMPLE lazily, memoized on the raw string so the
    knob can be flipped at runtime without a per-request float() parse."""
    global _sample_cached
    raw = os.environ.get("MTPU_TRACE_SAMPLE", "")
    cached_raw, cached_rate = _sample_cached
    if raw == cached_raw:
        return cached_rate
    try:
        rate = min(max(float(raw), 0.0), 1.0) if raw else 1.0
    except ValueError:
        rate = 1.0
    _sample_cached = (raw, rate)
    return rate


def _sample_next() -> bool:
    """Deterministic sampling decision for the next request root."""
    rate = _sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return next(_sample_counter) % max(1, round(1.0 / rate)) == 0


def _new_id() -> str:
    return secrets.token_hex(8).upper()


class Span:
    """One timed unit of work. Publishes itself to the hub on close.

    Usable as a context manager; `set(k=v)` attaches tags that ride the
    published record (status codes, byte counts, batch sizes...).
    """

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "layer",
        "sys",
        "start",
        "cpu_start",
        "tid",
        "tags",
        "sampled",
        "_token",
        "_closed",
    )

    def __init__(
        self,
        name: str,
        layer: str,
        trace_id: str,
        parent_id: str,
        sys: TraceSys,
        sampled: bool = True,
        **tags,
    ):
        self.name = name
        self.layer = layer
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.sys = sys
        self.start = time.perf_counter()
        # CPU attribution rides every span: thread_time() is per-thread, so
        # the delta is only meaningful when finish() runs on the same thread
        # -- finish() checks the ident and reports cpu=0 (unknown) otherwise.
        self.cpu_start = time.thread_time()
        self.tid = threading.get_ident()
        self.tags = tags
        self.sampled = sampled
        self._token = None
        self._closed = False

    def set(self, **tags) -> None:
        self.tags.update(tags)

    def header(self) -> str:
        """Wire form for X-Mtpu-Trace: children on the far side parent here."""
        return f"{self.trace_id}:{self.span_id}"

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish(error=exc_type.__name__ if exc_type is not None else None)
        return False

    def finish(self, error: str | None = None) -> None:
        if self._closed:
            return
        self._closed = True
        duration = time.perf_counter() - self.start
        cpu = (
            time.thread_time() - self.cpu_start
            if threading.get_ident() == self.tid
            else 0.0
        )
        # The stage ledger and flight ring record UNCONDITIONALLY --
        # attribution and the black box must not depend on someone watching
        # the hub OR on the sampling knob (control/perf.py, control/
        # flight.py); sampling only thins slow-capture buffering.
        GLOBAL_PERF.on_span_finish(self, duration, error, cpu)
        # Hub publication is subscriber-gated but PRE-SAMPLING: a live
        # /trace watcher sees every span, sampled or not.
        if not self.sys.enabled():
            return
        fields = dict(self.tags)
        if error:
            fields["error"] = error
        self.sys.publish(
            "span",
            name=self.name,
            layer=self.layer,
            trace=self.trace_id,
            span=self.span_id,
            parent=self.parent_id,
            duration_ms=round(duration * 1e3, 3),
            **fields,
        )


class _NoopSpan:
    """Shared do-nothing span for the nobody-watching fast path."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = ""
    sampled = False

    def set(self, **tags) -> None:
        pass

    def header(self) -> str:
        return ""

    def finish(self, error: str | None = None) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP = _NoopSpan()


def current() -> Span | None:
    """The active span of this context, or None outside any trace."""
    return _current.get()


def current_header() -> str:
    """Wire value propagating the ACTIVE span, '' when not tracing."""
    cur = _current.get()
    return cur.header() if cur is not None else ""


def span(name: str, layer: str, sys: TraceSys | None = None, **tags):
    """Open a child span of the current context (or a fresh root).

    Returns the shared no-op when there is NO parent span and the hub has
    no subscribers -- orphan spans (background sweeps outside any request)
    keep the zero-overhead guard. Inside a request there is always a parent
    (root_span is unconditional), so stage marks on the hot path are real
    and feed the ledger whether or not anyone watches the hub.
    """
    tsys = sys or GLOBAL_TRACE
    parent = _current.get()
    if parent is None and not tsys.enabled():
        return NOOP
    if parent is not None:
        # Children inherit the root's sampling verdict -- it records which
        # traces the slow capture buffers (a _RemoteParent has no flag: the
        # calling node already decided whether to buffer this request).
        return Span(
            name, layer, parent.trace_id, parent.span_id, tsys,
            sampled=getattr(parent, "sampled", True), **tags,
        )
    return Span(name, layer, _new_id(), "", tsys, **tags)


def root_span(name: str, layer: str, trace_id: str, sys: TraceSys | None = None, **tags):
    """Open a request root span with an EXPLICIT trace id (the S3 entry point
    uses the x-amz-request-id, so trace and audit records join on one key).

    Always a real span: the root is what arms stage attribution for the
    whole request tree (perf ledger + slow-request capture); publishing to
    the hub still costs nothing without subscribers. Under
    MTPU_TRACE_SAMPLE < 1, sampled-out roots skip slow-capture buffering
    ONLY -- they still feed the ledger, the flight ring, and any live hub
    subscriber."""
    tsys = sys or GLOBAL_TRACE
    sampled = _sample_next()
    if sampled:
        GLOBAL_PERF.slow.begin_trace(trace_id)
    return Span(name, layer, trace_id, "", tsys, sampled=sampled, **tags)


class _RemoteParent:
    """Placeholder for a span living on the calling node: children opened on
    this node chain under it, but it is never published here (the caller
    publishes the real one)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


class bind_header:
    """Adopt a wire trace context for the current (coroutine) context.

    Used by the internode REST servers around their to-thread dispatch:
    `asyncio.to_thread` copies the coroutine's context, so spans opened by
    the handler body parent under the remote caller's span.
    """

    __slots__ = ("_ctx", "_token")

    def __init__(self, header_value: str | None):
        self._ctx = parse_header(header_value)
        self._token = None

    def __enter__(self) -> "bind_header":
        if self._ctx is not None:
            self._token = _current.set(self._ctx)  # type: ignore[arg-type]
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        return False


def parse_header(value: str | None) -> _RemoteParent | None:
    if not value or ":" not in value:
        return None
    trace_id, _, span_id = value.partition(":")
    if not trace_id or not span_id:
        return None
    return _RemoteParent(trace_id, span_id)


# -- tree assembly (admin tooling + tests) -----------------------------------


def build_tree(records: list[dict], trace_id: str) -> dict[str, list[dict]]:
    """Group one trace's span records into parent -> children adjacency.

    Key '' holds the roots. Input records are hub dicts (type == 'span');
    records of other traces/types are ignored.
    """
    tree: dict[str, list[dict]] = {}
    for rec in records:
        if rec.get("type") != "span" or rec.get("trace") != trace_id:
            continue
        tree.setdefault(rec.get("parent", ""), []).append(rec)
    return tree


def walk_tree(tree: dict[str, list[dict]], parent: str = "") -> Iterator[dict]:
    """Depth-first iteration over an adjacency built by build_tree."""
    for rec in tree.get(parent, ()):
        yield rec
        yield from walk_tree(tree, rec.get("span", ""))
