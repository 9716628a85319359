"""Always-on performance attribution: stage-latency ledger + slow-request capture.

The trace hub (pubsub.py) is zero-overhead BY DESIGN when nobody subscribes,
which also means the server normally has no idea where a request's time went
-- BENCH runs showed the codec sustaining ~9x the end-to-end PUT throughput
with nothing able to attribute the gap. This module is the always-on
counterpart: every finished span increments a fixed-size log2-bucket
histogram keyed by (layer, stage), whether or not anyone is watching the
hub. Recording is a bucket increment under a sharded lock -- O(microseconds)
-- so it can stay armed in production.

Three pieces:
  * StageLedger -- lock-sharded (layer, stage) -> log2 latency histogram
    (1 us .. ~134 s upper edges, then +Inf), with mergeable/serializable
    snapshots so peers can aggregate a cluster view and the bench can diff
    before/after a run.
  * SlowRequestCapture -- requests whose ROOT span exceeds a budget keep
    their full span tree in a bounded ring (count + byte capped, evictions
    counted), dumped to the audit hub when it has listeners.
  * PerfSys / GLOBAL_PERF -- the process singleton tracing.Span.finish()
    feeds unconditionally.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from .sanitizer import san_lock, san_rlock

# -- bucket scheme ------------------------------------------------------------

# Upper bucket edges in MICROSECONDS: 2^0 .. 2^27 us (1 us .. ~134 s), log2
# spaced so one fixed array spans storage-call latencies and wedged-request
# timeouts alike. Values past the last edge land in the +Inf slot.
N_BUCKETS = 28
BUCKET_LE_US = tuple(float(1 << i) for i in range(N_BUCKETS))
BUCKET_LE_S = tuple(us / 1e6 for us in BUCKET_LE_US)


def bucket_index(seconds: float) -> int:
    """Slot for a duration: smallest i with seconds <= 2^i us; N_BUCKETS
    (the +Inf slot) past the last edge. Negative/zero clamps to slot 0."""
    us = int(seconds * 1e6)
    if us <= 1:
        return 0
    i = (us - 1).bit_length()  # ceil(log2(us)) for us >= 2
    return i if i < N_BUCKETS else N_BUCKETS


class _Hist:
    __slots__ = ("counts", "sum", "cpu")

    def __init__(self):
        self.counts = [0] * (N_BUCKETS + 1)  # [..edges.., +Inf]
        self.sum = 0.0
        self.cpu = 0.0  # thread_time() seconds attributed alongside wall


# -- stage registry -----------------------------------------------------------

# Every LITERAL (layer, stage) key recorded into the ledger -- via
# tracing.span(stage, layer) marks or direct ledger.record(layer, stage, s)
# calls -- must be declared here. tools/mtpulint (stage-key rule) parses this
# literal statically and rejects marks that would mint a new unaggregated
# series no dashboard row or perf_gate threshold knows about. Adding a stage
# is a two-line diff: the mark, and its registry entry.
STAGES: frozenset = frozenset({
    # api/server.py request stages
    ("api", "auth"),
    ("api", "body-read"),
    ("api", "response-write"),
    # object/erasure.py + object/multipart.py data-path stages
    ("object", "encode"),
    ("object", "shard-fanout"),
    ("object", "commit"),
    ("object", "shard-read"),
    ("object", "frame-parse"),
    ("object", "decode"),
    # object/memcache.py hot-tier stages (direct ledger records: hits are
    # served on whatever thread asked; fills time the leader's backend read)
    ("object", "cache-hit"),
    ("object", "cache-fill"),
    ("object", "object.PutObject"),
    ("object", "object.GetObject"),
    ("object", "object.DeleteObject"),
    ("object", "object.HealObject"),
    ("object", "object.PutObjectPart"),
    ("object", "object.CompleteMultipartUpload"),
    # object/codec.py + parallel/batching.py codec spans
    ("erasure", "erasure.encode"),
    ("erasure", "erasure.encode_frames"),
    ("erasure", "erasure.encode_group"),
    ("erasure", "erasure.reconstruct"),
    # parallel/batching.py worker-side direct ledger records
    ("codec", "encode-batch"),
    ("codec", "encode-batch-small"),
    ("codec", "reconstruct-batch"),
    ("codec", "verify-batch"),
    # storage/local.py durability barriers (every fdatasync/fsync the
    # MTPU_FSYNC discipline issues; the layer is otherwise dynamic, the
    # entry documents the one literal key bench JSON reports).
    ("storage", "drive-sync"),
    # object/poolmgr.py + control/rebalance.py pool lifecycle stages
    # (attach is an in-request span; the rest are direct ledger records
    # from the drain/rebalance worker threads).
    ("pool", "attach"),
    ("pool", "drain"),
    ("pool", "move-object"),
    ("pool", "rebalance-round"),
})

# Layers whose stage names are computed at runtime (per-API root spans,
# per-peer endpoints, per-StorageAPI call names, per-op loadgen latencies,
# per-probe selftest marks -- control/selftest.py records one series per
# probe kind and target).
DYNAMIC_STAGE_LAYERS: frozenset = frozenset(
    {"api", "rpc", "rpc-peer", "storage", "loadgen", "selftest"}
)

# -- stage ledger -------------------------------------------------------------

_N_SHARDS = 8  # power of two: shard pick is a mask


class StageLedger:
    """Fixed-bucket latency histograms keyed by (layer, stage).

    Lock-sharded by key hash so concurrent recorders of different stages
    (drive fan-out threads, codec workers, the event loop) don't contend on
    one mutex. A record is: one hash, one lock, two adds.
    """

    def __init__(self):
        self._shards: list[dict[tuple[str, str], _Hist]] = [
            {} for _ in range(_N_SHARDS)
        ]
        self._locks = [san_lock("StageLedger._locks") for _ in range(_N_SHARDS)]

    def record(
        self, layer: str, stage: str, seconds: float, cpu_seconds: float = 0.0
    ) -> None:
        """One observation. `cpu_seconds` is the recorder's time.thread_time()
        delta over the same interval (0.0 when unknown -- e.g. a span that
        finished on a different thread than it started on): wall >> cpu on a
        stage means it waits (GIL or I/O), wall ~= cpu means it burns the
        core."""
        key = (layer, stage)
        si = hash(key) & (_N_SHARDS - 1)
        with self._locks[si]:
            shard = self._shards[si]
            h = shard.get(key)
            if h is None:
                h = shard[key] = _Hist()
            h.counts[bucket_index(seconds)] += 1
            h.sum += seconds
            h.cpu += cpu_seconds

    def snapshot(self) -> dict:
        """JSON/msgpack-able copy: {"buckets_us": [...], "stages":
        {layer: {stage: {"counts": [...], "sum": s}}}}. Mergeable with
        merge_snapshots() -- peers ship these for the cluster view."""
        stages: dict[str, dict[str, dict]] = {}
        for lock, shard in zip(self._locks, self._shards):
            with lock:
                items = [(k, list(h.counts), h.sum, h.cpu) for k, h in shard.items()]
            for (layer, stage), counts, total, cpu in items:
                stages.setdefault(layer, {})[stage] = {
                    "counts": counts,
                    "sum": total,
                    "cpu": cpu,
                }
        return {"buckets_us": list(BUCKET_LE_US), "stages": stages}

    def reset(self) -> None:
        for lock, shard in zip(self._locks, self._shards):
            with lock:
                shard.clear()


def merge_snapshots(snaps: list[dict]) -> dict:
    """Element-wise sum of ledger snapshots (associative + commutative --
    the cluster view must not depend on peer answer order). Snapshots with
    a different bucket count (version skew) are skipped rather than
    corrupting the merge."""
    out: dict[str, dict[str, dict]] = {}
    for snap in snaps:
        if not snap or len(snap.get("buckets_us", ())) != N_BUCKETS:
            continue
        for layer, stages in snap.get("stages", {}).items():
            dst_layer = out.setdefault(layer, {})
            for stage, h in stages.items():
                dst = dst_layer.get(stage)
                if dst is None:
                    dst_layer[stage] = {
                        "counts": list(h["counts"]),
                        "sum": float(h["sum"]),
                        # Tolerate pre-cpu snapshots (version skew): missing
                        # cpu merges as zero instead of corrupting the sum.
                        "cpu": float(h.get("cpu", 0.0)),
                    }
                else:
                    dst["counts"] = [
                        a + b for a, b in zip(dst["counts"], h["counts"])
                    ]
                    dst["sum"] += h["sum"]
                    dst["cpu"] = dst.get("cpu", 0.0) + float(h.get("cpu", 0.0))
    return {"buckets_us": list(BUCKET_LE_US), "stages": out}


def quantile(counts: list[int], q: float) -> float:
    """Estimated q-quantile in SECONDS from a bucket array: the upper edge
    of the bucket holding the q-th observation (correct to within one
    bucket width by construction). The +Inf slot reports twice the last
    finite edge -- a sentinel, not a measurement."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0 or cum >= total:
            if i >= N_BUCKETS:
                return BUCKET_LE_S[-1] * 2
            return BUCKET_LE_S[i]
    return BUCKET_LE_S[-1] * 2


def bucket_max(counts: list[int]) -> float:
    """Upper edge (SECONDS) of the highest non-empty bucket: the tightest
    bound on the worst observation the bucket scheme can give. The +Inf
    slot reports the same sentinel as quantile() -- twice the last edge."""
    for i in range(len(counts) - 1, -1, -1):
        if counts[i]:
            return BUCKET_LE_S[-1] * 2 if i >= N_BUCKETS else BUCKET_LE_S[i]
    return 0.0


def summarize(snap: dict) -> dict:
    """Admin-payload shape: per (layer, stage) count/total plus
    p50/p95/p99/p99.9/max (milliseconds -- the unit operators reason about
    request stages in). Tail SLOs need more than p99: a stage can hold its
    p99 while its p99.9 and max walk off into timeout territory."""
    out: dict[str, dict[str, dict]] = {}
    for layer, stages in snap.get("stages", {}).items():
        for stage, h in stages.items():
            counts = h["counts"]
            n = sum(counts)
            out.setdefault(layer, {})[stage] = {
                "count": n,
                "total_ms": round(h["sum"] * 1e3, 3),
                "cpu_seconds": round(h.get("cpu", 0.0), 6),
                "mean_ms": round(h["sum"] / n * 1e3, 3) if n else 0.0,
                "p50_ms": round(quantile(counts, 0.50) * 1e3, 3),
                "p95_ms": round(quantile(counts, 0.95) * 1e3, 3),
                "p99_ms": round(quantile(counts, 0.99) * 1e3, 3),
                "p999_ms": round(quantile(counts, 0.999) * 1e3, 3),
                "max_ms": round(bucket_max(counts) * 1e3, 3),
            }
    return out


# -- ops/s time series --------------------------------------------------------

# Op classes the per-second ring aggregates S3 APIs into. A bounded, closed
# set on purpose: the ring holds one latency histogram PER CLASS PER SECOND,
# so an unbounded per-API keyspace would turn a 300 s window into an
# unbounded allocation. Dashboards that need per-API detail read the
# cumulative histograms in MetricsSys; the ring answers "what is this
# cluster's QPS shape RIGHT NOW".
OP_CLASSES = ("put", "get", "delete", "list", "other")


def op_class(api: str) -> str:
    """Coarse op class for an S3 API name (PutObject -> put, ListObjectsV2
    -> list). Multipart writes count as puts -- they are the write path."""
    if api.startswith(("Put", "Post", "Complete", "NewMultipart", "Copy", "Upload")):
        return "put"
    if api.startswith(("Get", "Head", "Select")):
        return "get"
    if api.startswith(("Delete", "Abort", "Remove")):
        return "delete"
    if api.startswith("List"):
        return "list"
    return "other"


class _TsCell:
    __slots__ = ("count", "errors", "bytes", "counts")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.bytes = 0
        self.counts = [0] * (N_BUCKETS + 1)


class OpsTimeSeries:
    """Per-second op-class ring: the always-on requests/second axis.

    `window_s` one-second slots (MTPU_TIMESERIES_WINDOW_S, default 300),
    each holding per-op-class count / errors / bytes plus the same
    log2-bucket latency histogram the stage ledger uses -- so per-second
    p99 falls out of quantile() instead of needing raw samples. A slot is
    reused in place when its epoch second comes around again (classic ring:
    index = second mod window), so memory is bounded by
    window * |OP_CLASSES| regardless of load or uptime.

    Snapshots are mergeable across peers (merge_timeseries) the same way
    ledger snapshots are: per-(second, class) element-wise sums, so the
    cluster QPS view is exact, not sampled.
    """

    def __init__(self, window_s: int | None = None):
        self.window_s = max(
            10, window_s if window_s is not None
            else _env_int("MTPU_TIMESERIES_WINDOW_S", 300)
        )
        # slot: None or [second, {op_class: _TsCell}]
        self._slots: list = [None] * self.window_s
        self._lock = san_lock("OpsTimeSeries._lock")

    def record(
        self,
        cls: str,
        seconds: float,
        ok: bool = True,
        nbytes: int = 0,
        now: float | None = None,
    ) -> None:
        """One finished request. `now` is injectable for ring-math tests."""
        t = int(now if now is not None else time.time())
        with self._lock:
            i = t % self.window_s
            slot = self._slots[i]
            if slot is None or slot[0] != t:
                slot = self._slots[i] = [t, {}]
            cell = slot[1].get(cls)
            if cell is None:
                cell = slot[1][cls] = _TsCell()
            cell.count += 1
            if not ok:
                cell.errors += 1
            cell.bytes += nbytes
            cell.counts[bucket_index(seconds)] += 1

    def snapshot(self, now: float | None = None) -> dict:
        """Mergeable copy: seconds ascending, raw histogram counts included
        (summarize_timeseries() turns them into p99 for the wire). Slots
        older than the window at `now` are dead ring positions awaiting
        reuse and are excluded."""
        t_now = int(now if now is not None else time.time())
        series = []
        with self._lock:
            for slot in self._slots:
                if slot is None or slot[0] <= t_now - self.window_s:
                    continue
                classes = {
                    cls: {
                        "count": c.count,
                        "errors": c.errors,
                        "bytes": c.bytes,
                        "counts": list(c.counts),
                    }
                    for cls, c in slot[1].items()
                }
                series.append({"t": slot[0], "classes": classes})
        series.sort(key=lambda e: e["t"])
        return {
            "window_s": self.window_s,
            "buckets_us": list(BUCKET_LE_US),
            "series": series,
        }

    def rates(self, horizon_s: int = 60, now: float | None = None) -> dict:
        """Trailing per-class {ops_per_s, errors_per_s, bytes_per_s} over
        min(horizon, window) seconds -- what the Prometheus gauges export."""
        t_now = int(now if now is not None else time.time())
        horizon = min(max(1, horizon_s), self.window_s)
        agg: dict[str, list] = {}
        with self._lock:
            for slot in self._slots:
                if slot is None or not (t_now - horizon < slot[0] <= t_now):
                    continue
                for cls, c in slot[1].items():
                    row = agg.get(cls)
                    if row is None:
                        row = agg[cls] = [0, 0, 0]
                    row[0] += c.count
                    row[1] += c.errors
                    row[2] += c.bytes
        return {
            cls: {
                "ops_per_s": round(row[0] / horizon, 3),
                "errors_per_s": round(row[1] / horizon, 3),
                "bytes_per_s": round(row[2] / horizon, 1),
            }
            for cls, row in agg.items()
        }

    def reset(self) -> None:
        with self._lock:
            self._slots = [None] * self.window_s


def merge_timeseries(snaps: list[dict]) -> dict:
    """Element-wise merge of ring snapshots keyed by (second, class) --
    associative and commutative like merge_snapshots, so the cluster QPS
    view is independent of peer answer order. Bucket-count skew (a peer on
    a different histogram version) skips that snapshot."""
    merged: dict[int, dict[str, dict]] = {}
    window = 0
    for snap in snaps:
        if not snap or len(snap.get("buckets_us", ())) != N_BUCKETS:
            continue
        window = max(window, int(snap.get("window_s", 0)))
        for entry in snap.get("series", ()):
            t = int(entry.get("t", 0))
            dst_classes = merged.setdefault(t, {})
            for cls, c in entry.get("classes", {}).items():
                dst = dst_classes.get(cls)
                if dst is None:
                    dst_classes[cls] = {
                        "count": int(c["count"]),
                        "errors": int(c["errors"]),
                        "bytes": int(c["bytes"]),
                        "counts": list(c["counts"]),
                    }
                else:
                    dst["count"] += c["count"]
                    dst["errors"] += c["errors"]
                    dst["bytes"] += c["bytes"]
                    dst["counts"] = [a + b for a, b in zip(dst["counts"], c["counts"])]
    return {
        "window_s": window,
        "buckets_us": list(BUCKET_LE_US),
        "series": [
            {"t": t, "classes": merged[t]} for t in sorted(merged)
        ],
    }


def summarize_timeseries(snap: dict) -> dict:
    """Wire shape for /mtpu/admin/v1/timeseries: per second per class
    count/errors/bytes plus p99_ms from the bucket histogram; raw counts
    dropped (the merged cluster payload would otherwise be ~30x larger)."""
    series = []
    for entry in snap.get("series", ()):
        classes = {
            cls: {
                "count": c["count"],
                "errors": c["errors"],
                "bytes": c["bytes"],
                "p99_ms": round(quantile(c["counts"], 0.99) * 1e3, 3),
            }
            for cls, c in entry.get("classes", {}).items()
        }
        series.append({"t": entry["t"], "classes": classes})
    return {"window_s": snap.get("window_s", 0), "series": series}


# -- slow-request capture -----------------------------------------------------


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SlowRequestCapture:
    """Retain the full span tree of requests slower than a budget.

    Spans are buffered per trace while the request runs (only for traces
    this node ROOTED -- begin_trace()); when the root span finishes, the
    buffer is either promoted into the capture ring (root duration >= the
    budget) or discarded. Every buffer and the ring itself is hard-capped
    (count AND bytes) with eviction counters, so a pathological workload
    bounds observer memory instead of growing it.

    Knobs (env): MTPU_SLOW_REQUEST_SECONDS (budget, default 1.0),
    MTPU_SLOW_TRACE_RING (captures kept, default 32),
    MTPU_SLOW_TRACE_RING_BYTES (approx byte cap, default 4 MiB),
    MTPU_SLOW_TRACE_SPANS (spans kept per trace, default 512).
    """

    _APPROX_SPAN_BYTES = 200  # accounting unit: one buffered span record

    def __init__(
        self,
        budget_s: float | None = None,
        max_traces: int | None = None,
        max_bytes: int | None = None,
        max_spans_per_trace: int | None = None,
        max_live_traces: int = 1024,
    ):
        self.budget_s = (
            budget_s
            if budget_s is not None
            else _env_float("MTPU_SLOW_REQUEST_SECONDS", 1.0)
        )
        self.max_traces = (
            max_traces if max_traces is not None else _env_int("MTPU_SLOW_TRACE_RING", 32)
        )
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else _env_int("MTPU_SLOW_TRACE_RING_BYTES", 4 << 20)
        )
        self.max_spans_per_trace = (
            max_spans_per_trace
            if max_spans_per_trace is not None
            else _env_int("MTPU_SLOW_TRACE_SPANS", 512)
        )
        # In-flight traces are bounded too: a root span that never finishes
        # (crashed handler, wedged stream) must not pin its buffer forever.
        self.max_live_traces = max_live_traces
        self._pending: "OrderedDict[str, list[dict]]" = OrderedDict()
        self._ring: deque[dict] = deque()
        self._ring_bytes = 0
        self._lock = san_lock("SlowRequestCapture._lock")
        self.captured_total = 0
        self.evicted_spans = 0  # spans dropped from over-full trace buffers
        self.evicted_traces = 0  # buffers/captures dropped by the caps

    def begin_trace(self, trace_id: str) -> None:
        if not trace_id:
            return
        with self._lock:
            if trace_id in self._pending:
                return
            while len(self._pending) >= self.max_live_traces:
                self._pending.popitem(last=False)
                self.evicted_traces += 1
            self._pending[trace_id] = []

    def wants(self, trace_id: str) -> bool:
        """Lock-free membership peek: the hot path builds a span record
        only for traces this node is actually buffering."""
        return trace_id in self._pending

    def observe(self, rec: dict, is_root: bool, duration_s: float) -> None:
        """Called by Span.finish() for buffered traces. Root spans settle
        the trace: capture when over budget, drop otherwise."""
        trace_id = rec.get("trace", "")
        entry = None
        with self._lock:
            buf = self._pending.get(trace_id)
            if buf is None:
                return
            if len(buf) < self.max_spans_per_trace:
                buf.append(rec)
            else:
                self.evicted_spans += 1
            if not is_root:
                return
            del self._pending[trace_id]
            if duration_s < self.budget_s:
                return
            entry = {
                "trace": trace_id,
                "root": rec.get("name", ""),
                "layer": rec.get("layer", ""),
                "duration_ms": round(duration_s * 1e3, 3),
                "time": time.time(),
                "spans": buf,
            }
            self.captured_total += 1
            self._ring.append(entry)
            self._ring_bytes += self._APPROX_SPAN_BYTES * (len(buf) + 1)
            while self._ring and (
                len(self._ring) > self.max_traces or self._ring_bytes > self.max_bytes
            ):
                old = self._ring.popleft()
                self._ring_bytes -= self._APPROX_SPAN_BYTES * (
                    len(old.get("spans", ())) + 1
                )
                self.evicted_traces += 1
        # Audit dump outside the lock: listeners (audit targets / the live
        # audit hub) see each capture as one record.
        if entry is not None:
            try:
                from .logging import GLOBAL_LOGGER

                GLOBAL_LOGGER.audit(
                    api="SlowRequestCapture",
                    request_id=trace_id,
                    duration_ms=entry["duration_ms"],
                    root=entry["root"],
                    span_count=len(entry["spans"]),
                )
            except Exception:  # noqa: BLE001 - capture must never fail a request
                pass

    def list(self) -> list[dict]:
        with self._lock:
            return list(reversed(self._ring))  # newest first

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_ms": round(self.budget_s * 1e3, 3),
                "captured_total": self.captured_total,
                "retained": len(self._ring),
                "retained_bytes_approx": self._ring_bytes,
                "pending_traces": len(self._pending),
                "evicted_spans": self.evicted_spans,
                "evicted_traces": self.evicted_traces,
                "max_traces": self.max_traces,
                "max_bytes": self.max_bytes,
                "max_spans_per_trace": self.max_spans_per_trace,
            }

    def reset(self) -> None:
        """Drop retained captures (the ?reset= knob). Cumulative eviction/
        capture counters survive -- they are rate signals, not state."""
        with self._lock:
            self._ring.clear()
            self._ring_bytes = 0


# -- process singleton --------------------------------------------------------


class PerfSys:
    """What tracing.Span.finish() feeds: the ledger unconditionally, the
    slow capture only for traces rooted on this node."""

    def __init__(self):
        self.ledger = StageLedger()
        self.slow = SlowRequestCapture()
        # The ops/s time-series ring is NOT reset by /perf?reset -- it is a
        # continuous axis (dashboards difference it), not a measurement
        # window.
        self.timeseries = OpsTimeSeries()
        # Late-bound flight-recorder hook (control/flight.py installs its
        # singleton here at import): flight reads this module, so the feed
        # direction must not become an import cycle. Root spans land in the
        # flight ring PRE-SAMPLING -- the black box sees every request even
        # when MTPU_TRACE_SAMPLE thins hub publication.
        self.flight = None

    def on_span_finish(
        self, span, duration_s: float, error: str | None, cpu_s: float = 0.0
    ) -> None:
        self.ledger.record(span.layer, span.name, duration_s, cpu_s)
        fl = self.flight
        if fl is not None and span.parent_id == "":
            fl.record_span(span, duration_s, error)
        if span.trace_id and self.slow.wants(span.trace_id):
            rec = {
                "name": span.name,
                "layer": span.layer,
                "trace": span.trace_id,
                "span": span.span_id,
                "parent": span.parent_id,
                "duration_ms": round(duration_s * 1e3, 3),
            }
            if span.tags:
                rec.update(span.tags)
            if error:
                rec["error"] = error
            self.slow.observe(rec, is_root=span.parent_id == "", duration_s=duration_s)


GLOBAL_PERF = PerfSys()
