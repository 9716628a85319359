"""Live-cluster self-measurement: object speedtest, drive probe, peer netperf.

Role of the reference's admin performance probes (cmd/speedtest.go
speedTest, cmd/perf-drive.go driveSpeedTest, cmd/perf-net.go netperf):
every number the offline harnesses (bench.py, tools/loadgen.py) produce is
measured on an idle dev box -- a production fleet must be able to measure
ITSELF, under its real drive stacks, breakers, and peer links. Three probes:

  * object speedtest -- autotuned-concurrency PUT/GET rounds against a
    reserved scratch bucket on the live cluster, every node driving load
    concurrently (the admin node fans a round out per peer), reporting
    per-node and aggregate GiB/s AND ops/s plus a scaling-efficiency
    verdict: aggregate / (N x best single node). Linear scale-out ~1.0;
    a shared bottleneck (one slow drive, a saturated link) shows up as the
    verdict, not as a mystery.
  * drive probe -- sequential/random read-write passes through the real
    StorageAPI stack per drive (MeteredDrive / breaker wrappers included,
    results keyed by drive path), so the number prices what requests
    actually traverse, not the bare device.
  * peer netperf -- pooled buffers streamed between every node pair over
    dist/transport.py, yielding the full-mesh bandwidth/latency matrix
    that prices replication, heal fan-in, and future repair-code traffic.

Probes are themselves observable: every run emits spans and ("selftest",
...) stage-ledger records, so a probe running under production load is
attributable in /mtpu/admin/v1/perf. And probes ride the SAME chaos hooks
as real traffic -- an armed fault fails the probe (its report says so),
never the node.

Scratch data is invisible and unleakable: the reserved `.mtpu-speedtest`
bucket is dot-prefixed (hidden from ListBuckets/usage/replication, and the
S3 API's bucket-name validation makes it unreachable by clients), every
probe deletes what it wrote in a finally block, and restart recovery
(storage/recovery.py) sweeps the whole volume -- an aborted probe leaves
debris for at most one restart.

Knobs (env, all overridable per-request in the POST body):
  MTPU_SELFTEST_SIZE            object/netperf payload bytes (default 1 MiB)
  MTPU_SELFTEST_CONCURRENCY     autotune ramp start (default 4)
  MTPU_SELFTEST_MAX_CONCURRENCY autotune ramp ceiling (default 32)
  MTPU_SELFTEST_DRIVE_MB        per-drive probe file size (default 4 MiB)
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

from ..utils import errors
from ..utils.bufpool import BufferPool
from . import tracing
from .perf import GLOBAL_PERF, _env_int
from .sanitizer import san_lock

# Reserved scratch bucket. Dot-prefixed on purpose: the object layer hides
# dot buckets from ListBuckets, the scanner/replication planes enumerate via
# list_buckets, and ServerPools._validate_bucket_name rejects dot names at
# the S3 surface -- so the bucket is structurally invisible to clients.
# storage/recovery.py sweeps this name at restart (kept as a literal there
# to avoid a storage -> control import; test_selftest pins them equal).
SCRATCH_BUCKET = ".mtpu-speedtest"

# Autotune: keep doubling concurrency while the aggregate improves by more
# than this factor (the reference's ~2.5% bar, cmd/speedtest.go:100).
IMPROVEMENT_BAR = 1.025


class SelfTestStats:
    """Probe counters, rendered by control/metrics.py (the mtpulint
    metrics-rendered rule covers this class: a counter bumped here must
    appear in the exposition)."""

    def __init__(self):
        self._lock = san_lock("SelfTestStats._lock")
        self.object_runs = 0
        self.drive_runs = 0
        self.net_runs = 0
        self.probe_failures = 0
        self.scratch_cleanups = 0

    def record_run(self, probe: str, ok: bool) -> None:
        with self._lock:
            if probe == "object":
                self.object_runs += 1
            elif probe == "drive":
                self.drive_runs += 1
            elif probe == "net":
                self.net_runs += 1
            if not ok:
                self.probe_failures += 1

    def record_cleanup(self) -> None:
        with self._lock:
            self.scratch_cleanups += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "object_runs": self.object_runs,
                "drive_runs": self.drive_runs,
                "net_runs": self.net_runs,
                "probe_failures": self.probe_failures,
                "scratch_cleanups": self.scratch_cleanups,
            }


STATS = SelfTestStats()

# Last completed result per probe kind: GET /speedtest/{kind} serves this
# (a speedtest is expensive; operators re-read the result without re-running).
_last_lock = san_lock("selftest._last_lock")
_last: dict[str, dict] = {}


def last_result(kind: str) -> dict | None:
    with _last_lock:
        return _last.get(kind)


def _store_result(kind: str, result: dict) -> dict:
    result = dict(result)
    result["finished_at"] = time.time()
    with _last_lock:
        _last[kind] = result
    return result


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------


def autotune(round_fn, start: int = 4, max_concurrency: int = 32,
             improvement: float = IMPROVEMENT_BAR):
    """Concurrency ramp: double while throughput keeps improving.

    `round_fn(concurrency)` runs one measured round and returns a dict with
    a `score` (aggregate bytes/s). Returns (best_entry, ramp) where each
    ramp entry is the round's dict plus its concurrency. Stops at the first
    step whose score fails to beat the best by `improvement` -- MinIO's
    speedtest autotune shape (ramping past the knee just queues)."""
    ramp: list[dict] = []
    best = None  # (index into ramp, score)
    c = max(1, start)
    while c <= max_concurrency:
        r = dict(round_fn(c))
        r["concurrency"] = c
        ramp.append(r)
        score = float(r.get("score", 0.0))
        if best is None or score > best[1] * improvement:
            best = (len(ramp) - 1, score)
            c *= 2
        else:
            break
    return ramp[best[0]], ramp


# ---------------------------------------------------------------------------
# object speedtest
# ---------------------------------------------------------------------------


def _resolve_pool(layer):
    """First erasure pool of a ServerPools; a bare ErasureSets/ErasureObjects
    (the test harnesses hand these out directly) is its own pool."""
    pools = getattr(layer, "pools", None)
    return pools[0] if pools else layer


def ensure_scratch_bucket(layer) -> None:
    """Create the scratch volume at the ERASURE layer (below the S3 name
    validation that rightly rejects dot buckets from clients)."""
    try:
        _resolve_pool(layer).make_bucket(SCRATCH_BUCKET)
    except errors.BucketExists:
        pass


def cleanup_scratch(layer) -> int:
    """Best-effort removal of every scratch object plus the bucket itself.
    Returns the number of objects deleted. Never raises: cleanup runs in
    finally blocks and on probes that already failed."""
    removed = 0
    pool = _resolve_pool(layer)
    list_fn = getattr(pool, "list_objects", None)
    try:
        while list_fn is not None:
            listing = list_fn(SCRATCH_BUCKET, max_keys=1000)
            if not listing.objects:
                break
            for o in listing.objects:
                try:
                    pool.delete_object(SCRATCH_BUCKET, o.name)
                    removed += 1
                except errors.StorageError:
                    pass
            if not listing.is_truncated:
                break
    except errors.StorageError:
        pass
    try:
        pool.delete_bucket(SCRATCH_BUCKET, force=True)
    except errors.StorageError:
        pass
    STATS.record_cleanup()
    return removed


def run_object_round(layer, size: int, n_ops: int, workers: int,
                     tag: str = "local") -> dict:
    """One node's PUT+GET round at fixed concurrency against the scratch
    bucket. Runs on the node being measured (the admin node fans this out
    per peer); object names are uuid-scoped so concurrent nodes never
    collide. Raises StorageError on failure -- including injected chaos
    faults -- after cleaning its own objects."""
    ensure_scratch_bucket(layer)
    pool = _resolve_pool(layer)
    payload = os.urandom(size)
    names = [
        f"probe/{tag}/{uuid.uuid4().hex[:12]}-{i}" for i in range(n_ops)
    ]
    with tracing.span("object-probe", "selftest", node=tag, workers=workers):
        try:
            with ThreadPoolExecutor(max_workers=workers) as tp:
                t0 = time.perf_counter()
                list(tp.map(lambda n: pool.put_object(SCRATCH_BUCKET, n, payload), names))
                put_t = time.perf_counter() - t0
                t0 = time.perf_counter()
                list(tp.map(lambda n: pool.get_object(SCRATCH_BUCKET, n), names))
                get_t = time.perf_counter() - t0
        finally:
            for n in names:
                try:
                    pool.delete_object(SCRATCH_BUCKET, n)
                except errors.StorageError:
                    pass
    GLOBAL_PERF.ledger.record("selftest", "object-put", put_t)
    GLOBAL_PERF.ledger.record("selftest", "object-get", get_t)
    total = size * n_ops
    return {
        "put_bytes_per_s": total / put_t if put_t else 0.0,
        "get_bytes_per_s": total / get_t if get_t else 0.0,
        "put_ops_per_s": n_ops / put_t if put_t else 0.0,
        "get_ops_per_s": n_ops / get_t if get_t else 0.0,
        "ops": n_ops,
    }


def _gib(bps: float) -> float:
    return round(bps / (1 << 30), 4)


def object_speedtest(
    layer,
    peers: list | None = None,
    node_url: str = "local",
    size: int | None = None,
    start: int | None = None,
    max_concurrency: int | None = None,
    ops_per_worker: int = 2,
) -> dict:
    """Cluster-wide autotuned object speedtest (the admin POST handler).

    At each ramp step every node -- this one plus each peer, concurrently
    -- drives `concurrency` workers of PUT+GET load through its own object
    layer. Aggregate throughput is the sum over nodes (they ran at the same
    time); the scaling verdict compares it against N perfect copies of the
    best single node."""
    size = size if size else _env_int("MTPU_SELFTEST_SIZE", 1 << 20)
    start = start if start else _env_int("MTPU_SELFTEST_CONCURRENCY", 4)
    max_concurrency = max_concurrency if max_concurrency else _env_int(
        "MTPU_SELFTEST_MAX_CONCURRENCY", 32
    )
    peers = list(peers or [])

    def round_at(concurrency: int) -> dict:
        n_ops = max(1, concurrency * ops_per_worker)
        nodes: dict[str, dict] = {}

        def one_node(url, run):
            # A fault (real or chaos-armed) fails the PROBE: the report
            # carries the error under that node's key, the node keeps
            # serving.
            try:
                return url, {**run(), "ok": True}
            except errors.StorageError as e:
                return url, {"ok": False, "error": f"{type(e).__name__}: {e}"}

        tasks = [
            lambda: one_node(
                node_url,
                lambda: run_object_round(layer, size, n_ops, concurrency, tag="coord"),
            )
        ] + [
            (lambda p=p: one_node(
                p.url,
                lambda p=p: p.selftest_object(size=size, ops=n_ops, workers=concurrency),
            ))
            for p in peers
        ]
        with ThreadPoolExecutor(max_workers=len(tasks)) as tp:
            for fut in [tp.submit(t) for t in tasks]:
                url, r = fut.result()
                nodes[url] = r
        ok_nodes = [r for r in nodes.values() if r.get("ok")]
        agg_put = sum(r["put_bytes_per_s"] for r in ok_nodes)
        agg_get = sum(r["get_bytes_per_s"] for r in ok_nodes)
        return {
            "score": agg_put + agg_get,
            "nodes": nodes,
            "aggregate": {
                "put_bytes_per_s": agg_put,
                "get_bytes_per_s": agg_get,
                "put_gibs": _gib(agg_put),
                "get_gibs": _gib(agg_get),
                "put_ops_per_s": round(sum(r["put_ops_per_s"] for r in ok_nodes), 2),
                "get_ops_per_s": round(sum(r["get_ops_per_s"] for r in ok_nodes), 2),
                "total_ops_per_s": round(
                    sum(r["put_ops_per_s"] + r["get_ops_per_s"] for r in ok_nodes), 2
                ),
            },
        }

    with tracing.span("object-speedtest", "selftest", size=size):
        try:
            best, ramp = autotune(round_at, start=start,
                                  max_concurrency=max_concurrency)
        finally:
            cleanup_scratch(layer)

    nodes = best["nodes"]
    ok_nodes = {u: r for u, r in nodes.items() if r.get("ok")}
    all_ok = bool(ok_nodes) and len(ok_nodes) == len(nodes)
    n = len(ok_nodes)
    best_single = max(
        (r["put_bytes_per_s"] + r["get_bytes_per_s"] for r in ok_nodes.values()),
        default=0.0,
    )
    agg_total = (best["aggregate"]["put_bytes_per_s"]
                 + best["aggregate"]["get_bytes_per_s"])
    efficiency = agg_total / (n * best_single) if n and best_single else 0.0
    verdict = ("linear" if efficiency >= 0.8 else
               "sublinear" if efficiency >= 0.5 else "poor")
    result = {
        "ok": all_ok,
        "probe": "object",
        "size": size,
        "concurrency": best["concurrency"],
        "nodes": {
            url: (
                {
                    "ok": True,
                    "put_gibs": _gib(r["put_bytes_per_s"]),
                    "get_gibs": _gib(r["get_bytes_per_s"]),
                    "put_ops_per_s": round(r["put_ops_per_s"], 2),
                    "get_ops_per_s": round(r["get_ops_per_s"], 2),
                }
                if r.get("ok")
                else r
            )
            for url, r in nodes.items()
        },
        "aggregate": best["aggregate"],
        "scaling": {
            "nodes": n,
            "efficiency": round(efficiency, 3),
            "verdict": verdict,
            "best_single_node_gibs": _gib(best_single),
        },
        "ramp": [
            {
                "concurrency": r["concurrency"],
                "put_gibs": r["aggregate"]["put_gibs"],
                "get_gibs": r["aggregate"]["get_gibs"],
                "total_ops_per_s": r["aggregate"]["total_ops_per_s"],
            }
            for r in ramp
        ],
    }
    STATS.record_run("object", all_ok)
    return _store_result("object", result)


# ---------------------------------------------------------------------------
# drive probe
# ---------------------------------------------------------------------------


def _probe_one_drive(drive, size: int, files: int, rand_reads: int) -> dict:
    """Sequential write / sequential read / random 4 KiB read passes through
    one StorageAPI stack. Cleans its files in finally; raises on fault."""
    payload = os.urandom(size)
    prefix = f"drv/{uuid.uuid4().hex[:12]}"
    try:
        drive.make_vol(SCRATCH_BUCKET)
    except errors.VolumeExists:
        pass
    buf = bytearray(size)
    try:
        with tracing.span("drive-probe", "selftest", drive=drive.endpoint()):
            t0 = time.perf_counter()
            for i in range(files):
                drive.create_file(SCRATCH_BUCKET, f"{prefix}/f{i}", payload)
            seq_write_t = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(files):
                drive.read_file_into(
                    SCRATCH_BUCKET, f"{prefix}/f{i}", 0, memoryview(buf)
                )
            seq_read_t = time.perf_counter() - t0
            t0 = time.perf_counter()
            span = max(1, size - 4096)
            for j in range(rand_reads):
                off = (j * 65537) % span  # deterministic scatter
                drive.read_file(SCRATCH_BUCKET, f"{prefix}/f{j % files}", off, 4096)
            rand_t = time.perf_counter() - t0
    finally:
        try:
            drive.delete(SCRATCH_BUCKET, prefix, recursive=True)
        except errors.StorageError:
            pass
    GLOBAL_PERF.ledger.record("selftest", "drive-seq-write", seq_write_t)
    GLOBAL_PERF.ledger.record("selftest", "drive-seq-read", seq_read_t)
    GLOBAL_PERF.ledger.record("selftest", "drive-rand-read", rand_t)
    total = size * files
    return {
        "ok": True,
        "seq_write_bytes_per_s": round(total / seq_write_t, 1) if seq_write_t else 0.0,
        "seq_read_bytes_per_s": round(total / seq_read_t, 1) if seq_read_t else 0.0,
        "rand_read_iops": round(rand_reads / rand_t, 1) if rand_t else 0.0,
        "file_bytes": size,
        "files": files,
    }


def drive_probe(
    local_drives: dict,
    size: int | None = None,
    files: int = 4,
    rand_reads: int = 16,
) -> dict:
    """Per-drive perf probe through the production drive stack (the
    MeteredDrive/HealthGated/Faulty wrappers dist/node.py installs), results
    keyed by drive path. A drive whose stack raises -- breaker open, armed
    chaos fault, real IO error -- reports the error; the probe and the node
    both survive."""
    size = size if size else _env_int("MTPU_SELFTEST_DRIVE_MB", 4) << 20
    drives: dict[str, dict] = {}
    for path, drive in local_drives.items():
        try:
            drives[path] = _probe_one_drive(drive, size, files, rand_reads)
        except (errors.StorageError, OSError) as e:
            drives[path] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        finally:
            try:
                drive.delete_vol(SCRATCH_BUCKET, force=True)
            except errors.StorageError:
                pass
    all_ok = bool(drives) and all(r.get("ok") for r in drives.values())
    STATS.record_run("drive", all_ok)
    return _store_result("drive", {"ok": all_ok, "probe": "drive", "drives": drives})


# ---------------------------------------------------------------------------
# peer netperf
# ---------------------------------------------------------------------------

# Payload pool for netperf sends: the probe measures the LINK, so its own
# allocator traffic must not show up in the number. Lazily sized to the
# largest payload requested; capacity 4 bounds concurrent probe memory.
_net_pool_lock = threading.Lock()
_net_pool: BufferPool | None = None


def _acquire_net_buf(size: int):
    global _net_pool
    with _net_pool_lock:
        if _net_pool is None or _net_pool.buf_size < size:
            _net_pool = BufferPool(size, 4, name="selftest-net")
        pool = _net_pool
    return pool.acquire(size)


def netperf_row(peers: list, size: int | None = None, rounds: int = 4) -> dict:
    """THIS node's row of the mesh: bandwidth + latency to each peer, one
    pooled payload streamed `rounds` times over the peer REST transport
    (so deadline propagation, chaos hooks, and the rpc-peer ledger all see
    it). Peer entries fail independently."""
    size = size if size else _env_int("MTPU_SELFTEST_SIZE", 1 << 20)
    row: dict[str, dict] = {}
    pb = _acquire_net_buf(size)
    payload = pb.view(0, size)
    try:
        for p in peers:
            with tracing.span("net-probe", "selftest", peer=p.url):
                try:
                    t0 = time.perf_counter()
                    p.netperf_payload(b"")
                    rtt = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    for _ in range(rounds):
                        r = p.netperf_payload(payload)
                        if int(r.get("received", -1)) != size:
                            raise errors.StorageError(
                                f"netperf short receive from {p.url}"
                            )
                    dt = time.perf_counter() - t0
                    GLOBAL_PERF.ledger.record("selftest", "net-stream", dt)
                    row[p.url] = {
                        "ok": True,
                        "bytes_per_s": round(size * rounds / dt, 1) if dt else 0.0,
                        "rtt_ms": round(rtt * 1e3, 3),
                        "rounds": rounds,
                        "payload_bytes": size,
                    }
                except errors.StorageError as e:
                    row[p.url] = {"ok": False,
                                  "error": f"{type(e).__name__}: {e}"}
    finally:
        # Invalidate the probe view before the storage recycles -- this
        # frame (pinned by any in-flight traceback) must not keep a live
        # export over another probe's buffer.
        payload.release()
        pb.release()
    return row


def netperf(
    peers: list,
    node_url: str = "local",
    size: int | None = None,
    rounds: int = 4,
) -> dict:
    """Full-mesh netperf (the admin POST handler): this node's row measured
    directly, every peer's row collected via the peer REST fan-out -- each
    node streams to all ITS peers, so an N-node cluster yields the N x
    (N-1) matrix."""
    size = size if size else _env_int("MTPU_SELFTEST_SIZE", 1 << 20)
    matrix: dict[str, dict] = {}
    with tracing.span("netperf", "selftest", size=size):
        matrix[node_url] = netperf_row(peers, size=size, rounds=rounds)
        for p in peers:
            try:
                r = p.netperf_run(size=size, rounds=rounds)
                matrix[p.url] = r.get("row", {})
            except errors.StorageError as e:
                matrix[p.url] = {"_error": f"{type(e).__name__}: {e}"}
    all_ok = all(
        cell.get("ok")
        for row in matrix.values()
        for key, cell in row.items()
        if not key.startswith("_")
    ) and not any("_error" in row for row in matrix.values())
    STATS.record_run("net", all_ok)
    return _store_result("net", {
        "ok": all_ok,
        "probe": "net",
        "payload_bytes": size,
        "rounds": rounds,
        "matrix": matrix,
    })
