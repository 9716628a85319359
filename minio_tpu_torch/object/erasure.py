"""Erasure object layer: one set of N drives storing K+M-coded objects.

Role of the reference's erasureObjects (cmd/erasure-object.go, erasure.go):
the object semantics above per-drive storage -- quorum writes with atomic
rename commit (putObject :752-1021), quorum metadata reads + shard decode
(getObjectWithFileInfo :223-357), versioned deletes with markers, and
decode+re-encode healing (erasure-healing.go:257).

This is the JAX package's object layer for one erasure set: buckets
(create, stat, list, delete), inline and streaming PUT in the streaming
bitrot layout and in the legacy whole-file layout, the healthy and degraded
streaming GET of both, metadata updates, deletes, tier transitions, heal,
and multipart uploads (object/multipart.py). Erasure math and bitrot
hashing run through a BlockCodec (object/codec.py); the batching codec
(parallel/batching.py) puts every block, reconstruct and digest on the GPU
kernels. GET-side frame verification and heal's verify go through
``codec.digests_batch``, and heal's rebuild through
``codec.reconstruct_batch(..., with_digests=True)``, so on the card they
run the HighwayHash and Reed-Solomon kernels. Whole-file
checksums are host hashes, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures as _cf
import contextvars
import hashlib
import os
import queue as _queue
import sys
import threading
import time
import uuid
from collections import deque
from typing import Iterator

from ..chaos import crash
from ..control import tracing
from ..control.degrade import GLOBAL_DEGRADE
from ..control.perf import GLOBAL_PERF
from ..control.profiler import COPIED, GLOBAL_PROFILER, MOVED
from ..ops import bitrot as bitrot_mod
from ..storage.interface import StorageAPI
from ..storage.types import ErasureInfo, FileInfo, ObjectPartInfo, now
from ..storage.xlmeta import SMALL_FILE_THRESHOLD
from ..utils import errors
from ..utils import bufpool
from ..utils import deadline
from ..utils import iopool
from ..utils.hashes import hash_order
from . import codec as codec_mod
from . import metadata as meta_mod
from .types import (
    BucketInfo,
    DeleteObjectOptions,
    GetObjectOptions,
    HealResultItem,
    ObjectInfo,
    PutObjectOptions,
)

BLOCK_SIZE = 1 << 20  # blockSizeV2 (cmd/object-api-common.go:40)
META_BUCKET = ".minio_tpu.sys"
DIGEST_LEN = 32
# Blocks per codec call on the streaming path: the put/get working set is
# O(GROUP_BLOCKS x BLOCK_SIZE), not O(objectSize), while each group is still
# a device-batchable [G, K, S] tensor (the reference streams one 1 MiB block
# at a time, erasure-encode.go:73-109; grouping keeps the device batch win).
GROUP_BLOCKS = 16

# Hedged-read policy: a shard read that has run longer than
# max(HEDGE_FLOOR, HEDGE_MULT x median completed duration) is presumed
# straggling and a hedge read is armed on the best unread slot -- the
# any-k-of-n freedom of the erasure code turned into tail-latency insurance
# (the regenerating-codes reading discipline, arXiv:1412.3022). The floor
# keeps microsecond-fast local windows from hedging on scheduler noise.
HEDGE_FLOOR = 0.05
HEDGE_MULT = 3.0
_HEDGE_POLL = 0.01  # gather loop wakeup for hedge decisions, seconds


def _rank_read_slots(by_shard: list, k: int) -> list[int]:
    """Order online shard slots for reading: ALL data slots before any
    parity slot, then lowest read_file latency EWMA (MeteredDrive's
    tracker, surfaced through the drive stack), stable by slot index.
    Slots whose drive is missing or breaker-gated offline are excluded
    entirely.

    The class must dominate the EWMA: every parity primary costs a row
    reconstruct (the decode stage and a copy a healthy read otherwise
    never pays), so a few-ms EWMA edge never buys a parity slot into the
    quorum. A genuinely slow data drive is the hedge machinery's job --
    its spare (EWMA-ranked below) decodes only when actually needed."""
    scored: list[tuple[int, float, int]] = []
    for j, d in enumerate(by_shard):
        if d is None or not d.is_online():
            continue
        ewma = 0.0
        lat_fn = getattr(d, "api_latencies", None)
        if lat_fn is not None:
            try:
                lat = lat_fn()
                row = lat.get("read_file_into") or lat.get("read_file")
                if row:
                    ewma = float(row["ewma_ms"])
            except (KeyError, TypeError, ValueError):  # ranking is advisory
                ewma = 0.0
        scored.append((0 if j < k else 1, ewma, j))
    scored.sort()
    return [j for _, _, j in scored]


# -- zero-copy window pipeline -------------------------------------------------
#
# The PUT path stages data in WINDOW_BYTES (= one codec group) windows:
# buffer-like payloads are sliced as memoryviews in place, reader payloads
# land ONCE into pooled bytearrays (utils/bufpool.py) via readinto, and
# every downstream hop -- block split, codec staging, shard fan-out --
# operates on views over that storage.

WINDOW_BYTES = GROUP_BLOCKS * BLOCK_SIZE


def _quiet_release(*views) -> None:
    """Best-effort memoryview invalidation before pooled storage recycles.

    A stale view over a recycled buffer silently reads another request's
    bytes, so owners invalidate their exports at release. A view something
    re-exported (a live np.frombuffer, a nested memoryview) refuses
    release() -- that one is left alive rather than crashing the data
    path."""
    for v in views:
        if isinstance(v, memoryview):
            try:
                v.release()
            except ValueError:
                pass


class _Window:
    """One pipeline window: a memoryview over the caller's buffer or over a
    pooled bytearray; release() recycles the latter."""

    __slots__ = ("view", "_pb", "_blocks")

    def __init__(self, view: memoryview, pb=None):
        self.view = view
        self._pb = pb
        self._blocks: list[memoryview] | None = None

    def __len__(self) -> int:
        return len(self.view)

    def blocks(self) -> list[memoryview]:
        v = self.view
        out = [v[off : off + BLOCK_SIZE] for off in range(0, len(v), BLOCK_SIZE)]
        if self._pb is not None:
            self._blocks = out
        return out

    def release(self) -> None:
        if self._pb is not None:
            # Invalidate this window's exports BEFORE the storage returns
            # to the pool -- the encoder copied what it needed, so a view
            # that survives past here is a lifetime bug, not a reader.
            _quiet_release(*(self._blocks or ()), self.view)
            self._blocks = None
            self._pb.release()
            self._pb = None


def _uniform_runs(blocks: list) -> list[list]:
    """Split a window's blocks into uniform-size runs so every run takes the
    codec's uniform scatter path (a short tail block becomes its own
    single-block group; the digest stream is per-block, so grouping never
    changes the etag)."""
    if len(blocks) > 1 and len(blocks[-1]) != len(blocks[0]):
        return [blocks[:-1], blocks[-1:]]
    return [blocks]


def _fill_window(reader, view: memoryview) -> int:
    """Fill `view` from the reader; a short count means EOF.

    readinto readers land payload straight into the window (the reader
    records its own landing hop: socket-read / sigv4-chunk-parse); the
    legacy read() fallback copies each chunk in and says so."""
    n = len(view)
    pos = 0
    ri = getattr(reader, "readinto", None)
    if ri is not None:
        while pos < n:
            got = ri(view[pos:])
            if not got:
                break
            pos += got
        if pos:
            GLOBAL_PROFILER.copy.record("erasure-stage", MOVED, pos)
        return pos
    while pos < n:
        chunk = reader.read(n - pos)
        if not chunk:
            break
        view[pos : pos + len(chunk)] = chunk
        pos += len(chunk)
    if pos:
        GLOBAL_PROFILER.copy.record("erasure-stage", COPIED, pos)
    return pos


def _buffer_windows(data) -> Iterator[_Window]:
    """Windows over an in-memory payload: pure views, no staging at all."""
    mv = memoryview(data)
    for off in range(0, len(mv), WINDOW_BYTES):
        win = mv[off : off + WINDOW_BYTES]
        GLOBAL_PROFILER.copy.record("erasure-stage", MOVED, len(win))
        yield _Window(win)


def _stream_windows(reader, pool, pb, filled: int) -> Iterator[_Window]:
    """Windows over a reader, starting from an already-filled first buffer.

    Ownership: each yielded _Window owns its pooled buffer (consumer
    releases); a buffer the generator still holds when it exits -- EOF or
    close() -- is released here, so abandoned PUTs leak nothing. The fill
    view is named so a reader failure can invalidate it before the
    finally recycles the storage (the traceback pins this frame)."""
    mv = None
    try:
        while True:
            win = _Window(pb.view(0, filled), pb)
            pb = None
            yield win
            if filled < WINDOW_BYTES:
                return  # EOF landed inside the last fill
            pb = pool.acquire()
            mv = pb.view()
            filled = _fill_window(reader, mv)
            _quiet_release(mv)
            mv = None
            if filled == 0:
                return  # payload was an exact window multiple
    finally:
        if pb is not None:
            _quiet_release(mv)
            if sys.exc_info()[0] is not None:
                # Reader raised mid-fill: its traceback may pin slices of
                # the fill view in frames this code cannot reach.
                pb.discard()
            else:
                pb.release()


class _ReadaheadWindows:
    """Pipelined PUT read stage: a 'put-stager' thread fills window g+1
    while the caller encodes / fans out window g (the write mirror of the
    GET readahead). Depth = MTPU_PUT_READAHEAD windows in flight."""

    def __init__(self, src, depth: int):
        self._src = src
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="put-stager", daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for win in self._src:
                if not self._put(("win", win)):
                    win.release()  # consumer gone; recycle, stop reading
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced to the PUT loop
            self._put(("err", e))
            return
        self._put(("end", None))

    def __iter__(self) -> "_ReadaheadWindows":
        return self

    def __next__(self) -> _Window:
        kind, val = self._q.get()
        if kind == "win":
            return val
        if kind == "err":
            raise val
        raise StopIteration

    def close(self) -> None:
        """Stop the stager, recycle queued windows, join the thread."""
        self._stop.set()
        try:
            while True:
                kind, val = self._q.get_nowait()
                if kind == "win":
                    val.release()
        except _queue.Empty:
            pass
        self._t.join(timeout=10)
        closer = getattr(self._src, "close", None)
        if closer is not None:
            closer()


def _wrap_readahead(src):
    depth = int(os.environ.get("MTPU_PUT_READAHEAD", "1"))
    return _ReadaheadWindows(src, depth) if depth > 0 else src


class _WindowBufs:
    """Pooled-buffer registry for one GET window.

    Shard reads land in pooled buffers whose views outlive the reading
    thread (hedged stragglers finish after the gather loop exits); the
    registry owns every buffer a window's reads produce and releases them
    all once the window's chunks have been consumed. add() after close()
    returns False -- a straggler that completes late still owns its
    buffer and must recycle it after dropping its own views (its result
    is discarded anyway)."""

    __slots__ = ("_lock", "_bufs", "_closed")

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: list = []
        self._closed = False

    def add(self, pb) -> bool:
        with self._lock:
            if not self._closed:
                self._bufs.append(pb)
                return True
        return False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            bufs, self._bufs = self._bufs, []
        for pb in bufs:
            # The stream contract lets the consumer keep yielded chunk
            # views past the stream itself: a buffer still exported here
            # is demoted to a discard (allocator-owned, never repooled)
            # instead of recycling under the holder's feet.
            pb.release_or_discard()


def _block_pieces(rows, chunk: int, s: int, e: int):
    """Yield row views covering block bytes [s, e) -- the zero-copy
    replacement for _join_block_rows on the streaming path. Block byte x
    lives in data row x // chunk at offset x % chunk (shard rows are
    uniformly `chunk` bytes; the tail row's padding sits past e)."""
    j0, j1 = s // chunk, (e - 1) // chunk
    for j in range(j0, j1 + 1):
        a = s - j * chunk if j == j0 else 0
        b = e - j * chunk if j == j1 else chunk
        r = rows[j]
        yield r if (a == 0 and b == len(r)) else r[a:b]


class _GetStager:
    """Pipelined GET read stage: a 'get-stager' thread runs window g+1's
    shard reads + bitrot verify while the caller writes window g to the
    response (the read twin of _ReadaheadWindows). Items are
    (chunks, close) units; close() recycles the window's pooled buffers
    and MUST be called by whoever consumes (or drops) the unit.

    The source generator runs under a copy of the caller's context:
    tracing spans stay parented to the request and the deadline budget
    keeps applying inside the stager thread."""

    def __init__(self, src, depth: int):
        self._src = src
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        ctx = contextvars.copy_context()
        self._t = threading.Thread(
            target=ctx.run, args=(self._run,), name="get-stager", daemon=True
        )
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for unit in self._src:
                if not self._put(("unit", unit)):
                    unit[1]()  # consumer gone; recycle the window's buffers
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced to the GET loop
            self._put(("err", e))
            return
        self._put(("end", None))

    def __iter__(self) -> "_GetStager":
        return self

    def __next__(self):
        kind, val = self._q.get()
        if kind == "unit":
            return val
        if kind == "err":
            raise val
        raise StopIteration

    def close(self) -> None:
        """Stop the stager, recycle queued windows, join the thread."""
        self._stop.set()
        try:
            while True:
                kind, val = self._q.get_nowait()
                if kind == "unit":
                    val[1]()
        except _queue.Empty:
            pass
        self._t.join(timeout=10)
        closer = getattr(self._src, "close", None)
        if closer is not None:
            closer()


def data_windows(data) -> "Iterator[_Window]":
    """bytes-like | .read()/.readinto() stream -> window iterator (the
    multipart entry point; put_object opens the stream itself so it can
    peek the first window for the inline-threshold decision)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return _buffer_windows(data)
    if hasattr(data, "read") or hasattr(data, "readinto"):
        pool = bufpool.window_pool()
        pb = pool.acquire()
        mv = pb.view()
        try:
            filled = _fill_window(data, mv)
        except BaseException:
            # The propagating traceback pins the reader's frames, which may
            # hold slices of `mv` this code cannot reach -- discard the
            # storage instead of recycling it.
            _quiet_release(mv)
            pb.discard()
            raise
        _quiet_release(mv)
        return _wrap_readahead(_stream_windows(data, pool, pb, filled))
    raise TypeError(f"put data must be bytes or a reader, got {type(data)!r}")


class _PipelinedMD5:
    """ETag MD5 computed on a side thread, overlapping the encode+hash C
    calls (both release the GIL): on multi-core hosts the ~0.6 GiB/s MD5
    disappears from the PUT critical path; the reference gets the same
    overlap from its io.Pipe'd hash.Reader stage (object-api-utils.go)."""

    def __init__(self):
        import queue as _q

        self._h = hashlib.md5()
        self._q: "_q.Queue[bytes | None]" = _q.Queue(maxsize=32)
        self._error: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True, name="etag-md5")
        self._t.start()

    def _run(self) -> None:
        while True:
            b = self._q.get()
            if b is None:
                return
            try:
                self._h.update(b)
            except BaseException as e:  # noqa: BLE001 - surfaced to the PUT
                # Keep draining so the producer never blocks on a full
                # queue; the error re-raises at the next update/hexdigest
                # (a dead worker silently truncating the ETag would persist
                # a wrong digest with a 200).
                self._error = e

    def update(self, block: bytes) -> None:
        if self._error is not None:
            raise self._error
        self._q.put(block)

    def shutdown(self) -> None:
        """Stop the worker without a digest (failed put)."""
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()

    def hexdigest(self) -> str:
        self.shutdown()
        if self._error is not None:
            raise self._error
        return self._h.hexdigest()


def make_etag_md5():
    """Pipelined MD5 when a second core can actually run it (affinity-aware);
    plain hashlib on one core where the handoff queue is pure overhead."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    return _PipelinedMD5() if cores > 1 else hashlib.md5()


def _etag_update(h, view) -> None:
    """Feed a window block to the etag hasher. The pipelined hasher's queue
    holds blocks PAST the window's release, so it gets a private copy; the
    synchronous hasher consumes the view in place."""
    if isinstance(h, _PipelinedMD5):
        h.update(bytes(view))  # hashed on a side thread after the window is recycled
    else:
        h.update(view)


def use_fast_etag(opts) -> bool:
    """Streaming PUTs default to the digest-stream etag (free: the bitrot
    digests are already computed per group). MTPU_FAST_ETAG=0 restores the
    content-md5 etag; a client-declared Content-MD5 (opts.etag) always
    wins so the header contract stays exact."""
    return (
        not opts.etag
        and not opts.bitrot_algorithm
        and os.environ.get("MTPU_FAST_ETAG", "1") != "0"
    )


class ShardStageWriter:
    """Grouped-encode + per-drive staged shard appends with quorum tracking.

    The streaming-write engine shared by put_object and multipart part
    uploads: each GROUP_BLOCKS batch of 1 MiB blocks goes through the codec
    as one scatter-encode call, and each drive gets its whole group frame as
    ONE gathered append (append_iov) submitted on that drive's I/O lane
    (utils/iopool.py) -- writes overlap the next group's read+encode, with
    per-drive FIFO keeping the staged file's append order. Failed drives are
    dropped as their writes are harvested; the caller checks `alive()`
    against its write quorum and MUST call drain() (success) or abort()
    (failure) so no write is in flight when it commits or deletes tmp files.
    (The reference's parallelWriter + Encode loop, erasure-encode.go:29-109.)
    """

    def __init__(self, codec, disks, distribution, k: int, m: int, stage_path, algo=None):
        """stage_path(i) -> staged shard-file path under META_BUCKET.

        `algo`: a non-streaming BitrotAlgorithm writes the LEGACY whole-file
        layout (raw shard bytes + one running checksum per row,
        cmd/bitrot-whole.go:30); None/streaming writes interleaved frames.
        """
        self.codec = codec
        self.disks = disks
        self.distribution = distribution
        self.k, self.m = k, m
        self.stage_path = stage_path
        self.algo = algo if algo is not None and not algo.streaming else None
        self._hashers = (
            [self.algo.new() for _ in range(k + m)] if self.algo is not None else None
        )
        self.ok = [d is not None for d in disks]
        self._appended = False
        self._lanes = iopool.shard_writer_pool()
        self._pending: deque = deque()  # deque[list[(drive index, Future)]]
        # In-flight group bound: memory stays O(inflight x group frames)
        # while write g-1 overlaps encode g.
        self._inflight = max(1, int(os.environ.get("MTPU_PUT_INFLIGHT", "2")))

    def finalize(self) -> None:
        """Ensure staged shard files exist before commit. Appends create
        files on demand (open "ab"), so this only does IO for zero-byte
        payloads — which must still commit a real, empty shard file."""
        if self._appended:
            return

        def mk(i):
            if not self.ok[i]:
                return
            self.disks[i].create_file(META_BUCKET, self.stage_path(i), b"")

        for i, (_, e) in enumerate(meta_mod.parallel_map(mk, range(len(self.disks)))):
            if e is not None:
                self.ok[i] = False

    def _collect(self, futs) -> None:
        for i, f in futs:
            try:
                f.result()
            except Exception:  # drive marked failed; the quorum check raises
                self.ok[i] = False

    def _reap(self) -> None:
        """Harvest groups whose writes have all landed, without blocking."""
        while self._pending and all(f.done() for _, f in self._pending[0]):
            self._collect(self._pending.popleft())

    def append_group(self, group: list) -> bytes | None:
        """Encode one uniform group and submit each drive's gathered append.

        Returns the group's data-row digest stream (the fast-etag input) on
        the streaming layout, None on the legacy whole-file layout. Writes
        are asynchronous: a drive failure surfaces in ok[] at the next
        harvest (or drain()), exactly like the reference's parallelWriter
        noticing a broken disk one buffer later. Each drive receives its
        whole group frame as iovec views over the encoder's buffer -- the
        fan-out moves bytes without joining them."""
        if not group:
            return None
        # Stage marks feed the always-on perf ledger: "encode" is the codec
        # call, "shard-fanout" the blocking part of the staged appends -- the
        # two halves of where a streaming PUT's group time goes.
        with tracing.span("encode", "object", blocks=len(group)):
            if self._hashers is None:
                eg = self.codec.encode_group(group, self.k, self.m)
            else:
                # Whole-file layout: raw chunks, one running digest per row.
                encoded = self.codec.encode(group, self.k, self.m)
                row_frames = []
                for row in range(self.k + self.m):
                    chunks = [e[0][row] for e in encoded]
                    for c in chunks:
                        self._hashers[row].update(c)
                    row_frames.append(b"".join(chunks))
        self._appended = True

        if self._hashers is not None:
            # Each drive's row is appended synchronously.
            def wr(i):
                if not self.ok[i]:
                    return
                row = self.distribution[i] - 1
                self.disks[i].append_file(META_BUCKET, self.stage_path(i), row_frames[row])

            GLOBAL_PROFILER.copy.record(
                "shard-fanout", MOVED, sum(len(f) for f in row_frames)
            )
            with tracing.span("shard-fanout", "object", drives=len(self.disks)):
                for i, (_, e) in enumerate(meta_mod.parallel_map(wr, range(len(self.disks)))):
                    if e is not None:
                        self.ok[i] = False
            return None

        GLOBAL_PROFILER.copy.record(
            "shard-fanout", MOVED, sum(eg.row_nbytes(r) for r in range(self.k + self.m))
        )
        self._reap()
        while len(self._pending) >= self._inflight:
            with tracing.span("shard-fanout", "object", drives=len(self.disks)):
                self._collect(self._pending.popleft())
        futs = []
        for i, d in enumerate(self.disks):
            if not self.ok[i]:
                continue
            row = self.distribution[i] - 1
            futs.append(
                (
                    i,
                    self._lanes.submit(
                        d.endpoint(), d.append_iov, META_BUCKET, self.stage_path(i), eg.iovecs[row]
                    ),
                )
            )
        self._pending.append(futs)
        return eg.digest_stream

    def drain(self) -> None:
        """Block until every in-flight group write has landed; ok[] is final
        after this returns. Callers drain before commit AND before deleting
        staged files (a late write racing a tmp cleanup would resurrect the
        file)."""
        if not self._pending:
            return
        with tracing.span("shard-fanout", "object", drives=len(self.disks)):
            while self._pending:
                self._collect(self._pending.popleft())

    def abort(self) -> None:
        self.drain()

    def alive(self) -> int:
        return sum(self.ok)

    def whole_checksums(self) -> list[bytes] | None:
        """Per-row whole-file digests (legacy layout only)."""
        if self._hashers is None:
            return None
        return [h.digest() for h in self._hashers]


_NS_LOCK_SINGLETON = None
_NS_LOCK_GUARD = threading.Lock()


def _process_ns_lock():
    """Shared per-process namespace lock (single-node default)."""
    global _NS_LOCK_SINGLETON
    with _NS_LOCK_GUARD:  # sets built in parallel must share one lock
        if _NS_LOCK_SINGLETON is None:
            from ..dist.locks import NamespaceLock

            _NS_LOCK_SINGLETON = NamespaceLock()
        return _NS_LOCK_SINGLETON


def default_parity(drive_count: int) -> int:
    """Drive-count-based default parity (getDefaultParityBlocks,
    cmd/format-erasure.go:873)."""
    if drive_count == 1:
        return 0
    if drive_count <= 3:
        return 1
    if drive_count <= 5:
        return 2
    if drive_count <= 7:
        return 3
    return 4


def _join_block_rows(rows, k: int, need: int) -> bytes:
    """Join the first k shard rows into EXACTLY `need` bytes of block data.

    Shards pad the tail (k*chunk >= block length); trimming the tail rows
    first makes the join itself produce the block."""
    pieces: list = []
    for j in range(k):
        r = rows[j]
        take = min(len(r), need)
        pieces.append(r if take == len(r) else memoryview(r)[:take])
        need -= take
        if need <= 0:
            break
    return b"".join(pieces)


def _whole_layout(metas) -> bool:
    """Majority vote across drive metas on the whole-file-bitrot layout.

    The quorum FileInfo representative is an arbitrary matching drive, and
    erasure.checksums is per-drive (excluded from the quorum key) -- one
    drive with a lost or spurious checksums list must not flip the decoder
    for a healthy object."""
    votes = [bool(m.erasure.checksums) for m in metas if m is not None]
    return bool(votes) and sum(votes) * 2 > len(votes)


def _whole_sum_matches(meta: FileInfo, part_number: int, blob: bytes) -> bool:
    """Verify a raw whole-file-bitrot row blob against the per-part checksum
    in the drive's own metadata (cmd/bitrot-whole.go:62 wholeBitrotReader
    semantics). Shared by the GET and heal paths."""
    ent = next(
        (c for c in meta.erasure.checksums if c.get("part") == part_number), None
    )
    if ent is None:
        return False
    try:
        algo = bitrot_mod.BitrotAlgorithm(ent.get("algo", ""))
        want = bytes.fromhex(ent.get("hash", ""))
    except ValueError:
        return False
    return bitrot_mod.digest_of(blob, algo) == want


def _frame_shard(chunks: list[bytes], digests: list[bytes]) -> bytes:
    """Interleave digest||chunk frames (streaming bitrot file layout)."""
    parts: list[bytes] = []
    for d, c in zip(digests, chunks):
        parts.append(d)
        parts.append(c)
    return b"".join(parts)


def _parse_frames(
    blob: bytes, chunk_sizes: list[int]
) -> list[tuple[memoryview, memoryview]]:
    """Split a shard file image back into (digest, chunk) frames.

    Frames are zero-copy memoryview slices of the blob -- a GET window
    used to copy every digest+chunk out of the image before verifying;
    consumers (join / np.frombuffer / == bytes) all take buffers."""
    out = []
    pos = 0
    mv = memoryview(blob)
    for sz in chunk_sizes:
        d = mv[pos : pos + DIGEST_LEN]
        c = mv[pos + DIGEST_LEN : pos + DIGEST_LEN + sz]
        if len(d) != DIGEST_LEN or len(c) != sz:
            raise errors.FileCorrupt("short shard file")
        out.append((d, c))
        pos += DIGEST_LEN + sz
    return out


def _verify_frames(codec, parsed) -> list[bool]:
    """Bitrot-verify every frame of one shard row window with ONE
    ``codec.digests_batch`` call -- on the batching codec, one device
    HighwayHash launch per chunk length (the full blocks, then a short
    tail)."""
    digs = codec.digests_batch([c for _, c in parsed])
    return [digs[i] == parsed[i][0] for i in range(len(parsed))]


def _shard_chunk_sizes(total_size: int, k: int) -> list[int]:
    """Per-block shard chunk sizes for an object of total_size bytes."""
    sizes = []
    full_blocks, last = divmod(total_size, BLOCK_SIZE)
    shard = -(-BLOCK_SIZE // k)
    sizes.extend([shard] * full_blocks)
    if last:
        sizes.append(-(-last // k))
    return sizes


class ErasureObjects:
    """One erasure set: object operations over a fixed list of drives."""

    def __init__(
        self,
        disks: list[StorageAPI | None],
        parity: int | None = None,
        codec: codec_mod.BlockCodec | None = None,
        set_index: int = 0,
        pool_index: int = 0,
        ns_lock=None,
        rrs_parity: int | None = None,
    ):
        self.disks = disks
        # Where this set sits in its pool and the pool in the server pools.
        self.set_index = set_index
        self.pool_index = pool_index
        self.parity = default_parity(len(disks)) if parity is None else parity
        # REDUCED_REDUNDANCY parity (storageclass RRS, default EC:2), never
        # above the standard class.
        self.rrs_parity = min(
            self.parity, 2 if rrs_parity is None else rrs_parity
        )
        # None = resolve the process-wide codec lazily per call.
        self._codec = codec
        # Partial-write hook: called (bucket, object, version_id) when a put
        # met quorum but missed some drives, so a caller can queue an async
        # repair (the reference's addPartial -> MRF feed,
        # cmd/erasure-object.go:1430).
        self.on_partial = None
        # Namespace lock: serializes writers per object. Defaults to a
        # process-local locker; Node.build swaps in the dsync quorum lockers
        # (reference: NSLock via dsync, cmd/erasure-object.go:933-941).
        self.ns_lock = ns_lock if ns_lock is not None else _process_ns_lock()
        # Bucket-info cache: every object op starts with a bucket check that
        # fans a stat_vol to all drives. Positive entries only, short TTL (the
        # reference keeps buckets in an always-warm metadata cache,
        # cmd/bucket-metadata-sys.go); a bucket deleted elsewhere is seen
        # within the TTL window.
        self._bucket_cache: dict[str, tuple[float, BucketInfo]] = {}
        self._bucket_cache_ttl = float(os.environ.get("MINIO_TPU_BUCKET_CACHE_TTL", "2.0"))

    # ------------------------------------------------------------------ util

    @property
    def codec(self) -> codec_mod.BlockCodec:
        return self._codec if self._codec is not None else codec_mod.default_codec()

    @property
    def multipart(self):
        """Lazy multipart manager (object/multipart.py)."""
        if not hasattr(self, "_multipart"):
            from .multipart import MultipartManager

            self._multipart = MultipartManager(self)
        return self._multipart

    @property
    def drive_count(self) -> int:
        return len(self.disks)

    def _online(self) -> list[StorageAPI | None]:
        return [d if d is not None and d.is_online() else None for d in self.disks]

    # ---------------------------------------------------------------- bucket

    def make_bucket(self, bucket: str) -> None:
        def mk(d):
            if d is None:
                raise errors.DiskNotFound()
            d.make_vol(bucket)

        results = meta_mod.parallel_map(mk, self._online())
        errs = [e for _, e in results]
        n_ok = sum(1 for e in errs if e is None)
        n_exists = sum(1 for e in errs if isinstance(e, errors.VolumeExists))
        quorum = self.drive_count // 2 + 1
        if n_exists > n_ok:
            raise errors.BucketExists(bucket)
        if n_ok + n_exists < quorum:
            raise errors.ErasureWriteQuorum(bucket)

    def _check_bucket(self, bucket: str) -> None:
        """Bucket-existence gate for hot object paths (raises BucketNotFound;
        result discarded — the cached get_bucket_info does the work)."""
        self.get_bucket_info(bucket)

    def invalidate_bucket_cache(self, bucket: str = "") -> None:
        """Drop cached bucket info (all buckets when name is empty) — the
        hook for bucket deletes made through another layer."""
        if bucket:
            self._bucket_cache.pop(bucket, None)
        else:
            self._bucket_cache.clear()

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        cached = self._bucket_cache.get(bucket)
        if cached is not None and cached[0] > time.monotonic():
            return cached[1]

        def stat(d):
            if d is None:
                raise errors.DiskNotFound()
            return d.stat_vol(bucket)

        results = meta_mod.parallel_map(stat, self._online())
        vols = [r for r, _ in results if r is not None]
        errs = [e for _, e in results]
        if not vols:
            count, err = errors.reduce_errs(errs)
            if isinstance(err, errors.VolumeNotFound):
                raise errors.BucketNotFound(bucket)
            raise err or errors.BucketNotFound(bucket)
        info = BucketInfo(name=bucket, created=min(v.created for v in vols))
        self._bucket_cache[bucket] = (time.monotonic() + self._bucket_cache_ttl, info)
        return info

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        # Invalidate before AND after the fan-out: a concurrent check racing
        # the rm could re-cache a still-present volume mid-delete.
        self._bucket_cache.pop(bucket, None)

        def rm(d):
            if d is None:
                raise errors.DiskNotFound()
            d.delete_vol(bucket, force=force)

        results = meta_mod.parallel_map(rm, self._online())
        self._bucket_cache.pop(bucket, None)
        errs = [e for _, e in results]
        n_ok = sum(1 for e in errs if e is None)
        n_missing = sum(1 for e in errs if isinstance(e, errors.VolumeNotFound))
        if any(isinstance(e, errors.VolumeNotEmpty) for e in errs):
            raise errors.BucketNotEmpty(bucket)
        if n_missing > n_ok:
            raise errors.BucketNotFound(bucket)
        quorum = self.drive_count // 2 + 1
        if n_ok + n_missing < quorum:
            raise errors.ErasureWriteQuorum(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        """Aggregate bucket listing across ALL online drives (the reference
        merges per-drive ListVols, cmd/erasure-sets.go ListBuckets), instead
        of trusting whichever drive answers first: a drive that missed a
        MakeBucket (or kept a deleted one) must not define the namespace.
        A bucket counts if at least half the responding drives hold it."""

        def vols(d):
            if d is None:
                raise errors.DiskNotFound()
            return d.list_vols()

        results = meta_mod.parallel_map(vols, self._online())
        seen: dict[str, tuple[float, int]] = {}  # name -> (earliest ctime, count)
        responders = 0
        for vol_list, err in results:
            if err is not None or vol_list is None:
                continue
            responders += 1
            for v in vol_list:
                if v.name.startswith("."):
                    continue
                created, count = seen.get(v.name, (v.created, 0))
                seen[v.name] = (min(created, v.created), count + 1)
        if responders == 0:
            return []
        quorum = max(1, (responders + 1) // 2)
        return sorted(
            (
                BucketInfo(name, created)
                for name, (created, count) in seen.items()
                if count >= quorum
            ),
            key=lambda b: b.name,
        )

    # ------------------------------------------------------------------- put

    def put_object(
        self, bucket: str, object_name: str, data, opts: PutObjectOptions | None = None
    ) -> ObjectInfo:
        """Streaming erasure put: `data` is bytes or a .read(n) stream.

        Blocks are encoded + hashed in GROUP_BLOCKS batches and the shard
        frames appended to per-drive staged files as they are produced, so
        memory stays O(GROUP_BLOCKS x BLOCK_SIZE) regardless of object size
        (the reference's per-1MiB-block loop, erasure-encode.go:73-109, with
        the blocks grouped into device batches). Objects smaller than the
        inline threshold take the one-shot xl.meta-inline path."""
        opts = opts or PutObjectOptions()
        self._check_bucket(bucket)  # raises BucketNotFound

        n = self.drive_count
        m = self.parity
        if (opts.storage_class or "").upper() == "REDUCED_REDUNDANCY" and self.parity > 0:
            m = max(self.rrs_parity, 1)
            opts.user_defined = {**opts.user_defined, "x-internal-storage-class": "REDUCED_REDUNDANCY"}
        k = n - m
        distribution = hash_order(f"{bucket}/{object_name}", n)
        version_id = opts.version_id or (str(uuid.uuid4()) if opts.versioned else "")
        mod_time = now()

        # Validate the bitrot algorithm up front; naming the default
        # streaming algorithm explicitly is the default layout, not legacy.
        wants_whole = False
        if opts.bitrot_algorithm:
            try:
                wants_whole = not bitrot_mod.BitrotAlgorithm(opts.bitrot_algorithm).streaming
            except ValueError:
                raise errors.InvalidArgument(
                    bucket, object_name,
                    f"unknown bitrot algorithm {opts.bitrot_algorithm!r}",
                ) from None

        with tracing.span(
            "object.PutObject", "object", bucket=bucket, object=object_name
        ) as sp:
            # Whole-file bitrot objects always take the streaming (shard-file)
            # path: the legacy layout has no inline representation. Buffer
            # payloads are windowed as views in place; readers land once into a
            # pooled window -- peeked here for the inline decision.
            if isinstance(data, (bytes, bytearray, memoryview)):
                if len(data) < SMALL_FILE_THRESHOLD and not wants_whole:
                    oi = self._put_inline(
                        bucket, object_name, data, opts, k, m, distribution, version_id, mod_time
                    )
                else:
                    oi = self._put_streaming(
                        bucket, object_name, _buffer_windows(data), opts, k, m,
                        distribution, version_id, mod_time,
                    )
            elif hasattr(data, "read") or hasattr(data, "readinto"):
                pool = bufpool.window_pool()
                pb = pool.acquire()
                mv = pb.view()
                try:
                    filled = _fill_window(data, mv)
                except BaseException:
                    # The propagating traceback pins the reader's frames,
                    # which may hold slices of `mv` this code cannot reach
                    # -- discard the storage instead of recycling it.
                    _quiet_release(mv)
                    pb.discard()
                    raise
                _quiet_release(mv)
                if filled < SMALL_FILE_THRESHOLD and not wants_whole:
                    head = bytes(pb.view(0, filled))  # the inline blob outlives the pooled window
                    pb.release()
                    oi = self._put_inline(
                        bucket, object_name, head, opts, k, m, distribution, version_id, mod_time
                    )
                else:
                    windows = _wrap_readahead(_stream_windows(data, pool, pb, filled))
                    oi = self._put_streaming(
                        bucket, object_name, windows, opts, k, m,
                        distribution, version_id, mod_time,
                    )
            else:
                raise TypeError(
                    f"put_object data must be bytes or a reader, got {type(data)!r}"
                )
            sp.set(size=oi.size)
            return oi

    def _make_put_fi(
        self,
        bucket: str,
        object_name: str,
        shard_row: int,
        *,
        k: int,
        m: int,
        size: int,
        distribution,
        version_id: str,
        mod_time: float,
        data_dir: str,
        base_meta: dict,
        inline_blob: bytes = b"",
        checksums: list[dict] | None = None,
    ) -> FileInfo:
        return FileInfo(
            volume=bucket,
            name=object_name,
            version_id=version_id,
            data_dir=data_dir,
            mod_time=mod_time,
            size=size,
            metadata=dict(base_meta),
            parts=[ObjectPartInfo(1, size, actual_size=size, mod_time=mod_time)],
            erasure=ErasureInfo(
                data_blocks=k,
                parity_blocks=m,
                block_size=BLOCK_SIZE,
                index=shard_row + 1,
                distribution=list(distribution),
                checksums=list(checksums or []),
            ),
            inline_data=inline_blob,
        )

    def _put_inline(
        self, bucket, object_name, data: bytes, opts, k, m, distribution, version_id, mod_time
    ) -> ObjectInfo:
        """Small object: shards inline in xl.meta, one codec call."""
        size = len(data)
        etag = opts.etag or hashlib.md5(data).hexdigest()
        blocks = [data[i : i + BLOCK_SIZE] for i in range(0, size, BLOCK_SIZE)]
        with tracing.span("encode", "object", blocks=len(blocks)):
            encoded = self.codec.encode(blocks, k, m) if blocks else []
        shard_files = [
            _frame_shard([e[0][row] for e in encoded], [e[1][row] for e in encoded])
            for row in range(k + m)
        ]
        write_quorum = k + 1 if k == m else k
        base_meta = {"etag": etag, "content-type": opts.content_type, **opts.user_defined}

        def write_one(args) -> None:
            i, disk = args
            if disk is None:
                raise errors.DiskNotFound()
            shard_row = distribution[i] - 1
            fi = self._make_put_fi(
                bucket,
                object_name,
                shard_row,
                k=k,
                m=m,
                size=size,
                distribution=distribution,
                version_id=version_id,
                mod_time=mod_time,
                data_dir="",
                base_meta=base_meta,
                inline_blob=shard_files[shard_row],
            )
            disk.write_metadata(bucket, object_name, fi)

        # Inline puts have no staging: the metadata write IS the commit.
        with tracing.span("commit", "object", drives=self.drive_count):
            lk = self.ns_lock.new(bucket, object_name)
            if not lk.acquire(writer=True, timeout=30):
                raise errors.ErasureWriteQuorum(
                    bucket, object_name, "namespace lock timeout"
                )
            try:
                results = meta_mod.parallel_map(write_one, list(enumerate(self._online())))
            finally:
                lk.release()
        errs = [e for _, e in results]
        n_ok = sum(1 for e in errs if e is None)
        if n_ok < write_quorum:
            self._cleanup_failed_put(bucket, object_name, version_id, errs)
            raise errors.ErasureWriteQuorum(
                bucket, object_name, f"write quorum {write_quorum} not met ({n_ok} ok)"
            )
        if n_ok < len(errs) and self.on_partial is not None:
            self.on_partial(bucket, object_name, version_id)
        fi = self._make_put_fi(
            bucket,
            object_name,
            distribution[0] - 1,
            k=k,
            m=m,
            size=size,
            distribution=distribution,
            version_id=version_id,
            mod_time=mod_time,
            data_dir="",
            base_meta=base_meta,
        )
        fi.is_latest = True
        oi = ObjectInfo.from_file_info(fi, bucket, object_name)
        oi.etag = etag
        return oi

    def _put_streaming(
        self, bucket, object_name, windows, opts, k, m, distribution,
        version_id, mod_time,
    ) -> ObjectInfo:
        """Large object: pipelined window encode + gathered staged appends,
        committed with rename_data under the namespace lock. `windows`
        yields _Window views (released here as each group's encode lands)."""
        n = k + m
        data_dir = str(uuid.uuid4())
        # pid-scoped staging, the same tmp naming as the JAX package, so a
        # recovery scan can tell whose stage files these are.
        upload_id = f"{os.getpid()}.{uuid.uuid4()}"
        write_quorum = k + 1 if k == m else k
        disks = self._online()
        size = 0

        def tmp_dir(i: int) -> str:
            return f"tmp/{upload_id}/{i}"

        whole_algo = None
        if opts.bitrot_algorithm:
            whole_algo = bitrot_mod.BitrotAlgorithm(opts.bitrot_algorithm)
            if whole_algo.streaming:
                whole_algo = None  # streaming IS the default layout
        writer = ShardStageWriter(
            self.codec, disks, distribution, k, m, lambda i: f"{tmp_dir(i)}/part.1",
            algo=whole_algo,
        )
        ok = writer.ok

        def cleanup(indices) -> None:
            def rm(i):
                d = disks[i]
                if d is None:
                    return
                try:
                    d.delete(META_BUCKET, f"tmp/{upload_id}", recursive=True)
                except errors.StorageError:
                    pass

            meta_mod.parallel_map(rm, list(indices))

        # Etag strategy: digest-stream md5 rides the encode for free; the
        # content-md5 etag (MTPU_FAST_ETAG=0 / explicit algorithms) hashes
        # blocks as they stream.
        # Created immediately before the try so every failure path reaches
        # the shutdown handler.
        etag_h = hashlib.md5() if use_fast_etag(opts) else None
        md5h = make_etag_md5() if (not opts.etag and etag_h is None) else None
        try:
            try:
                for win in windows:
                    # Budget check at the window boundary: an expired
                    # deadline aborts into the cleanup path below (stage
                    # shards deleted locally, no budget needed), so a slow
                    # client or slow drives can't stream past the caller's
                    # patience.
                    try:
                        deadline.check("erasure put")
                    except errors.DeadlineExceeded:
                        GLOBAL_DEGRADE.record_deadline_abort("erasure-put")
                        raise
                    blocks = win.blocks()
                    size += len(win)
                    if md5h is not None:
                        for b in blocks:
                            _etag_update(md5h, b)
                    for run in _uniform_runs(blocks):
                        stream = writer.append_group(run)
                        if etag_h is not None and stream:
                            etag_h.update(stream)
                    # The group's writes hold encoder-owned views, never the
                    # window -- recycle it before the next read lands.
                    win.release()
                    # One window's groups appended (pre-sync, pre-drain):
                    # dying here leaves partial stage files + a checked-out
                    # readahead window for the recovery scan to account for.
                    crash.crash_point("put.after-stage")
                    if writer.alive() < write_quorum:
                        raise errors.ErasureWriteQuorum(
                            bucket, object_name, f"write quorum {write_quorum} lost mid-stream"
                        )
                writer.drain()
                writer.finalize()  # zero-byte payloads still commit a shard file
                if writer.alive() < write_quorum:
                    raise errors.ErasureWriteQuorum(
                        bucket, object_name, f"write quorum {write_quorum} lost mid-stream"
                    )
            except BaseException:
                # Writes must settle before cleanup deletes tmp (a late
                # append racing the delete would resurrect the staged file).
                writer.abort()
                if isinstance(md5h, _PipelinedMD5):
                    md5h.shutdown()  # never leak the etag thread on a failed put
                cleanup(range(n))
                raise
        finally:
            closer = getattr(windows, "close", None)
            if closer is not None:
                closer()  # stop the stager thread, recycle queued windows

        etag = opts.etag or (etag_h.hexdigest() if etag_h is not None else md5h.hexdigest())
        base_meta = {"etag": etag, "content-type": opts.content_type, **opts.user_defined}
        row_sums = writer.whole_checksums()
        # All shards staged + drained, no xl.meta exists anywhere yet: the
        # un-acked object must be invisible after restart.
        crash.crash_point("put.before-commit")

        def commit(i) -> None:
            if not ok[i]:
                raise errors.DiskNotFound()
            # Fires on the (skip+1)-th drive entering commit: skip=j models
            # dying with exactly j drives' rename_data already durable
            # (partial-quorum commit). `raise` mode degrades just that drive.
            crash.crash_point("put.mid-commit", disks[i].endpoint() if disks[i] else "")
            shard_row = distribution[i] - 1
            checksums = None
            if row_sums is not None:
                checksums = [
                    {
                        "part": 1,
                        "algo": whole_algo.value,
                        "hash": row_sums[shard_row].hex(),
                    }
                ]
            fi = self._make_put_fi(
                bucket,
                object_name,
                shard_row,
                k=k,
                m=m,
                size=size,
                distribution=distribution,
                version_id=version_id,
                mod_time=mod_time,
                data_dir=data_dir,
                base_meta=base_meta,
                checksums=checksums,
            )
            disks[i].rename_data(META_BUCKET, tmp_dir(i), fi, bucket, object_name)

        # The commit stage covers lock wait + rename_data quorum fan-out:
        # both are serialization costs the encode pipeline can't hide.
        with tracing.span("commit", "object", drives=n):
            lk = self.ns_lock.new(bucket, object_name)
            if not lk.acquire(writer=True, timeout=30):
                cleanup(range(n))
                raise errors.ErasureWriteQuorum(
                    bucket, object_name, "namespace lock timeout"
                )
            try:
                results = meta_mod.parallel_map(commit, list(range(n)))
            finally:
                lk.release()
        errs = [e for _, e in results]
        n_ok = sum(1 for e in errs if e is None)
        # Drop stragglers' staging dirs (committed drives' tmp dirs were
        # consumed by rename_data).
        cleanup([i for i, e in enumerate(errs) if e is not None])
        if n_ok < write_quorum:
            self._cleanup_failed_put(bucket, object_name, version_id, errs)
            raise errors.ErasureWriteQuorum(
                bucket, object_name, f"write quorum {write_quorum} not met ({n_ok} ok)"
            )
        if n_ok < len(errs) and self.on_partial is not None:
            self.on_partial(bucket, object_name, version_id)
        # Quorum reached but the client never saw the 200: after restart the
        # object may exist (it reached quorum) -- if it does, it must be
        # complete and bit-identical, never partially visible.
        crash.crash_point("put.after-commit")
        fi = self._make_put_fi(
            bucket,
            object_name,
            distribution[0] - 1,
            k=k,
            m=m,
            size=size,
            distribution=distribution,
            version_id=version_id,
            mod_time=mod_time,
            data_dir=data_dir,
            base_meta=base_meta,
        )
        fi.is_latest = True
        oi = ObjectInfo.from_file_info(fi, bucket, object_name)
        oi.etag = etag
        return oi

    def _cleanup_failed_put(self, bucket, object_name, version_id, errs) -> None:
        def rm(args):
            disk, err = args
            if disk is None or err is not None:
                return
            try:
                disk.delete_version(
                    bucket, object_name, FileInfo(version_id=version_id)
                )
            except errors.StorageError:
                pass

        meta_mod.parallel_map(rm, list(zip(self._online(), errs)))

    # ------------------------------------------------------------------- get

    def _read_quorum_fi(
        self, bucket: str, object_name: str, version_id: str = ""
    ) -> tuple[FileInfo, list[FileInfo | None], list[StorageAPI | None]]:
        disks = self._online()
        metas, errs = meta_mod.read_all_file_info(disks, bucket, object_name, version_id)
        if all(fi is None for fi in metas):
            count, err = errors.reduce_errs(errs)
            if isinstance(err, errors.FileNotFound):
                raise errors.ObjectNotFound(bucket, object_name)
            if isinstance(err, errors.FileVersionNotFound):
                raise errors.VersionNotFound(bucket, object_name)
            if isinstance(err, errors.VolumeNotFound):
                raise errors.BucketNotFound(bucket)
            raise err or errors.ObjectNotFound(bucket, object_name)
        read_quorum, _ = meta_mod.object_quorum_from_meta(metas, errs, self.parity)
        try:
            fi = meta_mod.find_file_info_in_quorum(metas, read_quorum)
        except errors.ErasureReadQuorum:
            raise errors.InsufficientReadQuorum(bucket, object_name)
        return fi, metas, disks

    def get_object_info(
        self, bucket: str, object_name: str, opts: GetObjectOptions | None = None
    ) -> ObjectInfo:
        opts = opts or GetObjectOptions()
        self._check_bucket(bucket)
        fi, metas, _ = self._read_quorum_fi(bucket, object_name, opts.version_id)
        n_versions = max((f.num_versions for f in metas if f is not None), default=1)
        fi.num_versions = n_versions
        if fi.deleted:
            if not opts.version_id:
                raise errors.ObjectNotFound(bucket, object_name)
            oi = ObjectInfo.from_file_info(fi, bucket, object_name)
            raise errors.MethodNotAllowed(bucket, object_name)
        return ObjectInfo.from_file_info(fi, bucket, object_name)

    def get_object(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> tuple[ObjectInfo, bytes]:
        oi, stream = self.get_object_stream(bucket, object_name, opts, offset, length)
        # Chunks are views over pooled buffers valid only until the next
        # next() -- copy each one while it is live (b"".join(stream) would
        # drain the whole iterator first and join dead views).
        buf = bytearray()
        for c in stream:
            buf += c
        return oi, bytes(buf)

    def get_object_stream(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> tuple[ObjectInfo, Iterator[bytes]]:
        """Streaming erasure get: yields decoded byte chunks covering
        [offset, offset+length), reading ONLY the shard-file frames of the
        covered blocks (range -> block/shard-offset mapping; the reference's
        ShardFileOffset + lazy parallelReader, cmd/erasure-coding.go:141,
        erasure-decode.go:31-202). Memory is O(GROUP_BLOCKS x BLOCK_SIZE)."""
        opts = opts or GetObjectOptions()
        self._check_bucket(bucket)
        # The object span covers the quorum metadata read; per-drive shard
        # reads during streaming publish storage spans as the body flows.
        with tracing.span(
            "object.GetObject", "object", bucket=bucket, object=object_name
        ):
            fi, metas, disks = self._read_quorum_fi(bucket, object_name, opts.version_id)
        if fi.deleted:
            raise (
                errors.MethodNotAllowed(bucket, object_name)
                if opts.version_id
                else errors.ObjectNotFound(bucket, object_name)
            )
        oi = ObjectInfo.from_file_info(fi, bucket, object_name)
        size = fi.size
        if offset < 0 or offset > size:
            raise errors.InvalidArgument(bucket, object_name, "range out of bounds")
        end = size if length < 0 else min(offset + length, size)
        if size == 0 or offset >= end:
            return oi, iter(())

        k = fi.erasure.data_blocks
        online = meta_mod.list_online_disks(disks, metas, [None] * len(disks), fi)
        by_shard = meta_mod.shuffle_disks_by_index(online, fi.erasure.distribution)
        metas_by_shard = meta_mod.shuffle_disks_by_index(  # type: ignore[arg-type]
            [m if o is not None else None for m, o in zip(metas, online)],
            fi.erasure.distribution,
        )
        inline = bool(fi.inline_data) or any(
            m is not None and m.inline_data for m in metas_by_shard
        )

        stream_range = (
            self._stream_part_range_whole
            if _whole_layout(metas)
            else self._stream_part_range
        )

        def gen() -> Iterator[bytes]:
            abs_pos = 0
            for part in fi.parts:
                p_lo = max(offset - abs_pos, 0)
                p_hi = min(end - abs_pos, part.size)
                if p_lo < p_hi:
                    yield from stream_range(
                        bucket, object_name, fi, by_shard, metas_by_shard,
                        part, inline, p_lo, p_hi,
                    )
                abs_pos += part.size
                if abs_pos >= end:
                    return

        return oi, gen()

    def _stream_part_range(
        self,
        bucket: str,
        object_name: str,
        fi: FileInfo,
        by_shard: list[StorageAPI | None],
        metas_by_shard,
        part: ObjectPartInfo,
        inline: bool,
        lo: int,
        hi: int,
    ) -> Iterator[bytes]:
        """Decode part-local byte range [lo, hi), group by group."""
        k = fi.erasure.data_blocks
        mth = fi.erasure.parity_blocks
        chunk_full = -(-BLOCK_SIZE // k)
        frame_full = DIGEST_LEN + chunk_full
        nblocks = -(-part.size // BLOCK_SIZE)
        last_block_len = part.size - (nblocks - 1) * BLOCK_SIZE

        def chunk_len(b: int) -> int:
            return chunk_full if b < nblocks - 1 else -(-last_block_len // k)

        def block_len(b: int) -> int:
            return BLOCK_SIZE if b < nblocks - 1 else last_block_len

        part_file = f"part.{part.number}"
        b0, b1 = lo // BLOCK_SIZE, (hi - 1) // BLOCK_SIZE

        # Slot selection: the k lowest-latency ONLINE slots carry the window
        # (ranked by the metered read_file EWMAs + breaker state); the rest
        # queue as hedge spares, best first. Inline payloads ride the
        # metadata already in hand -- no drive IO, nothing to hedge.
        if inline:
            primaries = list(range(k))
            spares = [j for j in range(k, k + mth) if metas_by_shard[j] is not None]
        else:
            ranked = _rank_read_slots(by_shard, k)
            primaries = ranked[:k] if len(ranked) >= k else ranked
            spares = ranked[len(primaries):]

        pool = bufpool.shard_pool()

        def make_window(g0: int):
            """Issue the window's primary-slot reads immediately (futures);
            the readahead stage -- window g+1's drive IO overlaps window g's
            verify/decode (klauspost/readahead's role in the reference read
            pipeline, cmd/object-api-utils.go:686)."""
            g1 = min(g0 + GROUP_BLOCKS - 1, b1)
            window_sizes = [chunk_len(b) for b in range(g0, g1 + 1)]
            file_off = g0 * frame_full
            file_len = sum(DIGEST_LEN + s for s in window_sizes)
            bufs = _WindowBufs()

            def read_window(
                j: int,
            ) -> tuple[list[tuple[memoryview, memoryview]], list[bool]] | None:
                disk = by_shard[j]
                pb = None
                try:
                    if inline:
                        m = metas_by_shard[j]
                        blob = m.inline_data if m is not None else b""
                        if not blob:
                            return None
                        blob = blob[file_off : file_off + file_len]
                    else:
                        if disk is None:
                            return None
                        path = os.path.join(object_name, fi.data_dir, part_file)
                        rfi = getattr(disk, "read_file_into", None)
                        if rfi is not None:
                            # Zero-copy row read: the shard image lands ONCE
                            # in a pooled buffer; frames below are views over
                            # it. The window's _WindowBufs owns the buffer
                            # until the decoded chunks are consumed.
                            pb = pool.acquire(file_len)
                            blob = pb.view(0, file_len)
                            if rfi(bucket, path, file_off, blob) < file_len:
                                raise errors.FileCorrupt("short shard file")
                        else:
                            blob = disk.read_file(bucket, path, file_off, file_len)
                    # Stage mark via direct ledger record: pool threads carry
                    # no span context (same rationale as storage metering).
                    t_fp = time.perf_counter()
                    c_fp = time.thread_time()
                    parsed = _parse_frames(blob, window_sizes)
                    # Copy-ledger hop: frame parsing slices memoryviews over
                    # the read blob -- zero-copy by construction.
                    GLOBAL_PROFILER.copy.record("frame-parse", MOVED, len(blob))
                    # Verify here, in the parallel read thread: rows of one
                    # window verify concurrently.
                    oks = _verify_frames(self.codec, parsed)
                    GLOBAL_PERF.ledger.record(
                        "object", "frame-parse",
                        time.perf_counter() - t_fp, time.thread_time() - c_fp,
                    )
                    if pb is not None:
                        if bufs.add(pb):
                            pb = None
                            return parsed, oks
                        # Hedged straggler: the window was consumed and
                        # its registry closed while this read was in
                        # flight. The result is discarded, so drop this
                        # frame's exports first; the finally recycles pb.
                        for d, c in parsed:
                            _quiet_release(d, c)
                        _quiet_release(blob)
                        return None
                    return parsed, oks
                except (errors.DiskError, errors.FileCorrupt):
                    return None
                finally:
                    if pb is not None:
                        pb.release()

            issued_at = {j: time.monotonic() for j in primaries}
            futures = dict(
                zip(primaries, meta_mod.parallel_submit(read_window, primaries))
            )
            return g1, read_window, futures, issued_at, bufs

        def gather_hedged(read_window, futures, issued_at, install) -> None:
            """Collect window reads, arming hedges when a primary straggles.

            Reconstruction needs ANY k of the n rows, so the moment a primary
            exceeds max(HEDGE_FLOOR, HEDGE_MULT x median completed duration)
            the best spare slot is launched against it; the first k usable
            rows win and stragglers are left to finish in their pool thread
            (results discarded). Spares also replace failed reads outright."""
            by_future = {f: j for j, f in futures.items()}
            spare_queue = list(spares)
            hedged: set[int] = set()
            covered: set[int] = set()
            durations: list[float] = []
            usable: set[int] = set()
            launched = 0

            def launch(j: int, covering: int | None) -> None:
                nonlocal launched
                issued_at[j] = time.monotonic()
                f = meta_mod.parallel_submit(read_window, [j])[0]
                by_future[f] = j
                if covering is not None:
                    hedged.add(j)
                    covered.add(covering)
                    launched += 1

            while len(usable) < k and by_future:
                try:
                    deadline.check("hedged erasure read")
                except errors.DeadlineExceeded:
                    GLOBAL_DEGRADE.record_deadline_abort("erasure-get")
                    raise
                done, _ = _cf.wait(
                    set(by_future), timeout=_HEDGE_POLL,
                    return_when=_cf.FIRST_COMPLETED,
                )
                now = time.monotonic()
                for f in done:
                    j = by_future.pop(f)
                    result = f.result()[0]
                    install(j, result)
                    durations.append(now - issued_at[j])
                    if result is not None:
                        usable.add(j)
                    elif spare_queue:
                        # Failed read: its replacement is routing, not hedging.
                        launch(spare_queue.pop(0), covering=None)
                if len(usable) >= k or not spare_queue:
                    continue
                # Hedge decision: need a median worth trusting (at least
                # half the quorum completed), then every uncovered
                # outstanding slot past the threshold gets one hedge.
                if len(durations) * 2 < k:
                    continue
                med = sorted(durations)[len(durations) // 2]
                threshold = max(HEDGE_FLOOR, HEDGE_MULT * med)
                for j in list(by_future.values()):
                    if not spare_queue:
                        break
                    if j in covered or j in hedged:
                        continue
                    if now - issued_at[j] > threshold:
                        launch(spare_queue.pop(0), covering=j)
            wins = len(usable & hedged)
            if launched:
                GLOBAL_DEGRADE.record_hedge(launched, wins)
                cur = tracing.current()
                if cur is not None:
                    cur.set(hedge_launched=launched, hedge_wins=wins)

        starts = list(range(b0, b1 + 1, GROUP_BLOCKS))

        def windows():
            """Produce one (chunks, close) unit per window. `chunks` are
            memoryviews over pooled shard buffers (or decoded bytes on a
            degraded read); close() recycles the window's buffers and must
            run only after the consumer is done with the views."""
            pending = make_window(starts[0])
            try:
                for win_i, g0 in enumerate(starts):
                    g1, read_window, futures, issued_at, bufs = pending
                    # Kick off the NEXT window's reads before verifying this
                    # one.
                    pending = (
                        make_window(starts[win_i + 1])
                        if win_i + 1 < len(starts)
                        else None
                    )
                    try:
                        chunks = self._decode_window(
                            bucket, object_name, k, mth, g0, g1,
                            read_window, futures, issued_at, gather_hedged,
                            chunk_len, block_len, lo, hi, len(primaries),
                        )
                    except BaseException:
                        bufs.close()
                        raise

                    def unit_close(chunks=chunks, futures=futures, bufs=bufs):
                        # Drop the refs this pipeline owns before the
                        # buffers recycle: straggler futures pin their
                        # (parsed, oks) rows and the registry list pins
                        # unconsumed chunks.
                        # Views already yielded to the consumer are NOT
                        # invalidated -- bufs.close() demotes any buffer
                        # they still export to a discard.
                        futures.clear()
                        del chunks[:]
                        bufs.close()

                    yield chunks, unit_close
            finally:
                if pending is not None:
                    # Consumer abandoned the stream with a prefetched window
                    # in flight: its reads recycle into the closed registry.
                    pending[4].close()

        # The get-stager overlaps window g+1's drive reads + verify with the
        # response write of window g (MTPU_GET_READAHEAD units in flight).
        depth = int(os.environ.get("MTPU_GET_READAHEAD", "1"))
        it = _GetStager(windows(), depth) if depth > 0 else windows()
        try:
            for chunks, close in it:
                try:
                    # pop() so this frame never pins a yielded view: by the
                    # time close() runs, only the consumer's own references
                    # (if any) keep a chunk's storage exported.
                    while chunks:
                        yield chunks.pop(0)
                finally:
                    # Runs when the consumer asks past the window's last
                    # chunk or tears down mid-window.
                    close()
        finally:
            closer = getattr(it, "close", None)
            if closer is not None:
                closer()

    def _decode_window(
        self,
        bucket: str,
        object_name: str,
        k: int,
        mth: int,
        g0: int,
        g1: int,
        read_window,
        futures,
        issued_at,
        gather_hedged,
        chunk_len,
        block_len,
        lo: int,
        hi: int,
        n_primaries: int,
    ) -> list:
        """Gather + verify one window's rows and return its response chunks
        (row views on the healthy path; decoded bytes where reconstructed)."""
        # Ranked rows first; spares pulled lazily on any failure (the
        # lazy-spare parallelReader discipline, erasure-decode.go:119).
        frames: list[list[tuple[memoryview, memoryview]] | None] = [None] * (k + mth)
        oks: list[list[bool] | None] = [None] * (k + mth)
        loaded = [False] * (k + mth)

        def install(j: int, result) -> None:
            frames[j], oks[j] = result if result is not None else (None, None)
            loaded[j] = True

        # GET-side stage mark: the hedged shard gather is where a
        # degraded or slow-drive read spends its time.
        with tracing.span("shard-read", "object", drives=n_primaries):
            gather_hedged(read_window, futures, issued_at, install)

        def load_spares() -> None:
            spare = [j for j in range(k + mth) if not loaded[j]]
            if not spare:
                return
            spare_results = meta_mod.parallel_map(read_window, spare)
            for idx, j in enumerate(spare):
                install(j, spare_results[idx][0])

        if sum(1 for j in range(k + mth) if frames[j] is not None) < k:
            load_spares()

        def valid_rows(w: int) -> list[bytes | None]:
            # Frames were bitrot-verified at read time (one batched digest
            # call per row window); a failed frame drops its whole shard, as
            # the reference's bitrot readers do.
            rows: list[bytes | None] = [None] * (k + mth)
            for j in range(k + mth):
                if frames[j] is None:
                    continue
                if oks[j][w]:
                    rows[j] = frames[j][w][1]
                else:
                    frames[j] = None  # corrupt: drop the shard
            return rows

        # Pass 1: verify every block in the window, pulling spares once
        # if any block falls under read quorum.
        rows_by_block: list[list[bytes | None]] = []
        for b in range(g0, g1 + 1):
            rows = valid_rows(b - g0)
            if sum(1 for r in rows if r is not None) < k:
                load_spares()
                rows = valid_rows(b - g0)
            if sum(1 for r in rows if r is not None) < k:
                raise errors.InsufficientReadQuorum(bucket, object_name)
            rows_by_block.append(rows)

        # Pass 2: rebuild missing data rows for the whole window in
        # batched codec calls, grouped by loss pattern -- a degraded GET
        # runs ONE device program per window instead of a per-block host
        # reconstruct (the served decode path, cmd/erasure-decode.go:206).
        groups: dict[tuple[tuple[bool, ...], tuple[int, ...]], list[int]] = {}
        for wi, rows in enumerate(rows_by_block):
            want = tuple(j for j in range(k) if rows[j] is None)
            if want:
                pattern = tuple(r is not None for r in rows)
                groups.setdefault((pattern, want), []).append(wi)
        if groups:
            # Only a degraded window pays for (and reports) a decode
            # stage; healthy reads skip the mark entirely.
            with tracing.span("decode", "object", blocks=len(rows_by_block)):
                for (_, want), idxs in groups.items():
                    results = self.codec.reconstruct_batch(
                        [rows_by_block[wi] for wi in idxs], k, mth, want
                    )
                    for wi, (chunks, _) in zip(idxs, results):
                        for slot, j in enumerate(want):
                            rows_by_block[wi][j] = chunks[slot]
                            # Copy-ledger hop: a degraded read rebuilds
                            # the missing rows into fresh buffers.
                            GLOBAL_PROFILER.copy.record(
                                "decode", COPIED, len(chunks[slot])
                            )

        # Healthy path: the response chunks ARE the data-row views -- no
        # join, no copy; _block_pieces trims the range/tail per block.
        out: list = []
        for b in range(g0, g1 + 1):
            s = max(lo - b * BLOCK_SIZE, 0)
            e = min(hi - b * BLOCK_SIZE, block_len(b))
            if s < e:
                out.extend(
                    _block_pieces(rows_by_block[b - g0], chunk_len(b), s, e)
                )
        return out

    def _stream_part_range_whole(
        self,
        bucket: str,
        object_name: str,
        fi: FileInfo,
        by_shard,
        metas_by_shard,
        part: ObjectPartInfo,
        inline: bool,
        lo: int,
        hi: int,
    ) -> Iterator[bytes]:
        """Range decode of a LEGACY whole-file-bitrot part.

        The shard files are raw bytes; integrity is one checksum per part
        per row stored in each drive's own metadata (cmd/bitrot-whole.go:62
        wholeBitrotReader). Verification therefore reads the ENTIRE row file
        once (the reference pays the same cost), then blocks are sliced and
        missing data rows rebuilt with the batched codec.
        """
        k = fi.erasure.data_blocks
        mth = fi.erasure.parity_blocks
        chunk_full = -(-BLOCK_SIZE // k)
        nblocks = -(-part.size // BLOCK_SIZE)
        last_block_len = part.size - (nblocks - 1) * BLOCK_SIZE

        def chunk_len(b: int) -> int:
            return chunk_full if b < nblocks - 1 else -(-last_block_len // k)

        def block_len(b: int) -> int:
            return BLOCK_SIZE if b < nblocks - 1 else last_block_len

        part_file = f"part.{part.number}"
        blobs: list[bytes | None] = [None] * (k + mth)
        loaded = [False] * (k + mth)
        # Verification must hash the ENTIRE row file (whole-file semantics,
        # same cost the reference's wholeBitrotReader pays), but only the
        # region covering the requested blocks is retained afterwards, so a
        # small range GET of a large legacy object doesn't hold k full rows.
        b0, b1 = lo // BLOCK_SIZE, (hi - 1) // BLOCK_SIZE
        region_off = b0 * chunk_full
        region_end = (b1 + 1) * chunk_full

        def load_row(j: int) -> bytes | None:
            meta = metas_by_shard[j]
            disk = by_shard[j]
            if meta is None:
                return None
            try:
                if inline:
                    blob = meta.inline_data or b""
                else:
                    if disk is None:
                        return None
                    blob = disk.read_file(
                        bucket, os.path.join(object_name, fi.data_dir, part_file)
                    )
            except (errors.DiskError, errors.FileCorrupt):
                return None
            if not _whole_sum_matches(meta, part.number, blob):
                return None  # whole-file bitrot: the entire row is suspect
            return blob[region_off:region_end]

        def ensure(rows_idx: list[int]) -> None:
            todo = [j for j in rows_idx if not loaded[j]]
            if not todo:
                return
            results = meta_mod.parallel_map(load_row, todo)
            for idx, j in enumerate(todo):
                blobs[j] = results[idx][0] if results[idx][1] is None else None
                loaded[j] = True

        ensure(list(range(k)))
        if any(blobs[j] is None for j in range(k)):
            ensure(list(range(k + mth)))
        if sum(1 for b in blobs if b is not None) < k:
            raise errors.InsufficientReadQuorum(bucket, object_name)

        for g0 in range(b0, b1 + 1, GROUP_BLOCKS):
            g1 = min(g0 + GROUP_BLOCKS - 1, b1)
            rows_by_block: list[list[bytes | None]] = []
            for b in range(g0, g1 + 1):
                cl = chunk_len(b)
                off = b * chunk_full - region_off
                rows_by_block.append(
                    [
                        blobs[j][off : off + cl] if blobs[j] is not None else None
                        for j in range(k + mth)
                    ]
                )
            missing = tuple(j for j in range(k) if blobs[j] is None)
            if missing:
                results = self.codec.reconstruct_batch(rows_by_block, k, mth, missing)
                for rows, (chunks, _) in zip(rows_by_block, results):
                    for slot, j in enumerate(missing):
                        rows[j] = chunks[slot]
            for b in range(g0, g1 + 1):
                joined = _join_block_rows(rows_by_block[b - g0], k, block_len(b))
                s = max(lo - b * BLOCK_SIZE, 0)
                e = min(hi - b * BLOCK_SIZE, block_len(b))
                # Full-range slice of bytes returns the same object, so a
                # full-block yield is copy-free now that the join is exact.
                yield joined[s:e]

    # ---------------------------------------------------------------- delete

    def put_object_metadata(
        self,
        bucket: str,
        object_name: str,
        version_id: str = "",
        updates: dict[str, str] | None = None,
        removes: list[str] | None = None,
    ) -> ObjectInfo:
        """Update user metadata of an existing version in place
        (PutObjectMetadata / PutObjectTags, cmd/erasure-object.go equivalent:
        read quorum FileInfo, mutate metadata, update xl.meta on all drives)."""
        self._check_bucket(bucket)
        fi, metas, disks = self._read_quorum_fi(bucket, object_name, version_id)
        if fi.deleted:
            raise errors.MethodNotAllowed(bucket, object_name)
        for k in removes or []:
            fi.metadata.pop(k, None)
        fi.metadata.update(updates or {})

        # Each drive keeps ITS OWN FileInfo (per-drive erasure index and
        # shard checksums differ) -- only the metadata dict is replaced.
        # Writing the quorum FileInfo verbatim to every drive would clobber
        # shard identity and corrupt reads.
        def upd(args):
            i, d = args
            if d is None:
                raise errors.DiskNotFound()
            own = metas[i]
            if own is None:
                raise errors.FileNotFound(bucket, object_name)
            own.metadata = dict(fi.metadata)
            d.update_metadata(bucket, object_name, own)

        results = meta_mod.parallel_map(upd, list(enumerate(disks)))
        errs = [e for _, e in results]
        write_quorum = fi.write_quorum(self.parity)
        err = errors.reduce_quorum_errs(
            errs, write_quorum, errors.InsufficientWriteQuorum(bucket, object_name)
        )
        if err is not None:
            raise err
        return ObjectInfo.from_file_info(fi, bucket, object_name)

    def transition_object(
        self,
        bucket: str,
        object_name: str,
        version_id: str,
        tier: str,
        remote_name: str,
        expected_etag: str = "",
        expected_mtime: float = 0.0,
    ) -> ObjectInfo:
        """Mark a version transitioned to a remote tier and free its local
        data parts (the reference's DeleteObject w/ transition markers in
        cmd/bucket-lifecycle.go transitionObject + erasure-object.go: xl.meta
        keeps TransitionStatus/TransitionedObjName/TransitionTier while the
        shard files are reclaimed). The caller has already uploaded the bytes
        to the tier under remote_name; expected_etag/mtime guard against the
        version having been overwritten since the caller read it (otherwise a
        concurrent PUT on an unversioned bucket would be stamped as pointing
        at stale tier bytes and lose the new data). Inline (small) objects
        are left local — reclaiming xl.meta-inline bytes saves nothing."""
        from ..control.tiering import (
            META_TRANSITION_NAME,
            META_TRANSITION_STATUS,
            META_TRANSITION_TIER,
            STATUS_COMPLETE,
        )

        self._check_bucket(bucket)
        fi, metas, disks = self._read_quorum_fi(bucket, object_name, version_id)
        if fi.deleted:
            raise errors.MethodNotAllowed(bucket, object_name)
        if not fi.data_dir:
            raise errors.InvalidArgument(bucket, object_name, "inline object not transitionable")
        if expected_etag and fi.metadata.get("etag", "") != expected_etag:
            raise errors.PreconditionFailed(msg="object changed since tier upload")
        if expected_mtime and abs(fi.mod_time - expected_mtime) > 1e-6:
            raise errors.PreconditionFailed(msg="object changed since tier upload")
        updates = {
            META_TRANSITION_STATUS: STATUS_COMPLETE,
            META_TRANSITION_TIER: tier,
            META_TRANSITION_NAME: remote_name,
        }
        oi = self.put_object_metadata(bucket, object_name, version_id, updates=updates)

        # Metadata is durable first: a crash here leaves orphan part files
        # (reclaimed by heal/scan) but never a transitioned object whose
        # local parts are gone without the remote pointer being recorded.
        def free(d):
            if d is None:
                return
            try:
                d.delete(bucket, os.path.join(object_name, fi.data_dir), recursive=True)
            except errors.DiskError:
                pass

        meta_mod.parallel_map(free, list(disks))
        return oi

    def delete_object(
        self, bucket: str, object_name: str, opts: DeleteObjectOptions | None = None
    ) -> ObjectInfo:
        with tracing.span(
            "object.DeleteObject", "object", bucket=bucket, object=object_name
        ):
            return self._delete_object(bucket, object_name, opts)

    def _delete_object(
        self, bucket: str, object_name: str, opts: DeleteObjectOptions | None = None
    ) -> ObjectInfo:
        opts = opts or DeleteObjectOptions()
        self._check_bucket(bucket)
        disks = self._online()
        write_quorum = self.drive_count // 2 + 1

        if opts.versioned and not opts.version_id:
            # Write a delete marker as the new latest version.
            marker = FileInfo(
                volume=bucket,
                name=object_name,
                version_id=str(uuid.uuid4()),
                deleted=True,
                mod_time=now(),
            )

            def mark(d):
                if d is None:
                    raise errors.DiskNotFound()
                d.delete_version(bucket, object_name, marker)

            results = meta_mod.parallel_map(mark, disks)
            errs = [e for _, e in results]
            err = errors.reduce_quorum_errs(
                errs, write_quorum, errors.ErasureWriteQuorum(bucket, object_name)
            )
            if err:
                raise err
            oi = ObjectInfo(
                bucket=bucket,
                name=object_name,
                version_id=marker.version_id,
                delete_marker=True,
                mod_time=marker.mod_time,
            )
            return oi

        # Physical delete of one version (or the null version).
        vid = opts.version_id
        fi = FileInfo(volume=bucket, name=object_name, version_id=vid)

        def rm(d):
            if d is None:
                raise errors.DiskNotFound()
            d.delete_version(bucket, object_name, fi)

        results = meta_mod.parallel_map(rm, disks)
        errs = [e for _, e in results]
        not_found = (errors.FileNotFound, errors.FileVersionNotFound)
        if errs and all(e is not None and isinstance(e, not_found) for e in errs):
            # Every drive agrees the version was never there: that is a clean
            # not-found, not a write-quorum failure (the multi-pool delete
            # sweep relies on this to skip pools that never held the object).
            if vid:
                raise errors.VersionNotFound(bucket, object_name)
            raise errors.ObjectNotFound(bucket, object_name)
        err = errors.reduce_quorum_errs(
            errs,
            write_quorum,
            errors.ErasureWriteQuorum(bucket, object_name),
            ignored=not_found,
        )
        if err:
            raise err
        return ObjectInfo(bucket=bucket, name=object_name, version_id=vid)

    # ------------------------------------------------------------------ heal

    def heal_object(
        self, bucket: str, object_name: str, version_id: str = "", dry_run: bool = False
    ) -> HealResultItem:
        """Reconstruct missing/corrupt shards onto stale drives
        (cmd/erasure-healing.go:257 healObject equivalent)."""
        with tracing.span(
            "object.HealObject", "object", bucket=bucket, object=object_name
        ):
            return self._heal_object(bucket, object_name, version_id, dry_run)

    def _heal_object(
        self, bucket: str, object_name: str, version_id: str = "", dry_run: bool = False
    ) -> HealResultItem:
        disks = self._online()
        metas, errs = meta_mod.read_all_file_info(disks, bucket, object_name, version_id)
        read_quorum, _ = meta_mod.object_quorum_from_meta(metas, errs, self.parity)
        fi = meta_mod.find_file_info_in_quorum(metas, read_quorum)
        k, mth = fi.erasure.data_blocks, fi.erasure.parity_blocks

        result = HealResultItem(
            bucket=bucket,
            object=object_name,
            version_id=fi.version_id,
            data_blocks=k,
            parity_blocks=mth,
        )
        online = meta_mod.list_online_disks(disks, metas, errs, fi)
        state = []
        for d, o in zip(disks, online):
            if d is None:
                state.append("offline")
            elif o is None:
                state.append("missing")
            else:
                state.append("ok")
        result.before_drive_state = list(state)

        from ..control.tiering import META_TRANSITION_STATUS, STATUS_COMPLETE

        if fi.deleted or fi.metadata.get(META_TRANSITION_STATUS) == STATUS_COMPLETE:
            # Delete markers and transitioned versions have no local shard
            # data; heal = copy the metadata record to stale drives.
            to_heal = [i for i, s in enumerate(state) if s == "missing"]
            if not dry_run:
                for i in to_heal:
                    d = disks[i]
                    if d is not None:
                        d.write_metadata(bucket, object_name, fi)
                        state[i] = "healed"
            result.after_drive_state = state
            result.disks_healed = len(to_heal)
            return result

        by_shard = meta_mod.shuffle_disks_by_index(online, fi.erasure.distribution)
        metas_by_shard = meta_mod.shuffle_disks_by_index(  # type: ignore[arg-type]
            [m if o is not None else None for m, o in zip(metas, online)],
            fi.erasure.distribution,
        )
        inline = bool(fi.inline_data) or (
            fi.size > 0 and fi.size < SMALL_FILE_THRESHOLD and not fi.data_dir
        )
        parts = fi.parts or [ObjectPartInfo(1, fi.size, fi.size)]
        part_chunks = {p.number: _shard_chunk_sizes(p.size, k) for p in parts}
        # Legacy whole-file-bitrot objects: raw shard files, one checksum per
        # part per row in each drive's own metadata (cmd/bitrot-whole.go).
        # Majority vote -- one drive's lost cs list must not flip the layout.
        whole = _whole_layout(metas)

        # Verified single-part whole-file blobs are kept for the rebuild so
        # the heal doesn't read every surviving row twice (verify + rebuild).
        # Multi-part objects skip the cache to bound memory at one part.
        whole_blobs: dict[tuple[int, int], bytes] = {}

        def _read_raw(j: int, part: ObjectPartInfo) -> bytes:
            cached = whole_blobs.get((j, part.number))
            if cached is not None:
                return cached
            disk = by_shard[j]
            if disk is None:
                raise errors.DiskNotFound()
            if inline:
                m = metas_by_shard[j]
                blob = m.inline_data if m is not None else b""
                if not blob:
                    raise errors.FileNotFound()
                return blob
            return disk.read_file(
                bucket, os.path.join(object_name, fi.data_dir, f"part.{part.number}")
            )

        def read_part_frames(j: int, part: ObjectPartInfo):
            """(digest, chunk) frames; digest is None for whole-file rows
            (their integrity is the single per-part checksum, verified in
            _whole_row_ok, not per chunk)."""
            blob = _read_raw(j, part)
            if not whole:
                return _parse_frames(blob, part_chunks[part.number])
            frames, pos = [], 0
            for sz in part_chunks[part.number]:
                chunk = blob[pos : pos + sz]
                if len(chunk) != sz:
                    raise errors.FileCorrupt("short whole-bitrot shard file")
                frames.append((None, chunk))
                pos += sz
            return frames

        def _whole_row_ok(j: int, part: ObjectPartInfo) -> bool:
            m = metas_by_shard[j]
            if m is None:
                return False
            try:
                blob = _read_raw(j, part)
            except (errors.DiskError, errors.FileCorrupt):
                return False
            if not _whole_sum_matches(m, part.number, blob):
                return False
            # Rows are verified in index order and the rebuild re-reads only
            # the FIRST k surviving rows, so caching the first k verified
            # rows covers exactly the reuse set (single-part only: memory is
            # bounded at k rows ~ the part size).
            if len(parts) == 1 and len(whole_blobs) < k:
                whole_blobs[(j, part.number)] = blob
            return True

        # Which shard rows need rebuilding? (missing drive, bad metadata, or
        # failed verification of any part chunk.) Verification is batched
        # ACROSS rows per part and routed through the codec, so the batching
        # device codec runs one hash launch per chunk length instead of a
        # per-shard host loop.
        bad: set[int] = {j for j in range(k + mth) if by_shard[j] is None}
        if fi.size > 0 and whole:
            for part in parts:
                for j in range(k + mth):
                    if j not in bad and not _whole_row_ok(j, part):
                        bad.add(j)
        elif fi.size > 0 and isinstance(self.codec, codec_mod.HostCodec):
            # Host codec: verify each row's H||chunk frames per row, as the
            # GET path does (one batched digest call per row).
            for part in parts:
                sizes = part_chunks[part.number]
                for j in range(k + mth):
                    if j in bad:
                        continue
                    try:
                        blob = _read_raw(j, part)
                        parsed = _parse_frames(blob, sizes)
                        if not all(_verify_frames(self.codec, parsed)):
                            bad.add(j)
                    except (errors.DiskError, errors.FileCorrupt):
                        bad.add(j)
        elif fi.size > 0:
            # Device codec: rows are verified in batched digest calls
            # (grouped across rows so small objects still form real device
            # batches) but flushed before the pending chunks exceed ~32 MiB, so
            # memory stays O(flush window + one row), not
            # O(whole part x all rows).
            FLUSH_BYTES = 32 << 20

            for part in parts:
                pending: list[tuple[int, bytes, bytes]] = []  # (row, digest, chunk)
                pending_bytes = 0

                def flush() -> None:
                    nonlocal pending, pending_bytes
                    digs = self.codec.digests_batch([c for _, _, c in pending])
                    for (row, want, _), got in zip(pending, digs):
                        if got != want:
                            bad.add(row)
                    pending = []
                    pending_bytes = 0

                for j in range(k + mth):
                    if j in bad:
                        continue
                    try:
                        for digest, chunk in read_part_frames(j, part):
                            pending.append((j, digest, chunk))
                            pending_bytes += len(chunk)
                    except (errors.DiskError, errors.FileCorrupt):
                        bad.add(j)
                        continue
                    if pending_bytes >= FLUSH_BYTES:
                        flush()
                flush()

        oks = [j not in bad for j in range(k + mth)]
        bad_rows = tuple(j for j, ok in enumerate(oks) if not ok)
        if not bad_rows:
            result.after_drive_state = state
            return result
        if sum(oks) < k:
            raise errors.InsufficientReadQuorum(bucket, object_name, "object unhealable")
        if dry_run:
            result.after_drive_state = state
            result.disks_healed = len(bad_rows)
            return result

        # Rebuild bad rows per part, block by block, from surviving shards.
        surviving = [j for j, ok in enumerate(oks) if ok][: k]
        rebuilt_files: dict[int, dict[int, bytes]] = {j: {} for j in bad_rows}  # row -> part -> blob
        rebuilt_sums: dict[int, list[dict]] = {j: [] for j in bad_rows}  # whole-file only
        whole_algo_heal = None
        if whole:
            # Algorithm for rebuilt checksums: first parsable entry from a
            # VERIFIED surviving row (the quorum representative's field may
            # be the one corrupted drive's).
            for j in surviving:
                m_ = metas_by_shard[j]
                for ent in m_.erasure.checksums if m_ is not None else []:
                    try:
                        whole_algo_heal = bitrot_mod.BitrotAlgorithm(ent.get("algo", ""))
                        break
                    except ValueError:
                        continue
                if whole_algo_heal is not None:
                    break
            if whole_algo_heal is None:
                raise errors.FileCorrupt(
                    "whole-file bitrot object has no parsable checksum algorithm"
                )
        if fi.size > 0:
            for part in parts:
                frames_by_row = {j: read_part_frames(j, part) for j in surviving}
                per_row: dict[int, list[tuple[bytes, bytes]]] = {j: [] for j in bad_rows}
                nblocks = len(part_chunks[part.number])
                # Rebuild GROUP_BLOCKS windows per codec call: heal runs the
                # same batched device program as encode (reconstruct + bitrot
                # digests in one fused step; the reference loops per block,
                # cmd/erasure-lowlevel-heal.go:31). The short tail block makes
                # its window irregular and falls back to the host codec.
                for g0 in range(0, nblocks, GROUP_BLOCKS):
                    window = range(g0, min(g0 + GROUP_BLOCKS, nblocks))
                    rows_batch: list[list[bytes | None]] = []
                    for b in window:
                        rows: list[bytes | None] = [None] * (k + mth)
                        for j in surviving:
                            rows[j] = frames_by_row[j][b][1]
                        rows_batch.append(rows)
                    results = self.codec.reconstruct_batch(
                        rows_batch, k, mth, bad_rows, with_digests=True
                    )
                    for chunks, digests in results:
                        for idx, j in enumerate(bad_rows):
                            per_row[j].append((digests[idx], chunks[idx]))
                for j in bad_rows:
                    if whole:
                        raw = b"".join(c for _, c in per_row[j])
                        rebuilt_files[j][part.number] = raw
                        rebuilt_sums[j].append(
                            {
                                "part": part.number,
                                "algo": whole_algo_heal.value,
                                "hash": bitrot_mod.digest_of(raw, whole_algo_heal).hex(),
                            }
                        )
                    else:
                        rebuilt_files[j][part.number] = _frame_shard(
                            [c for _, c in per_row[j]], [d for d, _ in per_row[j]]
                        )

        # Write rebuilt shards to the drives that should hold them.
        healed = 0
        # pid-scoped like the PUT staging: a heal interrupted by process death
        # leaves tmp dirs a recovery scan can attribute to the dead pid.
        upload_id = f"{os.getpid()}.{uuid.uuid4()}"
        for j in bad_rows:
            # Find the drive index whose distribution slot is shard j.
            drive_index = fi.erasure.distribution.index(j + 1)
            disk = disks[drive_index]
            if disk is None:
                continue
            new_fi = FileInfo(
                volume=bucket,
                name=object_name,
                version_id=fi.version_id,
                data_dir=fi.data_dir if not inline else "",
                mod_time=fi.mod_time,
                size=fi.size,
                metadata=dict(fi.metadata),
                parts=[ObjectPartInfo(p.number, p.size, p.actual_size, p.mod_time) for p in fi.parts],
                erasure=ErasureInfo(
                    data_blocks=k,
                    parity_blocks=mth,
                    block_size=fi.erasure.block_size,
                    index=j + 1,
                    distribution=list(fi.erasure.distribution),
                    checksums=rebuilt_sums[j] if whole else [],
                ),
                inline_data=rebuilt_files[j].get(1, b"") if inline else b"",
            )
            try:
                if inline or fi.size == 0:
                    disk.write_metadata(bucket, object_name, new_fi)
                else:
                    tmp_path = f"tmp/{upload_id}/{j}"
                    for part in parts:
                        disk.create_file(
                            META_BUCKET,
                            f"{tmp_path}/part.{part.number}",
                            rebuilt_files[j][part.number],
                        )
                    disk.rename_data(META_BUCKET, tmp_path, new_fi, bucket, object_name)
                healed += 1
                state[drive_index] = "healed"
            except errors.DiskError:
                continue
        result.after_drive_state = state
        result.disks_healed = healed
        return result
