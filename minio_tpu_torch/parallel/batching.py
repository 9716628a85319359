"""Cross-request device batching: the encode service.

1 MiB blocks from *concurrent* uploads are fanned into fixed-shape device
batches, amortizing host<->device transfer and kernel launches across
requests (the reference instead runs per-request SIMD calls on the CPU,
cmd/erasure-coding.go:63).

Design (the JAX package's parallel/batching.py, on torch and CUDA):
  * Full 1 MiB blocks take the batched device path -- uniform [B, K, S]
    shapes, one fused encode+hash step (models/pipeline.py). With more
    than one card the step fans over the codec mesh (parallel/mesh.py
    codec_mesh, MTPU_MESH_SHAPE): batches pad to a multiple of dp and fan
    data-parallel over blocks; each grid entry's piece is copied straight
    into its slice of the pinned host buffers.
  * Every shorter block coalesces on a second queue behind a bounded
    latency budget (MTPU_BATCH_WAIT_US): concurrent small-object PUTs share
    one device batch, padded on the shard-BYTE axis (GF math is per byte
    position, so the true-length parity prefix is bit-exact), and each
    block's rows are hashed on the device at their true length.
  * Reconstructs and digests run on the device too, whatever their shape:
    a window is split into groups of one loss pattern and one chunk
    length, and digests into groups of one length. No route leads to the
    host codec (object/codec.py HostCodec); on device="cpu" the same routes
    run the kernels' plain torch versions.
  * The batcher thread collects requests until `max_batch` or
    `batch_timeout_s` after the first arrival, pads the batch to a bucketed
    size (1/2/4/8/16/32/64), and runs the step. On the card each worker owns
    a CUDA stream: a batch is staged in pinned host memory, copied in,
    encoded and hashed, and copied out asynchronously, and a CUDA event
    recorded after it marks completion. Under sustained load the worker
    dispatches batch i+1 before it waits on batch i's event, so the
    transfers of one batch overlap the kernels of the next.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time as _time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..control import tracing
from ..control.perf import GLOBAL_PERF
from ..control.sanitizer import san_lock
from ..models.pipeline import ErasurePipeline, Geometry, resolve_device
from ..object.codec import BlockCodec, digests_by_length, reconstruct_groups, stack_rows
from ..ops import highwayhash_cuda, rs_matrix
from ..parallel import mesh as mesh_lib

_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# Shard-byte-axis padding buckets start here (powers of two above), so the
# small path runs O(log(block_size)) batch shapes per (k, m).
_SMALL_LEN_MIN = 1 << 10


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _len_bucket(s: int) -> int:
    b = _SMALL_LEN_MIN
    while b < s:
        b <<= 1
    return b


def _small_wait_s() -> float:
    """MTPU_BATCH_WAIT_US: microseconds to hold a small-object batch open
    after the first arrival (default 500). "off" or a negative value holds
    it open not at all: the batch takes what is already queued."""
    raw = os.environ.get("MTPU_BATCH_WAIT_US", "").strip().lower()
    if raw in ("off", "disable", "disabled"):
        return 0.0
    try:
        wait = float(raw) if raw else 500.0
    except ValueError:
        wait = 500.0
    return max(wait, 0.0) / 1e6


@dataclass
class _Request:
    shards: np.ndarray  # [K, S] split data block
    future: Future


@dataclass
class _SmallRequest:
    block: bytes  # raw sub-window block (bytes or memoryview)
    future: Future


class _PinnedPool:
    """Reusable pinned host buffers for async copies to and from the card,
    pooled by size (a power of two of at least 4 KiB); callers view their
    first bytes. A buffer goes back to the pool only after the device work
    that used it has completed."""

    _MIN_BYTES = 4 << 10

    def __init__(self):
        self._lock = san_lock("_PinnedPool._lock")
        self._free: dict[int, list[torch.Tensor]] = {}

    def get(self, nbytes: int) -> torch.Tensor:
        size = self._MIN_BYTES
        while size < nbytes:
            size <<= 1
        with self._lock:
            free = self._free.get(size)
            if free:
                return free.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def put(self, t: torch.Tensor) -> None:
        with self._lock:
            self._free.setdefault(t.numel(), []).append(t)


@dataclass
class _Pending:
    """One dispatched encode batch, resolved when its events complete.

    Block i = g * b_loc + j of the batch lies in group g at slot j; the
    shard rows are views [dp, b_loc, K+M, sp, S/sp] whose last two axes
    read in order are the row, the digests [dp, b_loc, sp, tp, t_loc, 32]
    (dp = sp = tp = 1 without a mesh)."""

    batch: list
    shards: np.ndarray  # pinned-buffer views on the card
    digests: np.ndarray
    events: list  # one a mesh entry (one without a mesh); none on the CPU
    pinned: list
    k: int
    m: int
    b_real: int
    b_pad: int
    t0: float
    c0: float
    mesh_dp: int | None  # the mesh's dp, None without a mesh


class BatchingDeviceCodec(BlockCodec):
    """BlockCodec running full blocks through a batched device pipeline.

    ``device`` is "cuda" unless the caller asks for "cpu"; "cuda" without a
    card raises. ``mesh`` is a parallel/mesh.py Mesh of ``device``'s type,
    None, or "auto": codec_mesh() on cuda (None with one card), None on the
    CPU."""

    def __init__(
        self,
        block_size: int = 1 << 20,
        max_batch: int = 64,
        batch_timeout_s: float = 0.0005,
        device="cuda",
        mesh="auto",
    ):
        self.block_size = block_size
        self.max_batch = max_batch
        self.batch_timeout_s = batch_timeout_s
        self.device = resolve_device(device)
        if mesh not in ("auto", None) and mesh.type != self.device.type:
            raise ValueError(f"a {mesh.type} mesh under a codec on {self.device}")
        # "auto" resolves at first worker creation (device enumeration
        # stays off the constructor).
        self.mesh = mesh
        self.small_wait_s = _small_wait_s()
        self._pinned = _PinnedPool() if self.device.type == "cuda" else None
        self._queues: dict[tuple, queue.Queue] = {}
        self._pipelines: dict = {}
        self._threads: dict[tuple, threading.Thread] = {}
        self._lock = san_lock("BatchingDeviceCodec._lock")
        # Counters are bumped by batch workers AND request threads; += is
        # load/add/store, so a dedicated leaf lock (taken inside _lock, never
        # the reverse) guards every read-modify-write.
        self._stats_lock = san_lock("BatchingDeviceCodec._stats_lock")
        self._stop = threading.Event()
        # Served-traffic counters (tests and the chip smoke assert the device
        # pipeline actually carries production blocks).
        self.blocks_encoded = 0
        self.batches_run = 0
        self.blocks_reconstructed = 0
        self.recon_batches_run = 0
        self.digests_verified = 0
        self.verify_batches_run = 0
        # Padded-slot total: blocks_encoded / blocks_padded = batch occupancy.
        self.blocks_padded = 0
        # Small-object coalescing path (sub-window blocks: parity and
        # true-length digests on the device).
        self.small_blocks_encoded = 0
        self.small_batches_run = 0
        self.small_blocks_padded = 0
        # Batches whose completion overlapped the next batch's dispatch (the
        # worker's one-deep pending slot engaged).
        self.double_buffered_batches = 0
        # Multi-device fan-out accounting: chip_blocks[g] counts real
        # (non-pad) blocks the dp-group g carried; with no mesh both stay
        # trivial.
        self.mesh_devices = 1
        self.chip_blocks: list[int] = []
        # Wall time from dispatch to completion, per kernel class (seconds).
        self.device_encode_seconds = 0.0
        self.device_recon_seconds = 0.0
        self.device_verify_seconds = 0.0

    def _stream(self):
        """A pooled CUDA stream for a worker or for a request thread's
        synchronous device call (reconstruct, verify), so calls from the
        parallel shard-read threads overlap on the card instead of queueing
        on one stream; None on the CPU."""
        return torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _staged(self, shape: tuple, hold: list) -> torch.Tensor:
        """A host u8 tensor of `shape` for staging device copies: a view of a
        pooled pinned buffer on the card (appended to `hold`, handed back by
        _release once the copies are done), plain memory on the CPU."""
        if self._pinned is None:
            return torch.empty(shape, dtype=torch.uint8)
        n = int(np.prod(shape))
        buf = self._pinned.get(n)
        hold.append(buf)
        return buf[:n].view(shape)

    def _release(self, hold: list) -> None:
        for buf in hold:
            self._pinned.put(buf)

    # -- worker management ---------------------------------------------------

    def _pipe(self, k: int, m: int) -> ErasurePipeline:
        with self._lock:
            return self._pipeline_locked(k, m)

    def _mesh_for(self, k: int, m: int):
        """The codec mesh, or None when the geometry doesn't tile it.

        Caller holds self._lock ("auto" resolution mutates self.mesh). The
        mesh step needs (k+m) streams to divide the tp x sp grid and the
        shard byte axis to divide sp; geometries that don't fit run the
        single-device pipeline (the JAX package's routing rule)."""
        if self.mesh == "auto":
            self.mesh = mesh_lib.codec_mesh() if self.device.type == "cuda" else None
        mesh = self.mesh
        if mesh is None:
            return None
        tp, sp = mesh.shape["tp"], mesh.shape["sp"]
        geom = Geometry(k, m, self.block_size)
        if geom.total % (tp * sp) or geom.shard_size % sp:
            return None
        return mesh

    def _pipeline_locked(self, k: int, m: int) -> ErasurePipeline:
        key = (k, m)
        pipe = self._pipelines.get(key)
        if pipe is None:
            mesh = self._mesh_for(k, m)
            pipe = self._pipelines[key] = ErasurePipeline(
                Geometry(k, m, self.block_size), device=self.device, mesh=mesh
            )
            if mesh is not None:
                with self._stats_lock:
                    self.mesh_devices = max(self.mesh_devices, mesh.size)
                    dp = mesh.shape["dp"]
                    if len(self.chip_blocks) < dp:
                        self.chip_blocks.extend([0] * (dp - len(self.chip_blocks)))
        return pipe

    def _step_streams(self, pipe: ErasurePipeline, stream) -> dict | None:
        """A worker's stream on each card of its pipeline's mesh (its own
        stream on the codec's device); None on the CPU."""
        if stream is None:
            return None
        devices = pipe.mesh.distinct_devices() if pipe.mesh is not None else [self.device]
        return {d: stream if d == self.device else torch.cuda.Stream(d) for d in devices}

    def _ensure_worker(self, k: int, m: int) -> queue.Queue:
        key = (k, m)
        with self._lock:
            if key not in self._queues:
                q: queue.Queue[_Request] = queue.Queue()
                self._queues[key] = q
                self._pipeline_locked(k, m)
                t = threading.Thread(
                    target=self._worker, args=(key,), daemon=True, name=f"encode-batch-{k}-{m}"
                )
                t.start()  # start before registering: close() joins registrants
                self._threads[key] = t
        return self._queues[key]

    def _ensure_small_worker(self, k: int, m: int) -> queue.Queue:
        key = (k, m, "small")
        with self._lock:
            if key not in self._queues:
                q: queue.Queue[_SmallRequest] = queue.Queue()
                self._queues[key] = q
                self._pipeline_locked(k, m)
                t = threading.Thread(
                    target=self._small_worker,
                    args=(key,),
                    daemon=True,
                    name=f"encode-batch-small-{k}-{m}",
                )
                t.start()
                self._threads[key] = t
        return self._queues[key]

    def _collect(self, q: queue.Queue, first, window_s: float) -> list:
        batch = [first]
        start = _time.monotonic()
        while len(batch) < self.max_batch:
            remaining = window_s - (_time.monotonic() - start)
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self, key: tuple[int, int]) -> None:
        k, m = key
        q = self._queues[key]
        pipe = self._pipelines[key]
        stream = self._stream()
        streams = self._step_streams(pipe, stream)
        # One-deep pending slot: under sustained load batch i+1 is
        # dispatched before the worker waits on batch i's events.
        pending = None
        while not self._stop.is_set():
            try:
                first = q.get(timeout=0.1)
            except queue.Empty:
                if pending is not None:
                    self._resolve_batch(pending)
                    pending = None
                continue
            batch = self._collect(q, first, self.batch_timeout_s)
            dispatched = self._dispatch_batch(pipe, streams, k, m, batch)
            if pending is not None:
                self._resolve_batch(pending)
                if dispatched is not None:
                    with self._stats_lock:
                        self.double_buffered_batches += 1
            pending = dispatched
            if pending is not None and q.empty():
                # No follow-on work queued: resolve now, don't buy overlap
                # with latency the request pays for.
                self._resolve_batch(pending)
                pending = None
        if pending is not None:
            self._resolve_batch(pending)

    def _dispatch_batch(self, pipe: ErasurePipeline, streams, k: int, m: int, batch: list[_Request]):
        """Stage + launch one encode batch; returns the pending record to
        resolve later, or None if dispatch itself failed.

        The batch is staged per grid entry: entry (d, t, s) reads
        host_in[d, s] and writes host_shards[d, s] (its tp = 0 replica) and
        host_digests[d, s, t], each one contiguous block of a pinned buffer,
        so every copy is one async transfer and nothing is gathered onto one
        card first. Without a mesh the grid is the one entry (0, 0, 0)."""
        pinned: list = []
        try:
            mesh = pipe.mesh
            dp, tp, sp = (mesh.shape[a] for a in mesh_lib.AXES) if mesh is not None else (1, 1, 1)
            s = batch[0].shards.shape[1]
            t = k + m
            b_real = len(batch)
            b_pad = -(-_bucket(b_real) // dp) * dp  # dp must divide the batch axis
            b_loc, s_loc, t_loc = b_pad // dp, s // sp, t // (sp * tp)
            t0 = _time.perf_counter()
            c0 = _time.thread_time()
            host_in = self._staged((dp, sp, b_loc, k, s_loc), pinned)
            host_shards = self._staged((dp, sp, b_loc, t, s_loc), pinned)
            host_digests = self._staged((dp, sp, tp, b_loc, t_loc, 32), pinned)
            arr = host_in.numpy()
            for i in range(b_pad):
                g, j = divmod(i, b_loc)
                arr[g, :, j] = batch[i].shards.reshape(k, sp, s_loc).transpose(1, 0, 2) if i < b_real else 0
            events = []
            with mesh_lib.use_streams(streams):
                if mesh is None:
                    pieces = {(0, 0, 0): pipe.encode(host_in[0, 0])}
                else:
                    pieces = pipe.encode_blocks({
                        c: host_in[c[0], c[2]].to(mesh.device(c), non_blocking=True) for c in mesh.coords()
                    })
                for (d, ti, si), (shards, digests) in pieces.items():
                    if ti == 0:
                        host_shards[d, si].copy_(shards, non_blocking=True)
                    host_digests[d, si, ti].copy_(digests, non_blocking=True)
                    if streams is not None:
                        events.append(torch.cuda.Event())
                        events[-1].record(torch.cuda.current_stream(shards.device))
            return _Pending(batch, host_shards.numpy().transpose(0, 2, 3, 1, 4),
                            host_digests.numpy().transpose(0, 3, 1, 2, 4, 5), events, pinned,
                            k, m, b_real, b_pad, t0, c0, dp if mesh is not None else None)
        except Exception as e:  # noqa: BLE001 - surfaced through every future
            self._release(pinned)
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return None

    def _resolve_batch(self, rec: _Pending) -> None:
        try:
            for event in rec.events:
                event.synchronize()
            dt = _time.perf_counter() - rec.t0
            # Ledger record, not a span: worker threads run outside any
            # request context, so a span here would be a silent no-op. The
            # cpu delta separates device wait (wall >> cpu) from host-side
            # marshalling burning the core; on the card it also counts the
            # event wait's spin as cpu.
            GLOBAL_PERF.ledger.record(
                "codec", "encode-batch", dt, _time.thread_time() - rec.c0
            )
            with self._stats_lock:
                self.device_encode_seconds += dt
                self.batches_run += 1
                self.blocks_encoded += rec.b_real
                self.blocks_padded += rec.b_pad
                if rec.mesh_dp is not None:
                    per = rec.b_pad // rec.mesh_dp
                    for g in range(min(rec.mesh_dp, len(self.chip_blocks))):
                        self.chip_blocks[g] += min(max(rec.b_real - g * per, 0), per)
            t = rec.k + rec.m
            b_loc = rec.shards.shape[1]
            for i, req in enumerate(rec.batch):
                g, j = divmod(i, b_loc)
                digests = rec.digests[g, j].reshape(t, 32)
                req.future.set_result(
                    (
                        [rec.shards[g, j, r].tobytes() for r in range(t)],
                        [digests[r].tobytes() for r in range(t)],
                    )
                )
        except Exception as e:  # noqa: BLE001 - surfaced through every future
            for req in rec.batch:
                if not req.future.done():
                    req.future.set_exception(e)
        finally:
            self._release(rec.pinned)

    def _small_worker(self, key: tuple) -> None:
        k, m = key[0], key[1]
        q = self._queues[key]
        pipe = self._pipelines[(k, m)]
        stream = self._stream()
        while not self._stop.is_set():
            try:
                first = q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._run_small_batch(pipe, stream, k, m, self._collect(q, first, self.small_wait_s))

    def _run_small_batch(self, pipe: ErasurePipeline, stream, k: int, m: int, batch: list[_SmallRequest]) -> None:
        hold: list = []
        try:
            datas = [np.frombuffer(req.block, dtype=np.uint8) for req in batch]
            shard_lens = [rs_matrix.shard_size(d.size, k) for d in datas]
            # Pad the shard BYTE axis, not the block: GF(2^8) is per byte
            # position, so parity[:, :true_len] of the padded batch is
            # bit-identical to encoding at true length. (Padding the block
            # itself would change ceil(len/k) and thus the parity bytes.)
            # Only each block's true-length prefix is read back or hashed,
            # so the staging buffer is not cleared.
            s_pad = _len_bucket(max(shard_lens))
            b_real = len(batch)
            b_pad = _bucket(b_real)
            host_in = self._staged((b_pad, k, s_pad), hold)
            arr = host_in.numpy()
            for i, d in enumerate(datas):
                arr[i, :, : shard_lens[i]] = rs_matrix.split(d, k)
            host_shards = self._staged((b_real, k + m, s_pad), hold)
            host_digests = self._staged((b_real, k + m, 32), hold)
            t0 = _time.perf_counter()
            c0 = _time.thread_time()
            with self._on(stream):
                shards, digests = pipe.encode_padded(host_in, shard_lens)
                host_shards.copy_(shards[:b_real], non_blocking=True)
                host_digests.copy_(digests, non_blocking=True)
            if stream is not None:
                stream.synchronize()
            dt = _time.perf_counter() - t0
            GLOBAL_PERF.ledger.record(
                "codec", "encode-batch-small", dt, _time.thread_time() - c0
            )
            with self._stats_lock:
                self.device_encode_seconds += dt
                self.small_batches_run += 1
                self.small_blocks_encoded += b_real
                self.small_blocks_padded += b_pad
            out_shards, out_digests = host_shards.numpy(), host_digests.numpy()
            for i, req in enumerate(batch):
                s_i = shard_lens[i]
                req.future.set_result(
                    (
                        [out_shards[i, j, :s_i].tobytes() for j in range(k + m)],
                        [out_digests[i, j].tobytes() for j in range(k + m)],
                    )
                )
        except Exception as e:  # noqa: BLE001 - surfaced through every future
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
        finally:
            self._release(hold)

    # -- BlockCodec interface -------------------------------------------------

    def encode(self, blocks, k, m):
        with tracing.span(
            "erasure.encode", "erasure", blocks=len(blocks), k=k, m=m
        ):
            return self._encode(blocks, k, m)

    def _encode(self, blocks, k, m):
        """Full blocks join the full-block batch, every shorter block the
        small-object batch; both run on the device."""
        futures: list[Future] = []
        q = None
        sq = None
        for block in blocks:
            f: Future = Future()
            if len(block) == self.block_size:
                if q is None:
                    q = self._ensure_worker(k, m)
                q.put(_Request(rs_matrix.split(np.frombuffer(block, np.uint8), k), f))
            else:
                if sq is None:
                    sq = self._ensure_small_worker(k, m)
                sq.put(_SmallRequest(block, f))
            futures.append(f)
        return [f.result(timeout=60) for f in futures]

    def reconstruct(self, shards, k, m, want):
        return self.reconstruct_batch([shards], k, m, want)[0][0]

    def reconstruct_batch(self, rows_batch, k, m, want, with_digests=False):
        """Degraded-GET and heal windows rebuilt on the device (the served
        decode path the reference runs per block, cmd/erasure-decode.go:206):
        one padded-batch program per group of one loss pattern and one chunk
        length -- a window's full blocks, then its short tail -- with the
        results in the caller's order. One ledger record per call, however
        many groups it ran."""
        with tracing.span(
            "erasure.reconstruct", "erasure", blocks=len(rows_batch), k=k, m=m
        ):
            pipe = self._pipe(k, m)
            stream = self._stream()
            t0 = _time.perf_counter()
            c0 = _time.thread_time()
            with self._on(stream):
                out, groups = reconstruct_groups(pipe, rows_batch, k, tuple(want), with_digests)
            dt = _time.perf_counter() - t0
            GLOBAL_PERF.ledger.record(
                "codec", "reconstruct-batch", dt, _time.thread_time() - c0
            )
            with self._stats_lock:
                self.device_recon_seconds += dt
                self.recon_batches_run += groups
                self.blocks_reconstructed += len(rows_batch)
            return out

    def digests_batch(self, chunks):
        """GET-verify and heal-verify digests on the device: one hash launch
        per distinct chunk length, results in the caller's order. One ledger
        record per call, closed after the last launch's stream sync."""
        t0 = _time.perf_counter()
        c0 = _time.thread_time()
        out = digests_by_length(chunks, self._hash_rows)
        GLOBAL_PERF.ledger.record(
            "codec", "verify-batch", _time.perf_counter() - t0, _time.thread_time() - c0
        )
        return out

    def _hash_rows(self, rows: list, length: int) -> list[bytes]:
        """[n] equal-length rows -> their digests: staged into one pinned
        [n, length] buffer, copied in, hashed and copied out on a pooled
        stream."""
        hold: list = []
        try:
            host_in = self._staged((len(rows), length), hold)
            stack_rows(rows, length, host_in.numpy())
            host_out = self._staged((len(rows), 32), hold)
            stream = self._stream()
            t0 = _time.perf_counter()
            with self._on(stream):
                x = host_in.to(self.device, non_blocking=True)
                host_out.copy_(highwayhash_cuda.hash256_batch(x), non_blocking=True)
            if stream is not None:
                stream.synchronize()
            dt = _time.perf_counter() - t0
            with self._stats_lock:
                self.device_verify_seconds += dt
                self.verify_batches_run += 1
                self.digests_verified += len(rows)
            return [d.tobytes() for d in host_out.numpy()]
        finally:
            self._release(hold)

    # -- metrics surface ------------------------------------------------------

    def queue_depths(self) -> dict[str, int]:
        """Pending encode requests per worker queue (full + small paths)."""
        with self._lock:
            out = {}
            for key, q in self._queues.items():
                name = f"{key[0]}x{key[1]}"
                if len(key) > 2:
                    name += "-small"
                out[name] = q.qsize()
            return out

    def stats(self) -> dict:
        """Counter snapshot (same keys as the JAX package's codec)."""
        with self._stats_lock:
            return {
                "blocks_encoded": self.blocks_encoded,
                "batches_run": self.batches_run,
                "blocks_padded": self.blocks_padded,
                "blocks_reconstructed": self.blocks_reconstructed,
                "recon_batches_run": self.recon_batches_run,
                "digests_verified": self.digests_verified,
                "verify_batches_run": self.verify_batches_run,
                "small_blocks_encoded": self.small_blocks_encoded,
                "small_batches_run": self.small_batches_run,
                "small_blocks_padded": self.small_blocks_padded,
                "double_buffered_batches": self.double_buffered_batches,
                "mesh_devices": self.mesh_devices,
                "chip_blocks": list(self.chip_blocks),
                # Work sent to the host codec: no route leads there, on
                # either device; the keys keep the JAX package's shape.
                "host_fallback_blocks": 0,
                "host_fallback_recon_blocks": 0,
                "host_fallback_digest_chunks": 0,
                "device_encode_seconds": self.device_encode_seconds,
                "device_recon_seconds": self.device_recon_seconds,
                "device_verify_seconds": self.device_verify_seconds,
            }

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.join(timeout=1.0)
