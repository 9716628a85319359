"""Bounded reusable buffer pool for the zero-copy data plane.

Role of the reference's internal/bpool (bpool.BytePoolCap): the PUT path
lands socket bytes into pooled ``bytearray`` windows once, and every
downstream hop (sigv4 chunk parse, erasure staging, shard slicing) operates
on ``memoryview``s over the same storage. The pool bounds steady-state
memory (capacity x buf_size) while never blocking a request: when the free
list is empty an overflow buffer is allocated and simply dropped on release
instead of being retained.

Lifecycle is explicit refcounting, not GC: ``acquire`` hands out a
PooledBuffer with one reference; pipeline stages that hold the buffer past
the caller's scope (readahead queue, in-flight drive writes) ``retain`` it
and ``release`` when done. The last release recycles the storage. Tests
pigeonhole this: after any PUT -- including chaos-faulted ones -- the pool
reports zero outstanding buffers.
"""

from __future__ import annotations

import os

from ..control import bufsan as _bufsan
from ..control.sanitizer import san_lock


class PooledBuffer:
    """A refcounted bytearray window handed out by a BufferPool."""

    # __weakref__ lets the armed bufsan (control/bufsan.py) hang a leak
    # detector off every handle; _san is its per-handle shadow state (None
    # when disarmed: one attribute, no behavior change).
    __slots__ = ("data", "_pool", "_refs", "_san", "__weakref__")

    def __init__(self, data: bytearray, pool: "BufferPool | None"):
        self.data = data
        self._pool = pool
        self._refs = 1
        self._san = None

    def __len__(self) -> int:
        return len(self.data)

    def view(self, start: int = 0, end: int | None = None) -> memoryview:
        """Writable window over the storage. Views must not outlive the
        buffer's last release -- the storage is reused afterwards.

        Bounds are checked eagerly: after the last release the storage is
        poisoned to 0 bytes, and a silently-empty slice would mask exactly
        the use-after-release that poisoning exists to surface. Negative
        indices are rejected for the same reason -- they re-anchor on
        whatever length the (possibly recycled) storage has now.
        """
        n = len(self.data)
        stop = n if end is None else end
        if start < 0 or stop < start or stop > n:
            raise ValueError(
                f"view({start}, {end}) out of bounds for {n}-byte storage"
                " -- a 0-byte buffer is one whose last release already"
                " recycled the storage"
            )
        san = _bufsan.ACTIVE
        if san is not None:
            san.note_view(self)
        return memoryview(self.data)[start:stop]

    def retain(self) -> "PooledBuffer":
        pool = self._pool
        if pool is None:  # detached (pool-less) buffer: no accounting
            return self
        with pool._lock:
            if self._refs <= 0:
                raise RuntimeError("retain() on a released PooledBuffer")
            self._refs += 1
        return self

    def release(self) -> None:
        self._release(discard=False)

    def discard(self) -> None:
        """Release this reference, but never recycle the storage.

        For exception paths: an in-flight traceback pins frames this code
        does not own (a reader's ``readinto``, a codec callback), and those
        frames may hold views over the storage. Recycling would let a stale
        view observe another request's bytes; discarding lets the allocator
        reclaim the storage only once every pinned frame is gone. Costs one
        allocation on a cold path; buys a hard lifetime guarantee.
        """
        self._release(discard=True)

    def release_or_discard(self) -> None:
        """Release, demoting to ``discard()`` if live exports remain.

        For consumer-facing streams: the zero-copy GET hands memoryview
        chunks to callers whose contract lets them keep the bytes (collect
        the whole stream, then join). At close time the owner cannot know
        which they did, so the last release probes the storage -- no
        exports means a normal recycle; a surviving export means the
        allocator keeps the storage alive for its holder and the pool
        never sees it again.
        """
        self._release(discard=False, demote_if_exported=True)

    def _release(self, discard: bool, demote_if_exported: bool = False) -> None:
        pool = self._pool
        if pool is None:
            return
        with pool._lock:
            if self._refs <= 0:
                san = _bufsan.ACTIVE
                if san is not None:
                    san.note_double_release(self)
                raise RuntimeError("release() on an already-released PooledBuffer")
            self._refs -= 1
            if self._refs == 0:
                if demote_if_exported and _exported(self.data):
                    discard = True
                pool._recycle_locked(self, discard=discard)


def _exported(storage: bytearray) -> bool:
    """True if any live memoryview/buffer export pins `storage`. A bytearray
    refuses to resize while exported, so a 1-byte append is a definitive
    O(1) probe; on success the byte is removed again."""
    try:
        storage.append(0)
    except BufferError:
        return True
    del storage[-1:]
    return False


class BufferPool:
    """Bounded free-list of equal-size bytearrays. acquire() never blocks:
    past `capacity` it allocates overflow buffers that are dropped (not
    pooled) on release, so a burst degrades to plain allocation instead of
    deadlocking the data plane on its own memory bound."""

    def __init__(self, buf_size: int, capacity: int, name: str = "bufpool"):
        if buf_size <= 0 or capacity <= 0:
            raise ValueError("buf_size and capacity must be positive")
        self.buf_size = buf_size
        self.capacity = capacity
        self.name = name
        self._lock = san_lock("BufferPool._lock")
        self._free: list[bytearray] = []
        self._outstanding = 0
        self._gets = 0
        self._reuses = 0
        self._overflow = 0
        self._discards = 0

    def acquire(self, size: int | None = None) -> PooledBuffer:
        """Hand out a buffer of at least `size` bytes (default buf_size).

        Requests that fit buf_size reuse the pooled storage -- callers slice
        their own window with view(0, size), so a short read never shrinks
        the pooled bytearray. Oversize requests overflow-allocate exactly
        `size` bytes; _recycle_locked drops odd-size storage on release.
        """
        want = self.buf_size if size is None else size
        if want <= 0:
            raise ValueError("acquire size must be positive")
        # ALL accounting (gets/outstanding/reuses/overflow) stays inside the
        # critical section: a concurrent burst bumping counters outside the
        # lock loses increments and undercounts overflow, and the burst is
        # exactly when the overflow number matters. Only the bytearray
        # allocation itself happens outside.
        storage: bytearray | None = None
        with self._lock:
            self._gets += 1
            self._outstanding += 1
            if want <= self.buf_size and self._free:
                self._reuses += 1
                storage = self._free.pop()
            elif self._outstanding > self.capacity or want > self.buf_size:
                self._overflow += 1
        reused = storage is not None
        if storage is None:
            # Allocation happens outside the lock: a multi-MiB bytearray fill
            # is not something to serialize the whole data plane behind.
            storage = bytearray(self.buf_size if want <= self.buf_size else want)
        pb = PooledBuffer(storage, self)
        san = _bufsan.ACTIVE
        if san is not None:
            san.note_acquire(pb, self.name, reused)
        return pb

    def _recycle_locked(self, pb: PooledBuffer, discard: bool = False) -> None:
        self._outstanding -= 1
        storage = pb.data
        pooled = (
            not discard
            and len(self._free) < self.capacity
            and len(storage) == self.buf_size
        )
        if discard:
            self._discards += 1
        san = _bufsan.ACTIVE
        if san is not None:
            # Before the storage can be handed to anyone else: probe for
            # views that outlive this buffer, then sentinel-poison what goes
            # back on the free list. (A discarded storage is never reused,
            # so its lingering traceback-pinned views are harmless.)
            san.note_recycle(pb, storage, pooled)
        if pooled:
            self._free.append(storage)
        pb.data = bytearray(0)  # poison: stale views see an empty buffer

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "buf_size": self.buf_size,
                "capacity": self.capacity,
                "free": len(self._free),
                "outstanding": self._outstanding,
                "gets": self._gets,
                "reuses": self._reuses,
                "overflow_allocs": self._overflow,
                "discards": self._discards,
            }


# -- process-wide window pool --------------------------------------------------

# The PUT pipeline lands body bytes in GROUP-sized windows (16 MiB: see
# object/erasure.py GROUP_BLOCKS x BLOCK_SIZE). Capacity bounds steady-state
# pool memory at capacity x 16 MiB; concurrent bursts overflow-allocate.
WINDOW_BYTES = 16 * (1 << 20)

_GLOBAL: BufferPool | None = None
_global_lock = san_lock("bufpool._global_lock")


def window_pool() -> BufferPool:
    """The shared PUT window pool (MTPU_POOL_BUFFERS sizes it, default 8)."""
    global _GLOBAL
    with _global_lock:
        if _GLOBAL is None:
            cap = max(1, int(os.environ.get("MTPU_POOL_BUFFERS", "8")))
            _GLOBAL = BufferPool(WINDOW_BYTES, cap, name="put-window")
        return _GLOBAL


# The GET pipeline reads one shard row (WINDOW_BYTES / k data bytes plus
# 32 B digest framing per block) per drive per window. Rows for common k
# (4..12) fit a 2 MiB buffer; larger rows overflow-allocate exactly.
SHARD_BYTES = 2 * (1 << 20)

_SHARD: BufferPool | None = None


def shard_pool() -> BufferPool:
    """The shared GET shard-row pool (MTPU_SHARD_BUFFERS sizes it)."""
    global _SHARD
    with _global_lock:
        if _SHARD is None:
            cap = max(1, int(os.environ.get("MTPU_SHARD_BUFFERS", "32")))
            _SHARD = BufferPool(SHARD_BYTES, cap, name="get-shard")
        return _SHARD
