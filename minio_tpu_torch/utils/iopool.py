"""GIL-escaping I/O worker pool with per-lane FIFO ordering.

The PUT fan-out needs two properties at once:

  * concurrency ACROSS drives -- shard writes to 16 drives should overlap,
    and the hot loops (os.writev, file appends, storage-RPC sends) all
    release the GIL, so workers escape the interpreter while data moves;
  * strict ordering WITHIN a drive -- a staged shard file is append-only,
    so group g must hit drive d's file before group g+1 does.

LanePool provides both: submissions carry a lane key (the drive index) and
are queued per lane; a lane is drained by at most one worker at a time, in
submission order, on a shared ThreadPoolExecutor. Workers hold buffers, not
locks: the pool lock guards only the tiny queue bookkeeping, never I/O
(mtpusan's lock-blocking-io rule holds this file to that).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

from ..control.sanitizer import san_lock


class LanePool:
    """Shared worker pool; per-lane FIFO serialization."""

    def __init__(self, workers: int, name: str = "drive-io-lane"):
        self._ex = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=name)
        self._lock = san_lock("LanePool._lock")
        self._lanes: dict = {}     # lane -> deque[(fn, args, Future)]
        self._active: set = set()  # lanes currently owned by a drain worker

    def submit(self, lane, fn, *args) -> Future:
        """Run fn(*args) after every earlier submission on `lane`."""
        fut: Future = Future()
        with self._lock:
            q = self._lanes.get(lane)
            if q is None:
                q = self._lanes[lane] = deque()
            q.append((fn, args, fut))
            start = lane not in self._active
            if start:
                self._active.add(lane)
        if start:
            self._ex.submit(self._drain, lane)
        return fut

    def _drain(self, lane) -> None:
        while True:
            with self._lock:
                q = self._lanes.get(lane)
                if not q:
                    self._active.discard(lane)
                    self._lanes.pop(lane, None)
                    return
                fn, args, fut = q.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # surfaced through the Future
                fut.set_exception(e)

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)


_SHARED: LanePool | None = None
_shared_lock = san_lock("iopool._shared_lock")


def shard_writer_pool() -> LanePool:
    """Process-wide shard-write pool (MTPU_IO_WORKERS sizes it).

    Default scales with the host: enough workers that a 16-drive fan-out
    overlaps on multi-core boxes without spawning 16 idle threads on a
    single-core one."""
    global _SHARED
    with _shared_lock:
        if _SHARED is None:
            default = min(16, 4 * (os.cpu_count() or 1))
            workers = max(1, int(os.environ.get("MTPU_IO_WORKERS", str(default))))
            _SHARED = LanePool(workers, name="drive-io-lane")
        return _SHARED
