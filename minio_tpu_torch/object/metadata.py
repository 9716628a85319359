"""Metadata quorum logic: agreeing on an object's state across drives.

Role of cmd/erasure-metadata.go + erasure-metadata-utils.go: read xl.meta
from every drive, find the version agreed by a read quorum
(findFileInfoInQuorum), compute read/write quorums from the geometry, and
decide per-drive freshness for healing.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor

from ..storage.interface import StorageAPI
from ..storage.types import FileInfo
from ..utils import errors

# Shared pool for fan-out drive IO. The reference bounds per-call concurrency
# with errgroup (internal/sync/errgroup); a process-wide pool does the same.
_IN_POOL = threading.local()


def _mark_pool_thread() -> None:
    _IN_POOL.active = True


_POOL = ThreadPoolExecutor(max_workers=64, thread_name_prefix="drive-io", initializer=_mark_pool_thread)


def parallel_map(fn, items):
    """Run fn over items concurrently; return ordered [(result, error)].

    Each task runs under a copy of the CALLER's contextvars (pool threads
    don't inherit them), so the request trace context follows the fan-out
    into per-drive storage calls. A fan-out made from inside a pool task
    (a bulk delete's per-object drive fan-out, a per-pool probe's drive
    reads) runs in that task's thread: queued behind its siblings, it would
    wait forever once every worker waits on one, as the JAX package's
    ServerPools.delete_objects does past 64 keys."""
    ctx = contextvars.copy_context()

    def wrap(item):
        try:
            return ctx.copy().run(fn, item), None
        except Exception as e:  # noqa: BLE001 - error values are the contract
            return None, e

    if getattr(_IN_POOL, "active", False):
        return [wrap(item) for item in items]
    return list(_POOL.map(wrap, items))


def parallel_submit(fn, items):
    """Like parallel_map but returns futures of (result, error) immediately
    — the read-ahead primitive (klauspost/readahead's role: issue the next
    window's drive reads while the current one decodes)."""
    ctx = contextvars.copy_context()

    def wrap(item):
        try:
            return ctx.copy().run(fn, item), None
        except Exception as e:  # noqa: BLE001
            return None, e

    return [_POOL.submit(wrap, item) for item in items]


def read_all_file_info(
    disks: list[StorageAPI | None], bucket: str, path: str, version_id: str = ""
) -> tuple[list[FileInfo | None], list[Exception | None]]:
    """ReadVersion from every drive in parallel (readAllFileInfo,
    cmd/erasure-metadata-utils.go:122)."""

    def read_one(disk):
        if disk is None:
            raise errors.DiskNotFound()
        return disk.read_version(bucket, path, version_id)

    results = parallel_map(read_one, disks)
    return [r for r, _ in results], [e for _, e in results]


def _quorum_key(fi: FileInfo) -> tuple:
    return (
        round(fi.mod_time, 6),
        fi.version_id,
        fi.data_dir,
        fi.deleted,
        fi.size,
        fi.erasure.data_blocks,
        fi.erasure.parity_blocks,
    )


def find_file_info_in_quorum(
    metas: list[FileInfo | None], quorum: int
) -> FileInfo:
    """Pick the FileInfo agreed by >= quorum drives
    (findFileInfoInQuorum, cmd/erasure-metadata.go)."""
    counts: dict[tuple, int] = {}
    rep: dict[tuple, FileInfo] = {}
    for fi in metas:
        if fi is None:
            continue
        k = _quorum_key(fi)
        counts[k] = counts.get(k, 0) + 1
        rep.setdefault(k, fi)
    if counts:
        k = max(counts, key=lambda k: counts[k])
        if counts[k] >= quorum:
            return rep[k]
    raise errors.ErasureReadQuorum(msg="no metadata quorum")


def object_quorum_from_meta(
    metas: list[FileInfo | None], errs: list[Exception | None], default_parity: int
) -> tuple[int, int]:
    """(read_quorum, write_quorum) from the latest metadata
    (objectQuorumFromMeta, cmd/erasure-object.go:62 equivalent)."""
    for fi in metas:
        if fi is not None and fi.erasure.data_blocks:
            d, p = fi.erasure.data_blocks, fi.erasure.parity_blocks
            return d, (d + 1 if d == p else d)
    n = len(metas)
    d = n - default_parity
    return d, (d + 1 if d == default_parity else d)


def list_online_disks(
    disks: list[StorageAPI | None],
    metas: list[FileInfo | None],
    errs: list[Exception | None],
    quorum_fi: FileInfo,
) -> list[StorageAPI | None]:
    """Drives whose metadata matches the quorum version; others -> None
    (listOnlineDisks, cmd/erasure-healing-common.go)."""
    want = _quorum_key(quorum_fi)
    out: list[StorageAPI | None] = []
    for disk, fi in zip(disks, metas):
        if disk is not None and fi is not None and _quorum_key(fi) == want:
            out.append(disk)
        else:
            out.append(None)
    return out


def shuffle_disks_by_index(
    disks: list[StorageAPI | None], distribution: list[int]
) -> list[StorageAPI | None]:
    """Reorder so position j holds the drive storing shard j
    (shuffleDisks, cmd/erasure-metadata-utils.go): drive i holds shard
    distribution[i]-1."""
    if not distribution:
        return list(disks)
    shuffled: list[StorageAPI | None] = [None] * len(disks)
    for i, disk in enumerate(disks):
        shuffled[distribution[i] - 1] = disk
    return shuffled
