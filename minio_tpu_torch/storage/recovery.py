"""Restart recovery: sweep crash debris off the drives before serving.

The other half of the durability contract (the barriers in local.py are the
first half). A process death at any commit-path boundary leaves one of a
small set of states on disk, each swept here at node start (and again each
time a pre-fork worker respawns, since every worker re-runs Node.build):

  * ``tmp/<pid>.<uuid>/...``         -- staged PUT / heal shards whose owner
                                        died pre-commit. GC'd once the owner
                                        pid is dead; a LIVE sibling worker's
                                        staging is left alone.
  * ``.../part.N.tmp.<pid>.<hex>``   -- multipart part stage files (the part
                                        was never published). Same pid rule.
  * ``<p>.tmp<rand>``                -- atomic write_all staging that never
                                        reached os.replace (the replace
                                        either happened or the final file is
                                        untouched). The name carries no pid,
                                        so a file goes only once it has sat
                                        unchanged for STAGING_GRACE_S: a live
                                        write (a sibling worker's, a peer's
                                        through this node's storage REST)
                                        replaces its staging file within
                                        milliseconds. Swept in the buckets
                                        and, in the port, in the meta bucket
                                        too: a process killed mid-commit of a
                                        config-store object (IAM, the
                                        scanner's usage, the tier journal)
                                        leaves them there, and the JAX
                                        package's scan never looks.
  * unreferenced data dirs           -- rename_data died between the data-dir
                                        rename and the xl.meta publish: shard
                                        files exist under the object dir but
                                        no version names them.
  * partial versions                 -- a version committed on j < n drives.
                                        At or above read quorum it is fed to
                                        heal (MRF); below quorum -- the ack
                                        can never have been sent -- it is
                                        rolled back, but ONLY when every
                                        drive in the set is visible (a drive
                                        missing during a rolling restart must
                                        not trigger a mass rollback).

Everything swept is counted (minio_tpu_crash_recovery_* in /metrics) so a
fleet where workers die often shows up as a recovery-rate signal, not as
silently shrinking free space.
"""

from __future__ import annotations

import os
import re
import time

from ..control.sanitizer import san_lock
from ..utils import errors
from .xlmeta import XLMeta

# Matches the atomic-write staging suffix local.py's _write_all uses
# (`<final>.tmp<8 hex chars>`) and the multipart part stage infix.
_TMP_SUFFIX_RE = re.compile(r"\.tmp[0-9a-f]{8}$")
_STAGE_INFIX_RE = re.compile(r"\.tmp\.(\d+)\.[0-9a-f]+$")
_PART_FILE_RE = re.compile(r"^part\.\d+$")

# A staging file unchanged this long since its last write is a dead
# process's: an atomic write replaces its own within milliseconds.
STAGING_GRACE_S = 10.0
_STAGING_POLL_S = 0.1

_COUNTER_KEYS = (
    "scans",            # recover_drive passes completed
    "tmp_dirs",         # dead-owner tmp/<stage-id> trees GC'd
    "stage_files",      # dead-owner multipart .tmp. part stages GC'd
    "tmp_files",        # orphaned atomic-write .tmp<rand> files GC'd
    "orphan_data_dirs", # data dirs no xl.meta version references, GC'd
    "corrupt_meta",     # xl.meta that failed to parse (left for heal)
    "partial_healed",   # sub-set-width versions queued for heal
    "partial_gc",       # below-quorum versions rolled back
    "selftest_debris",  # aborted-speedtest scratch volumes dropped
)

# Mirrors control/selftest.py SCRATCH_BUCKET -- kept as a literal so the
# storage layer never imports the control plane (test_selftest pins the two
# constants equal). An aborted speedtest (admin node died mid-ramp) leaves
# probe objects here; they are debris by definition, never client data.
_SELFTEST_BUCKET = ".mtpu-speedtest"

_lock = san_lock("recovery.counters")
_counters: dict = {k: 0 for k in _COUNTER_KEYS}


def counters() -> dict:
    with _lock:
        return dict(_counters)


def _bump(key: str, by: int = 1) -> None:
    if by:
        with _lock:
            _counters[key] += by


def reset_counters() -> None:
    with _lock:
        for k in _COUNTER_KEYS:
            _counters[k] = 0


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def _owner_pid(name: str) -> int:
    """Owner pid from a `<pid>.<uuid>` stage-dir name; 0 (= dead/unknown,
    always collectable) when the name predates pid-scoped staging."""
    head = name.split(".", 1)[0]
    return int(head) if head.isdigit() else 0


# ---------------------------------------------------------------------------
# per-drive sweep
# ---------------------------------------------------------------------------


def recover_drive(drive, meta_bucket: str = ".minio_tpu.sys") -> dict:
    """Sweep one drive's crash debris. Returns this pass's deltas."""
    before = counters()
    _sweep_tmp(drive, meta_bucket)
    _sweep_multipart_stages(drive, meta_bucket)
    _sweep_selftest(drive)
    staged = _meta_staging(drive, meta_bucket)
    for vol in _safe_vols(drive):
        staged += _sweep_volume(drive, vol.name)
    _sweep_staging(staged)
    _bump("scans")
    after = counters()
    return {k: after[k] - before[k] for k in _COUNTER_KEYS}


def _safe_vols(drive):
    try:
        return drive.list_vols()
    except errors.StorageError:
        return []


def _sweep_tmp(drive, meta_bucket: str) -> None:
    """GC tmp/<stage-id> trees whose owner pid is dead."""
    try:
        names = drive.list_dir(meta_bucket, "tmp")
    except errors.StorageError:
        return
    for name in names:
        entry = name.rstrip("/")
        if name.endswith("/") and _pid_alive(_owner_pid(entry)):
            continue  # a live worker is still staging here
        try:
            drive.delete(meta_bucket, f"tmp/{entry}", recursive=True)
            _bump("tmp_dirs")
        except errors.StorageError:
            pass


def _sweep_selftest(drive) -> None:
    """Drop the whole speedtest scratch volume if a dead probe left it
    behind (a completed probe already removed it)."""
    try:
        drive.delete_vol(_SELFTEST_BUCKET, force=True)
        _bump("selftest_debris")
    except errors.VolumeNotFound:
        pass
    except errors.StorageError:
        pass


def _sweep_multipart_stages(drive, meta_bucket: str) -> None:
    """GC `.tmp.<pid>.<hex>` part stage files with dead owners. Upload dirs
    themselves are NOT debris -- in-progress multipart uploads survive
    restarts by design (abort/expiry owns their lifecycle)."""

    def recurse(path: str) -> None:
        try:
            names = drive.list_dir(meta_bucket, path)
        except errors.StorageError:
            return
        for name in names:
            child = f"{path}/{name.rstrip('/')}"
            if name.endswith("/"):
                recurse(child)
                continue
            m = _STAGE_INFIX_RE.search(name)
            if m and not _pid_alive(int(m.group(1))):
                try:
                    drive.delete(meta_bucket, child)
                    _bump("stage_files")
                except errors.StorageError:
                    pass

    recurse("multipart")


def _meta_staging(drive, meta_bucket: str) -> list:
    """The atomic-write staging files under the meta bucket, for
    _sweep_staging. Only the `<final>.tmp<8 hex>` files: the meta bucket's
    data dirs and prefixes belong to the tmp/ and multipart/ sweeps and to
    the config store."""
    root = drive._vol_path(meta_bucket)
    return [(os.path.join(dirpath, name), None)
            for dirpath, _, files in os.walk(root) for name in files if _TMP_SUFFIX_RE.search(name)]


def _sweep_staging(staged: list) -> None:
    """Remove the atomic-write staging files of `staged`, (path, root)
    pairs, that no live write owns, then the prefix dirs each leaves empty
    up to its root (None: none). A file that vanishes or changes while it is
    watched belongs to a live write and is left alone; one unchanged for
    STAGING_GRACE_S since its last write (or since it was first seen, if its
    mtime lies ahead of the clock) goes. Young files are watched until then,
    so a boot right after a crash still leaves no debris, and waits at most
    STAGING_GRACE_S for it."""
    seen: dict = {}
    for path, root in staged:
        try:
            seen[path] = (os.stat(path).st_mtime_ns, root)
        except OSError:
            pass
    t0 = time.monotonic()
    while seen:
        watched = time.monotonic() - t0
        for path, (mtime, root) in list(seen.items()):
            try:
                now_mtime = os.stat(path).st_mtime_ns
            except OSError:
                del seen[path]  # published or removed by its writer
                continue
            if now_mtime != mtime:
                del seen[path]  # still being written
                continue
            if time.time() - mtime / 1e9 < STAGING_GRACE_S and watched < STAGING_GRACE_S:
                continue
            del seen[path]
            try:
                os.remove(path)
                _bump("tmp_files")
            except OSError:
                continue
            parent = os.path.dirname(path)
            while root is not None and parent != root:
                try:
                    os.rmdir(parent)  # only succeeds on an empty dir
                except OSError:
                    break
                parent = os.path.dirname(parent)
        if seen:
            time.sleep(_STAGING_POLL_S)


def _sweep_volume(drive, volume: str) -> list:
    """Walk a bucket tree directly, GC'ing dead-owner stage files and data
    dirs no xl.meta version references. Returns the atomic-write staging
    files found, for _sweep_staging.

    Walks the filesystem rather than walk_dir because the debris is exactly
    what walk_dir is designed to skip (non-object files, dirs without
    xl.meta)."""
    root = drive._vol_path(volume)  # recovery is a LocalDrive-family concern
    staged: list = []

    def recurse(dir_path: str) -> None:
        try:
            names = sorted(os.listdir(dir_path))
        except OSError:
            return
        has_meta = "xl.meta" in names
        referenced: set | None = None
        if has_meta:
            try:
                with open(os.path.join(dir_path, "xl.meta"), "rb") as f:
                    meta = XLMeta.from_bytes(f.read())
                referenced = {v.data_dir for v in meta.versions if v.data_dir}
            except (OSError, errors.StorageError):
                # Unreadable commit record: nothing under this dir can be
                # proven orphan. Count it and let bitrot/heal judge.
                _bump("corrupt_meta")
                return
        for name in names:
            p = os.path.join(dir_path, name)
            if os.path.isfile(p):
                m = _STAGE_INFIX_RE.search(name)
                if _TMP_SUFFIX_RE.search(name):
                    staged.append((p, root))
                elif m and not _pid_alive(int(m.group(1))):
                    try:
                        os.remove(p)
                        _bump("tmp_files")
                    except OSError:
                        pass
                continue
            if not os.path.isdir(p):
                continue
            if referenced is not None:
                # Child dirs of an object dir are data dirs: keep only the
                # ones a version names.
                if name not in referenced:
                    import shutil

                    try:
                        shutil.rmtree(p)
                        _bump("orphan_data_dirs")
                    except OSError:
                        pass
                continue
            if _is_orphan_data_dir(p):
                # part.N files with no xl.meta beside them: rename_data died
                # before the metadata publish. The version never reached
                # this drive's xl.meta, so the shards are unreachable.
                import shutil

                try:
                    shutil.rmtree(p)
                    _bump("orphan_data_dirs")
                except OSError:
                    pass
                continue
            recurse(p)
        if dir_path != root and not has_meta:
            # A prefix dir left empty by the GC above (or by a rename that
            # died after makedirs) is a phantom prefix in listings; rmdir
            # only succeeds when it is actually empty, so a dir that still
            # holds live children is untouched.
            try:
                os.rmdir(dir_path)
            except OSError:
                pass

    recurse(root)
    return staged


def _is_orphan_data_dir(dir_path: str) -> bool:
    try:
        names = os.listdir(dir_path)
    except OSError:
        return False
    return bool(names) and all(
        _PART_FILE_RE.match(n) and os.path.isfile(os.path.join(dir_path, n))
        for n in names
    )


# ---------------------------------------------------------------------------
# cross-drive reconciliation
# ---------------------------------------------------------------------------


def recover_set(eo, heal=None) -> dict:
    """Reconcile partially committed versions across one erasure set.

    For every version present on fewer than all drives: at or above its own
    read quorum (data_blocks from its erasure info) it is handed to `heal`
    (MRF signature: heal(bucket, object, version_id)); below quorum it is
    rolled back -- but rollback requires EVERY drive in the set online and
    readable, so a rolling restart can only ever queue heals, never GC."""
    before = counters()
    disks = list(eo.disks)
    n = len(disks)
    all_visible = all(d is not None and d.is_online() for d in disks)

    buckets: set[str] = set()
    for d in disks:
        if d is None:
            continue
        try:
            buckets.update(v.name for v in d.list_vols())
        except errors.StorageError:
            all_visible = False

    for bucket in sorted(buckets):
        # (object, version_id) -> [k_of_version, holder drive indices]
        seen: dict = {}
        visible = all_visible
        for i, d in enumerate(disks):
            if d is None:
                continue
            try:
                for obj_path, raw in d.walk_dir(bucket):
                    if not raw:
                        continue
                    try:
                        meta = XLMeta.from_bytes(raw)
                    except errors.StorageError:
                        _bump("corrupt_meta")
                        continue
                    for v in meta.versions:
                        key = (obj_path, v.version_id)
                        ent = seen.setdefault(key, [v.erasure.data_blocks or 0, []])
                        ent[1].append(i)
            except errors.StorageError:
                visible = False
        for (obj_path, vid), (k_of, holders) in seen.items():
            if len(holders) >= n:
                continue
            quorum = k_of if k_of > 0 else (n - getattr(eo, "parity", 0))
            if len(holders) >= quorum:
                if heal is not None:
                    heal(bucket, obj_path, vid)
                    _bump("partial_healed")
                continue
            if not visible:
                continue  # can't prove it never reached quorum: leave it
            from .types import FileInfo

            for i in holders:
                try:
                    disks[i].delete_version(
                        bucket, obj_path, FileInfo(version_id=vid)
                    )
                except errors.StorageError:
                    pass
            _bump("partial_gc")
    after = counters()
    return {k: after[k] - before[k] for k in _COUNTER_KEYS}
