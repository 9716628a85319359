"""Local drive backend -- one POSIX directory tree per drive.

Role of the reference's xlStorage (cmd/xl-storage.go): implements the
StorageAPI-shaped per-drive contract in storage/interface.py. On-disk layout
per drive root:

    .minio_tpu.sys/
        format.json          drive identity + erasure topology (storage/format.py)
        tmp/<uuid>/...       staging area; renamed into place on commit
        buckets/...          system volume for object-layer bookkeeping
    <bucket>/<object>/xl.meta                 versioned metadata (+inline data)
    <bucket>/<object>/<data-dir-uuid>/part.N  bitrot-protected shard files

Commit is the reference's renameData discipline (cmd/xl-storage.go RenameData,
cmd/erasure-object.go:990): shard files are staged under tmp/ and the whole
data dir is os.rename()d into the object dir, then xl.meta is replaced via a
tmp-file + os.replace -- readers never observe a half-written object.

Durability is a knob, `MTPU_FSYNC={always,commit,never}` (default `commit`),
mirroring the reference's drive-sync discipline:

  * ``commit``  -- fdatasync staged shard data BEFORE the xl.meta that names
                   it exists (rename_data), fdatasync the staged xl.meta image
                   before os.replace publishes it, and fsync the parent dirs
                   so the rename itself is durable. Acked writes survive a
                   crash at any boundary; the staging appends stay unsynced.
  * ``always``  -- additionally fdatasync every shard append as it lands
                   (the O_DSYNC-style mode; what `LocalDrive(fsync=True)`
                   always did, now metered).
  * ``never``   -- no barriers anywhere: for benchmarking the sync cost and
                   for tests on tmpfs.

Every barrier is metered as the ("storage", "drive-sync") perf-ledger stage
so a run shows what durability costs. Crash points (chaos/crash.py) sit on
the two storage-internal boundaries -- after the data-dir rename / before
xl.meta, and after the staged xl.meta / before os.replace -- plus the
mid-writev torn-write hook in append_iov. All writes are plain buffered
``os`` calls.
"""

from __future__ import annotations

import os
import shutil
import time

from ..chaos import crash
from ..control.perf import GLOBAL_PERF
from ..control.sanitizer import san_rlock
from ..utils import errors
from .format import SYS_DIR, DriveFormat
from .interface import StorageAPI
from .types import DiskInfo, FileInfo, VolInfo, now
from .xlmeta import XLMeta

TMP_DIR = os.path.join(SYS_DIR, "tmp")
BUCKETS_META_DIR = os.path.join(SYS_DIR, "buckets")
XL_META_FILE = "xl.meta"

FSYNC_ALWAYS = "always"
FSYNC_COMMIT = "commit"
FSYNC_NEVER = "never"


def fsync_mode() -> str:
    """The process-wide durability mode from MTPU_FSYNC (default: commit)."""
    mode = os.environ.get("MTPU_FSYNC", FSYNC_COMMIT).strip().lower()
    return mode if mode in (FSYNC_ALWAYS, FSYNC_COMMIT, FSYNC_NEVER) else FSYNC_COMMIT


def _sync_fd(fd: int, *, datasync: bool = True) -> None:
    """Metered sync barrier: every fdatasync/fsync the durability discipline
    issues lands in the ("storage", "drive-sync") ledger stage."""
    t0 = time.perf_counter()
    (os.fdatasync if datasync else os.fsync)(fd)
    GLOBAL_PERF.ledger.record("storage", "drive-sync", time.perf_counter() - t0)


def _sync_path(p: str, *, datasync: bool = True) -> None:
    try:
        fd = os.open(p, os.O_RDONLY)
    except OSError:
        return  # vanished or unsyncable: the rename/commit will surface it
    try:
        _sync_fd(fd, datasync=datasync)
    finally:
        os.close(fd)


def _sync_dir(p: str) -> None:
    """fsync a directory so renames/creates inside it are durable (dir
    entries are metadata: full fsync, not fdatasync)."""
    _sync_path(p, datasync=False)


def _sync_tree(root: str) -> None:
    """fdatasync every file under root, then fsync the dirs bottom-up: the
    pre-commit barrier that makes a staged data dir durable before the
    xl.meta naming it can exist."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for n in filenames:
            _sync_path(os.path.join(dirpath, n))
        _sync_dir(dirpath)

# Volumes (buckets) must not collide with the system dir or look like paths.
_RESERVED_VOLS = {SYS_DIR, "", ".", ".."}


def _check_vol_name(volume: str) -> None:
    if volume in _RESERVED_VOLS and not volume.startswith(SYS_DIR):
        raise errors.VolumeNotFound()


class LocalDrive(StorageAPI):
    """A single local drive. Thread-safe; xl.meta read-modify-writes are
    serialized per drive (coarse; the object layer's namespace lock is the
    real concurrency gate, as in the reference)."""

    def __init__(self, root: str, fsync: bool = False):
        self.root = os.path.abspath(root)
        self.fsync = fsync
        # RLock: delete_version (marker path) re-enters write_metadata.
        self._meta_lock = san_rlock("LocalDrive._meta_lock")
        self._disk_id: str | None = None
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)
        os.makedirs(os.path.join(self.root, BUCKETS_META_DIR), exist_ok=True)

    def _mode(self) -> str:
        """Effective durability mode: LocalDrive(fsync=True) pins `always`
        (the pre-knob behaviour); otherwise MTPU_FSYNC decides."""
        return FSYNC_ALWAYS if self.fsync else fsync_mode()

    # -- identity ----------------------------------------------------------

    def endpoint(self) -> str:
        return self.root

    def is_online(self) -> bool:
        return os.path.isdir(self.root)

    def is_local(self) -> bool:
        return True

    def disk_id(self) -> str:
        if self._disk_id is None:
            fmt = DriveFormat.load(self.root)
            self._disk_id = fmt.this_id if fmt else ""
        return self._disk_id or ""

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id

    def disk_info(self) -> DiskInfo:
        try:
            st = os.statvfs(self.root)
        except OSError as e:
            raise errors.DiskNotFound(str(e))
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return DiskInfo(
            total=total,
            free=free,
            used=total - free,
            endpoint=self.root,
            mount_path=self.root,
            disk_id=self.disk_id(),
        )

    # -- path helpers --------------------------------------------------------

    def _vol_path(self, volume: str) -> str:
        _check_vol_name(volume)
        p = os.path.normpath(os.path.join(self.root, volume))
        if not (p + os.sep).startswith(self.root + os.sep):
            raise errors.VolumeNotFound()
        return p

    def _file_path(self, volume: str, path: str) -> str:
        vol = self._vol_path(volume)
        p = os.path.normpath(os.path.join(vol, path))
        if not (p + os.sep).startswith(vol + os.sep) and p != vol:
            raise errors.FileAccessDenied()
        return p

    # -- volumes -------------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        p = self._vol_path(volume)
        if os.path.isdir(p):
            raise errors.VolumeExists()
        os.makedirs(p, exist_ok=True)

    def stat_vol(self, volume: str) -> VolInfo:
        p = self._vol_path(volume)
        try:
            st = os.stat(p)
        except FileNotFoundError:
            raise errors.VolumeNotFound()
        return VolInfo(name=volume, created=st.st_mtime)

    def list_vols(self) -> list[VolInfo]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name == SYS_DIR or not os.path.isdir(os.path.join(self.root, name)):
                continue
            out.append(self.stat_vol(name))
        return out

    def delete_vol(self, volume: str, force: bool = False) -> None:
        p = self._vol_path(volume)
        if not os.path.isdir(p):
            raise errors.VolumeNotFound()
        if force:
            shutil.rmtree(p)
            return
        try:
            os.rmdir(p)
        except OSError:
            raise errors.VolumeNotEmpty()

    # -- small whole files (config, format, system state) --------------------

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        # Plain small-file writes (config, bookkeeping) only barrier in
        # `always` mode; xl.meta commits go through _write_xl below.
        self._write_all(
            self._file_path(volume, path), data,
            barrier=self._mode() == FSYNC_ALWAYS,
        )

    def _write_all(
        self, p: str, data: bytes, barrier: bool, commit_point: str | None = None
    ) -> None:
        """Atomic whole-file write: stage `<p>.tmp<rand>`, optionally
        fdatasync it, os.replace into place, optionally fsync the parent so
        the replace is durable. `commit_point` names the crash point fired
        between the durable staged image and the publishing replace."""
        tmp = p + ".tmp" + os.urandom(4).hex()
        try:
            f = open(tmp, "wb")
        except FileNotFoundError:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            f = open(tmp, "wb")
        with f:
            f.write(data)
            if barrier:
                f.flush()
                _sync_fd(f.fileno())
        if commit_point is not None:
            crash.crash_point(commit_point, self.root)
        os.replace(tmp, p)
        if barrier:
            _sync_dir(os.path.dirname(p))

    def read_all(self, volume: str, path: str) -> bytes:
        p = self._file_path(volume, path)
        try:
            with open(p, "rb") as f:
                return f.read()
        except FileNotFoundError:
            if not os.path.isdir(self._vol_path(volume)):
                raise errors.VolumeNotFound()
            raise errors.FileNotFound()
        except IsADirectoryError:
            raise errors.FileNotFound()

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        p = self._file_path(volume, path)
        try:
            if os.path.isdir(p):
                if recursive:
                    shutil.rmtree(p)
                else:
                    os.rmdir(p)
            else:
                os.remove(p)
        except FileNotFoundError:
            raise errors.FileNotFound()
        except OSError:
            raise errors.PathNotEmpty()
        # Prune now-empty parent dirs up to the volume root (the reference
        # deletes parent prefixes too, cmd/xl-storage.go deleteFile).
        parent = os.path.dirname(p)
        vol = self._vol_path(volume)
        while parent != vol and parent.startswith(vol):
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    # -- shard files ---------------------------------------------------------

    def create_file(self, volume: str, path: str, data: bytes) -> None:
        """Write a (bitrot-protected) shard file. Callers stage under tmp
        volume then rename_data into place."""
        p = self._file_path(volume, path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
            if self._mode() == FSYNC_ALWAYS:
                f.flush()
                _sync_fd(f.fileno())

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        p = self._file_path(volume, path)
        try:
            f = open(p, "ab")
        except FileNotFoundError:
            # First append on this staged file: make the parent then. The
            # happy path (every subsequent group) skips the makedirs stat
            # walk — it was ~5 syscalls per drive per 16 MiB group.
            os.makedirs(os.path.dirname(p), exist_ok=True)
            f = open(p, "ab")
        with f:
            f.write(data)
            if self._mode() == FSYNC_ALWAYS:
                f.flush()
                _sync_fd(f.fileno())

    def append_iov(self, volume: str, path: str, iovecs: list) -> None:
        """Gathered append: the whole group's digest/chunk views go down in
        one os.writev (releases the GIL) instead of per-block appends.

        The torn-write crash point lives here: an armed spec truncates the
        LAST iovec at a seeded offset before the writev -- the at-rest state
        a power-cut / SIGKILL mid-writev leaves -- then either dies
        (torn-kill) or returns normally (torn: silent corruption the bitrot
        digests must catch on read)."""
        p = self._file_path(volume, path)
        try:
            fd = os.open(p, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        except FileNotFoundError:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            fd = os.open(p, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            vecs = [memoryview(v) for v in iovecs if len(v)]
            torn_kill = False
            if vecs:
                hint = crash.torn_hint(
                    "storage.append-iov.torn", self.root, len(vecs[-1])
                )
                if hint is not None:
                    cut, torn_kill = hint
                    vecs[-1] = vecs[-1][:cut]
                    vecs = [v for v in vecs if len(v)]
            while vecs:
                written = os.writev(fd, vecs)
                # Short writev: drop fully-written vecs, trim the partial one.
                while vecs and written >= len(vecs[0]):
                    written -= len(vecs[0])
                    vecs.pop(0)
                if written:
                    vecs[0] = vecs[0][written:]
            if torn_kill:
                crash.die()
            if self._mode() == FSYNC_ALWAYS:
                _sync_fd(fd)
        finally:
            os.close(fd)

    def read_file(self, volume: str, path: str, offset: int = 0, length: int = -1) -> bytes:
        p = self._file_path(volume, path)
        try:
            with open(p, "rb") as f:
                f.seek(offset)
                return f.read() if length < 0 else f.read(length)
        except FileNotFoundError:
            raise errors.FileNotFound()
        except IsADirectoryError:
            raise errors.FileNotFound()

    def read_file_into(
        self, volume: str, path: str, offset: int, buf: memoryview
    ) -> int:
        """readinto a caller-owned (pooled) window: bytes land in the
        destination storage once, with no intermediate bytes object."""
        p = self._file_path(volume, path)
        try:
            with open(p, "rb", buffering=0) as f:
                f.seek(offset)
                total = 0
                want = len(buf)
                while total < want:
                    n = f.readinto(buf[total:])
                    if not n:
                        break  # EOF short read
                    total += n
                return total
        except FileNotFoundError:
            raise errors.FileNotFound()
        except IsADirectoryError:
            raise errors.FileNotFound()

    def stat_file(self, volume: str, path: str) -> int:
        p = self._file_path(volume, path)
        try:
            st = os.stat(p)
        except FileNotFoundError:
            raise errors.FileNotFound()
        if not os.path.isfile(p):
            raise errors.IsNotRegular()
        return st.st_size

    # -- object metadata (xl.meta) -------------------------------------------

    def _meta_path(self, volume: str, path: str) -> str:
        return self._file_path(volume, os.path.join(path, XL_META_FILE))

    def _write_xl(self, volume: str, path: str, data: bytes) -> None:
        """Publish a new xl.meta image: the commit point of every version
        change. Barriered in `commit` and `always` modes, with the
        storage.xlmeta.pre-replace crash point between the durable staged
        image and the os.replace that makes it visible."""
        self._write_all(
            self._meta_path(volume, path), data,
            barrier=self._mode() != FSYNC_NEVER,
            commit_point="storage.xlmeta.pre-replace",
        )

    def read_xl(self, volume: str, path: str) -> XLMeta:
        try:
            raw = self.read_all(volume, os.path.join(path, XL_META_FILE))
        except errors.FileNotFound:
            raise errors.FileNotFound()
        return XLMeta.from_bytes(raw)

    def read_version(self, volume: str, path: str, version_id: str = "") -> FileInfo:
        fi = self.read_xl(volume, path).file_info(version_id)
        fi.volume = volume
        fi.name = path
        return fi

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Add/replace one version in the object's xl.meta."""
        with self._meta_lock:
            try:
                meta = self.read_xl(volume, path)
            except errors.FileNotFound:
                meta = XLMeta()
            meta.add_version(fi)
            # The read-modify-write of xl.meta IS the critical section;
            # dropping the lock before the write would let a concurrent
            # writer interleave a stale image.
            self._write_xl(volume, path, meta.to_bytes())

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        with self._meta_lock:
            meta = self.read_xl(volume, path)
            meta.find_version(fi.version_id)  # must exist
            meta.add_version(fi)
            self._write_xl(volume, path, meta.to_bytes())

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Remove a version; drop data dir; remove object dir when empty.

        If fi.deleted is set, a delete-marker version is ADDED instead
        (versioned delete), matching the reference DeleteVersion semantics.
        """
        with self._meta_lock:
            if fi.deleted:
                self.write_metadata(volume, path, fi)
                return
            meta = self.read_xl(volume, path)
            removed = meta.delete_version(fi.version_id)
            if removed.data_dir:
                try:
                    self.delete(volume, os.path.join(path, removed.data_dir), recursive=True)
                except errors.DiskError:
                    pass
            if meta.versions:
                    self._write_xl(volume, path, meta.to_bytes())
            else:
                try:
                    self.delete(volume, os.path.join(path, XL_META_FILE))
                except errors.FileNotFound:
                    pass

    # -- atomic object commit ------------------------------------------------

    def rename_data(
        self, src_volume: str, src_path: str, fi: FileInfo, dst_volume: str, dst_path: str
    ) -> None:
        """Commit a staged object: move tmp data dir into the object dir and
        publish the new version in xl.meta (reference RenameData,
        cmd/xl-storage.go; called from erasure putObject :990).

        Barrier order (commit/always modes): fdatasync the staged shards +
        dirs FIRST, then rename, then fsync the object dir, and only then
        write xl.meta -- so no xl.meta can ever name shard bytes the kernel
        hasn't been told to keep."""
        dst_obj_dir = self._file_path(dst_volume, dst_path)
        os.makedirs(dst_obj_dir, exist_ok=True)
        barrier = self._mode() != FSYNC_NEVER
        src_parent = None
        if fi.data_dir:
            src = self._file_path(src_volume, src_path)
            if not os.path.isdir(src):
                raise errors.FileNotFound()
            if barrier:
                _sync_tree(src)
            dst = os.path.join(dst_obj_dir, fi.data_dir)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.rename(src, dst)
            if barrier:
                _sync_dir(dst_obj_dir)
            src_parent = os.path.dirname(src)
        crash.crash_point("storage.rename-data.pre-meta", self.root)
        self.write_metadata(dst_volume, dst_path, fi)
        # The rename consumed tmp/<stage-id>/<i>; drop the now-empty
        # <stage-id> parent so committed PUTs leave tmp/ clean (it used to
        # leak one empty dir per upload per drive -- the recovery scan would
        # count each as an orphan).
        if src_parent is not None:
            try:
                os.rmdir(src_parent)
            except OSError:
                pass  # other shards still staging, or already gone

    def rename_file(self, src_volume: str, src_path: str, dst_volume: str, dst_path: str) -> None:
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        if not os.path.exists(src):
            raise errors.FileNotFound()
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if self._mode() != FSYNC_NEVER and os.path.isfile(src):
            # Publish-by-rename (multipart part promote): the named bytes
            # must be durable before the durable name exists.
            _sync_path(src)
        os.replace(src, dst)
        if self._mode() != FSYNC_NEVER:
            _sync_dir(os.path.dirname(dst))

    # -- listing / walking ---------------------------------------------------

    def list_dir(self, volume: str, path: str) -> list[str]:
        """Immediate children; dirs get a trailing slash (ListDir contract)."""
        p = self._file_path(volume, path) if path else self._vol_path(volume)
        try:
            names = os.listdir(p)
        except FileNotFoundError:
            raise errors.FileNotFound()
        except NotADirectoryError:
            raise errors.FileNotFound()
        out = []
        for n in sorted(names):
            if os.path.isdir(os.path.join(p, n)):
                out.append(n + "/")
            else:
                out.append(n)
        return out

    def walk_dir(self, volume: str, base: str = "", recursive: bool = True):
        """Yield (object_path, xl.meta bytes) for every object under base,
        in sorted order (the WalkDir streamer, cmd/metacache-walk.go:62).

        An "object" is any directory containing an xl.meta file; walking does
        not descend into data dirs.
        """
        vol = self._vol_path(volume)
        if not os.path.isdir(vol):
            raise errors.VolumeNotFound()
        start = os.path.join(vol, base) if base else vol

        def emit(dir_path: str):
            meta_p = os.path.join(dir_path, XL_META_FILE)
            rel = os.path.relpath(dir_path, vol).replace(os.sep, "/")
            if os.path.isfile(meta_p):
                with open(meta_p, "rb") as f:
                    yield rel, f.read()
                return  # do not descend into data dirs
            try:
                children = sorted(os.listdir(dir_path))
            except (FileNotFoundError, NotADirectoryError):
                return
            for c in children:
                sub = os.path.join(dir_path, c)
                if os.path.isdir(sub):
                    if recursive:
                        yield from emit(sub)
                    else:
                        meta_c = os.path.join(sub, XL_META_FILE)
                        rel_c = os.path.relpath(sub, vol).replace(os.sep, "/")
                        if os.path.isfile(meta_c):
                            with open(meta_c, "rb") as f:
                                yield rel_c, f.read()
                        else:
                            yield rel_c + "/", b""

        if not os.path.isdir(start):
            return
        yield from emit(start)

    # -- bitrot verification -------------------------------------------------

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep bitrot scan of all part files for a version
        (reference VerifyFile, cmd/xl-storage.go)."""
        from ..ops import bitrot as bitrot_mod

        if fi.inline_data or not fi.data_dir:
            return
        shard_size = fi.erasure.shard_size()
        for part in fi.parts:
            part_path = os.path.join(path, fi.data_dir, f"part.{part.number}")
            data = self.read_file(volume, part_path)
            part_shard_size = fi.erasure.shard_file_size(part.size)
            try:
                bitrot_mod.verify_stream(data, part_shard_size, shard_size)
            except bitrot_mod.BitrotCorrupt as e:
                raise errors.FileCorrupt(str(e))
