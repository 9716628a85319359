"""Server pools: the top-level ObjectLayer.

Role of the reference's erasureServerPools (cmd/erasure-server-pool.go):
multiple independent pools of erasure sets behind one namespace. New objects
go to the pool with the most free space (:222-288); reads/deletes probe the
pool that actually holds the object (:289-372); buckets and listings span all
pools. This is the object the API layer holds (its `ObjectAPI()`).

Pools carry a lifecycle status (the decommission states of
cmd/erasure-server-pool-decom.go): ACTIVE pools take new writes; SUSPENDED
pools exist cluster-wide but do not place yet (the first phase of a two-phase
attach, driven by object/poolmgr.py);
DRAINING pools serve reads while their objects migrate out but never receive
placements; DECOMMISSIONED pools are empty and skipped entirely. Placement
(`_pool_with_space`) considers only ACTIVE pools; existence probes
(`_pool_holding`, listings, multipart, heal) consider all non-decommissioned
pools.
"""

from __future__ import annotations

from ..storage.interface import StorageAPI
from ..utils import errors
from . import codec as codec_mod
from . import metadata as meta_mod
from .sets import ErasureSets
from .types import (
    BucketInfo,
    DeleteObjectOptions,
    GetObjectOptions,
    HealResultItem,
    ListObjectsInfo,
    ListObjectVersionsInfo,
    ObjectInfo,
    PutObjectOptions,
)

# Pool lifecycle statuses (poolMeta decommission states, reference
# cmd/erasure-server-pool-decom.go; the transitions are owned by
# object/poolmgr.py).
POOL_ACTIVE = "active"
POOL_SUSPENDED = "suspended"
POOL_DRAINING = "draining"
POOL_DECOMMISSIONED = "decommissioned"


class ServerPools:
    # The API front streams request/response bodies through this layer
    # (put_object accepts a .read(n) stream; get_object_stream exists).
    supports_streaming = True

    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("need at least one pool")
        self.pools = pools
        self.statuses: list[str] = [POOL_ACTIVE] * len(pools)

    # -- convenience constructors ---------------------------------------------

    @classmethod
    def single(
        cls,
        disks: list[StorageAPI],
        set_drive_count: int | None = None,
        parity: int | None = None,
        codec: codec_mod.BlockCodec | None = None,
    ) -> "ServerPools":
        count = set_drive_count or len(disks)
        return cls([ErasureSets(list(disks), count, parity=parity, codec=codec)])

    # -- pool lifecycle --------------------------------------------------------

    def add_pool(self, sets: ErasureSets, status: str = POOL_SUSPENDED) -> int:
        """Append a pool at runtime (attach-pool expansion). Returns its
        index. Added SUSPENDED by default: the pool manager flips it
        ACTIVE only after the pool-config epoch has fanned out."""
        self.pools.append(sets)
        self.statuses.append(status)
        return len(self.pools) - 1

    def set_pool_status(self, pool_index: int, status: str) -> None:
        self.statuses[pool_index] = status

    def _probe_pools(self) -> list[tuple[int, ErasureSets]]:
        """Pools that may hold data: everything not decommissioned."""
        return [
            (i, p) for i, p in enumerate(self.pools)
            if self.statuses[i] != POOL_DECOMMISSIONED
        ]

    # -- pool selection --------------------------------------------------------

    def _pool_with_space(self) -> ErasureSets:
        """Placement target: the ACTIVE pool with the most free bytes,
        ties broken by lowest pool index -- deterministic, so every node
        running the same pool config places identically. Suspended /
        draining / decommissioned pools never receive new writes."""
        best: ErasureSets | None = None
        best_key: tuple[int, int] | None = None
        for i, p in enumerate(self.pools):
            if self.statuses[i] != POOL_ACTIVE:
                continue
            free = 0
            for d in p.disks:
                if d is None:
                    continue
                try:
                    free += d.disk_info().free
                except errors.DiskError:
                    continue
            key = (-free, i)
            if best_key is None or key < best_key:
                best, best_key = p, key
        if best is None:
            raise errors.DiskFull("no active pool available for writes")
        return best

    def _pool_holding_index(
        self, bucket: str, object_name: str, version_id: str = ""
    ) -> int:
        """Index of the pool holding the newest copy. Probes run in
        parallel across candidate pools; during a migration window (the
        object momentarily present in two pools) the newest mod_time wins,
        lowest pool index on an exact tie."""
        if len(self.pools) == 1:
            return 0
        cands = [
            i for i, st in enumerate(self.statuses)
            if st != POOL_DECOMMISSIONED
        ]
        if len(cands) == 1:
            # Negative-lookup fast path: decommissioned pools are empty by
            # invariant, so a single live pool needs no existence probe.
            return cands[0]

        def probe(i: int) -> ObjectInfo:
            return self.pools[i].get_object_info(
                bucket, object_name, GetObjectOptions(version_id)
            )

        best: int | None = None
        best_key: tuple[float, int] | None = None
        last: Exception | None = None
        for i, (oi, err) in zip(cands, meta_mod.parallel_map(probe, cands)):
            if err is not None:
                if isinstance(err, errors.ObjectError):
                    last = err
                    continue
                raise err
            key = (oi.mod_time, -i)
            if best_key is None or key > best_key:
                best, best_key = i, key
        if best is None:
            raise last or errors.ObjectNotFound(bucket, object_name)
        return best

    def _pool_holding(self, bucket: str, object_name: str, version_id: str = "") -> ErasureSets:
        return self.pools[self._pool_holding_index(bucket, object_name, version_id)]

    # -- buckets ---------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        _validate_bucket_name(bucket)
        results = meta_mod.parallel_map(lambda p: p.make_bucket(bucket), self.pools)
        for _, e in results:
            if e is not None:
                raise e

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.pools[0].get_bucket_info(bucket)

    def bucket_exists(self, bucket: str) -> bool:
        try:
            self.get_bucket_info(bucket)
            return True
        except errors.BucketNotFound:
            return False

    def invalidate_bucket_cache(self, bucket: str = "") -> None:
        for p in self.pools:
            p.invalidate_bucket_cache(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        # Refuse unless empty across every pool (unless forced).
        if not force:
            for p in self.pools:
                listing = p.list_objects(bucket, max_keys=1)
                if listing.objects or listing.prefixes:
                    raise errors.BucketNotEmpty(bucket)
        results = meta_mod.parallel_map(lambda p: p.delete_bucket(bucket, True), self.pools)
        for _, e in results:
            if e is not None:
                raise e

    def list_buckets(self) -> list[BucketInfo]:
        return self.pools[0].list_buckets()

    # -- objects ---------------------------------------------------------------

    def put_object(
        self, bucket: str, object_name: str, data: bytes, opts: PutObjectOptions | None = None
    ) -> ObjectInfo:
        _validate_object_name(bucket, object_name)
        # Overwrites must land in the pool that already holds the object --
        # unless that pool stopped taking writes (draining/suspended), in
        # which case the overwrite places fresh and the drain removes the
        # old copy.
        pool = None
        try:
            idx = self._pool_holding_index(bucket, object_name)
            if self.statuses[idx] == POOL_ACTIVE:
                pool = self.pools[idx]
        except errors.ObjectError:
            pass
        if pool is None:
            pool = self._pool_with_space()
        return pool.put_object(bucket, object_name, data, opts)

    def get_object(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> tuple[ObjectInfo, bytes]:
        opts = opts or GetObjectOptions()
        # Resolve to the pool with the NEWEST copy (not first-found): during
        # a drain/rebalance move window the object briefly exists in two
        # pools, and first-found could serve the stale source copy.
        i = self._pool_holding_index(bucket, object_name, opts.version_id)
        return self.pools[i].get_object(bucket, object_name, opts, offset, length)

    def get_object_stream(
        self,
        bucket: str,
        object_name: str,
        opts: GetObjectOptions | None = None,
        offset: int = 0,
        length: int = -1,
    ):
        """Streaming get: (ObjectInfo, iterator of decoded chunks)."""
        opts = opts or GetObjectOptions()
        i = self._pool_holding_index(bucket, object_name, opts.version_id)
        return self.pools[i].get_object_stream(bucket, object_name, opts, offset, length)

    def get_object_info(
        self, bucket: str, object_name: str, opts: GetObjectOptions | None = None
    ) -> ObjectInfo:
        opts = opts or GetObjectOptions()
        i = self._pool_holding_index(bucket, object_name, opts.version_id)
        return self.pools[i].get_object_info(bucket, object_name, opts)

    def put_object_metadata(
        self, bucket, object_name, version_id: str = "", updates=None, removes=None
    ) -> ObjectInfo:
        pool = self._pool_holding(bucket, object_name, version_id)
        return pool.put_object_metadata(bucket, object_name, version_id, updates, removes)

    def transition_object(
        self,
        bucket,
        object_name,
        version_id: str,
        tier: str,
        remote_name: str,
        expected_etag: str = "",
        expected_mtime: float = 0.0,
    ) -> ObjectInfo:
        pool = self._pool_holding(bucket, object_name, version_id)
        return pool.transition_object(
            bucket, object_name, version_id, tier, remote_name, expected_etag, expected_mtime
        )

    def delete_object(
        self, bucket: str, object_name: str, opts: DeleteObjectOptions | None = None
    ) -> ObjectInfo:
        opts = opts or DeleteObjectOptions()
        if opts.versioned and not opts.version_id:
            # Delete marker goes where the object lives (or a write pool).
            try:
                pool = self._pool_holding(bucket, object_name)
            except errors.ObjectError:
                pool = self._pool_with_space()
            return pool.delete_object(bucket, object_name, opts)
        # Physical delete sweeps EVERY live pool: during a migration window
        # the object exists in two pools, and removing only the first-found
        # copy would let the other pool resurrect it.
        last: Exception | None = None
        result: ObjectInfo | None = None
        for _i, p in self._probe_pools():
            try:
                result = p.delete_object(bucket, object_name, opts)
            except (errors.ObjectNotFound, errors.VersionNotFound) as e:
                last = e
        if result is not None:
            return result
        if last:
            raise last
        return ObjectInfo(bucket=bucket, name=object_name)

    def delete_objects(
        self, bucket: str, objects: list[tuple[str, str]], versioned: bool = False
    ) -> list[tuple[ObjectInfo | None, Exception | None]]:
        """Bulk delete: [(name, version_id)] -> per-entry result."""

        def rm(item):
            name, vid = item
            return self.delete_object(
                bucket, name, DeleteObjectOptions(version_id=vid, versioned=versioned)
            )

        return meta_mod.parallel_map(rm, objects)

    # -- listing ---------------------------------------------------------------

    def list_objects(
        self,
        bucket: str,
        prefix: str = "",
        marker: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
    ) -> ListObjectsInfo:
        probes = self._probe_pools()
        if len(probes) == 1:
            return probes[0][1].list_objects(bucket, prefix, marker, delimiter, max_keys)
        # Merge per-pool listings (each sorted). As in the JAX package: with a
        # delimiter, each pool cuts its page at its own point and the merged
        # next_marker is the last object name, so keys of a pool can fall
        # between pages and be skipped. Without a delimiter the merge is exact.
        merged = ListObjectsInfo()
        streams = [
            p.list_objects(bucket, prefix, marker, delimiter, max_keys)
            for _i, p in probes
        ]
        names: dict[str, ObjectInfo] = {}
        for s in streams:
            for o in s.objects:
                if o.name not in names or o.mod_time > names[o.name].mod_time:
                    names[o.name] = o
        prefixes = sorted({cp for s in streams for cp in s.prefixes})
        ordered = sorted(names)
        for name in ordered[:max_keys]:
            merged.objects.append(names[name])
        if len(ordered) > max_keys or any(s.is_truncated for s in streams):
            merged.is_truncated = True
            if merged.objects:
                merged.next_marker = merged.objects[-1].name
        merged.prefixes = prefixes
        return merged

    def list_object_versions(
        self,
        bucket: str,
        prefix: str = "",
        key_marker: str = "",
        version_marker: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
    ) -> ListObjectVersionsInfo:
        probes = self._probe_pools()
        if len(probes) == 1:
            return probes[0][1].list_object_versions(
                bucket, prefix, key_marker, version_marker, delimiter, max_keys
            )
        # As in the JAX package: is_truncated is set only when the union of
        # the pools' pages holds more than max_keys entries, so a pool whose
        # own page was full and truncated can end the listing early.
        out = ListObjectVersionsInfo()
        for _i, p in probes:
            part = p.list_object_versions(
                bucket, prefix, key_marker, version_marker, delimiter, max_keys
            )
            out.objects.extend(part.objects)
            out.prefixes = sorted(set(out.prefixes) | set(part.prefixes))
        out.objects.sort(key=lambda o: (o.name, -o.mod_time))
        if len(out.objects) > max_keys:
            out.objects = out.objects[:max_keys]
            out.is_truncated = True
            out.next_key_marker = out.objects[-1].name
            out.next_version_marker = out.objects[-1].version_id
        return out

    # -- multipart --------------------------------------------------------------

    def new_multipart_upload(self, bucket, object_name, opts: PutObjectOptions | None = None) -> str:
        _validate_object_name(bucket, object_name)
        pool = None
        try:
            idx = self._pool_holding_index(bucket, object_name)
            if self.statuses[idx] == POOL_ACTIVE:
                pool = self.pools[idx]
        except errors.ObjectError:
            pass
        if pool is None:
            pool = self._pool_with_space()
        return pool.new_multipart_upload(bucket, object_name, opts)

    def _pool_with_upload(self, bucket: str, object_name: str, upload_id: str):
        last: Exception | None = None
        for _i, p in self._probe_pools():
            try:
                p.list_parts(bucket, object_name, upload_id, 0, 1)
                return p
            except errors.ObjectError as e:
                last = e
        raise last or errors.InvalidUploadID(bucket, object_name, upload_id)

    def put_object_part(self, bucket, object_name, upload_id, part_number, data):
        return self._pool_with_upload(bucket, object_name, upload_id).put_object_part(
            bucket, object_name, upload_id, part_number, data
        )

    def list_parts(self, bucket, object_name, upload_id, part_marker=0, max_parts=1000):
        return self._pool_with_upload(bucket, object_name, upload_id).list_parts(
            bucket, object_name, upload_id, part_marker, max_parts
        )

    def complete_multipart_upload(self, bucket, object_name, upload_id, parts):
        return self._pool_with_upload(bucket, object_name, upload_id).complete_multipart_upload(
            bucket, object_name, upload_id, parts
        )

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        return self._pool_with_upload(bucket, object_name, upload_id).abort_multipart_upload(
            bucket, object_name, upload_id
        )

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for _i, p in self._probe_pools():
            out.extend(p.list_multipart_uploads(bucket, prefix))
        return sorted(out, key=lambda u: (u["object"], u["initiated"]))

    # -- healing ---------------------------------------------------------------

    def heal_object(
        self, bucket: str, object_name: str, version_id: str = "", dry_run: bool = False
    ) -> HealResultItem:
        last: Exception | None = None
        for _i, p in self._probe_pools():
            try:
                return p.heal_object(bucket, object_name, version_id, dry_run)
            except (errors.ObjectError, errors.DiskError) as e:
                last = e
        raise last or errors.ObjectNotFound(bucket, object_name)

    def heal_bucket(self, bucket: str) -> None:
        """Recreate the bucket volume on drives that miss it."""
        for p in self.pools:
            for s in p.sets:
                for d in s.disks:
                    if d is None:
                        continue
                    try:
                        d.stat_vol(bucket)
                    except errors.VolumeNotFound:
                        try:
                            d.make_vol(bucket)
                        except errors.DiskError:
                            pass
                    except errors.DiskError:
                        pass


def _validate_bucket_name(bucket: str) -> None:
    """S3 bucket naming rules (subset the reference enforces)."""
    if not (3 <= len(bucket) <= 63):
        raise errors.BucketNameInvalid(bucket)
    if bucket.startswith(".") or bucket.endswith(".") or bucket.startswith("-"):
        raise errors.BucketNameInvalid(bucket)
    ok = set("abcdefghijklmnopqrstuvwxyz0123456789.-")
    if not all(c in ok for c in bucket):
        raise errors.BucketNameInvalid(bucket)


def _validate_object_name(bucket: str, object_name: str) -> None:
    if not object_name or len(object_name) > 1024:
        raise errors.ObjectNameInvalid(bucket, object_name)
    if object_name.startswith("/") or "\\" in object_name:
        raise errors.ObjectNameInvalid(bucket, object_name)
    if any(part in (".", "..") for part in object_name.split("/")):
        raise errors.ObjectNameInvalid(bucket, object_name)
