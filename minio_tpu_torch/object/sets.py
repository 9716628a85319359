"""Erasure sets: many independent K+M sets behind one namespace.

Role of the reference's erasureSets (cmd/erasure-sets.go): drives are grouped
into sets of a fixed size; each object lives entirely in one set, chosen by
SipHash of the object name keyed by the deployment id
(cmd/erasure-sets.go:747-784). Bucket operations span all sets; listing
merges per-set sorted walk streams. Every set shares one codec (the
process-wide default_codec() unless the caller passes one), so the device
batches blocks across sets.
"""

from __future__ import annotations

import uuid as uuid_mod

from ..storage.format import DriveFormat
from ..storage.interface import StorageAPI
from ..storage.xlmeta import XLMeta
from ..utils import errors
from ..utils.hashes import crc_hash_mod, sip_hash_mod
from . import codec as codec_mod
from . import metacache as metacache_mod
from . import metadata as meta_mod
from .erasure import ErasureObjects
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


class ErasureSets:
    """All sets of one pool."""

    def __init__(
        self,
        disks: list[StorageAPI | None],
        set_drive_count: int,
        deployment_id: str = "",
        distribution_algo: str = "SIPMOD+PARITY",
        parity: int | None = None,
        codec: codec_mod.BlockCodec | None = None,
        pool_index: int = 0,
        rrs_parity: int | None = None,
    ):
        if len(disks) % set_drive_count:
            raise ValueError("drive count must be a multiple of set size")
        self.set_drive_count = set_drive_count
        self.deployment_id = deployment_id or str(uuid_mod.uuid4())
        self.distribution_algo = distribution_algo
        self.disks = disks
        self.sets: list[ErasureObjects] = []
        for s in range(len(disks) // set_drive_count):
            sub = disks[s * set_drive_count : (s + 1) * set_drive_count]
            self.sets.append(
                ErasureObjects(
                    sub, parity=parity, codec=codec, set_index=s,
                    pool_index=pool_index, rrs_parity=rrs_parity,
                )
            )
        self.metacache = metacache_mod.MetacacheManager(
            self._walk_merged, persist=self._persist_cache, load=self._load_cache
        )

    @classmethod
    def from_drives(
        cls,
        drives: list[StorageAPI],
        fmt: DriveFormat,
        parity: int | None = None,
        codec: codec_mod.BlockCodec | None = None,
        pool_index: int = 0,
        rrs_parity: int | None = None,
    ) -> "ErasureSets":
        """Arrange drives according to a quorum format (newErasureSets,
        cmd/erasure-sets.go:353): position = where the drive's id appears."""
        n_sets = len(fmt.sets)
        count = len(fmt.sets[0])
        arranged: list[StorageAPI | None] = [None] * (n_sets * count)
        for d in drives:
            try:
                s, i = fmt.find_disk(d.disk_id())
            except errors.DiskIDMismatch:
                continue
            arranged[s * count + i] = d
        obj = cls(
            arranged,
            count,
            deployment_id=fmt.deployment_id,
            distribution_algo=fmt.distribution_algo,
            parity=parity,
            codec=codec,
            pool_index=pool_index,
            rrs_parity=rrs_parity,
        )
        return obj

    # -- routing -------------------------------------------------------------

    def _dep_id_bytes(self) -> bytes:
        try:
            return uuid_mod.UUID(self.deployment_id).bytes
        except ValueError:
            return (self.deployment_id.encode() + b"\0" * 16)[:16]

    def get_set_index(self, object_name: str) -> int:
        if self.distribution_algo.startswith("CRCMOD"):
            return crc_hash_mod(object_name, len(self.sets))
        return sip_hash_mod(object_name, len(self.sets), self._dep_id_bytes())

    def get_hashed_set(self, object_name: str) -> ErasureObjects:
        return self.sets[self.get_set_index(object_name)]

    # -- buckets (span all sets) ----------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        results = meta_mod.parallel_map(lambda s: s.make_bucket(bucket), self.sets)
        errs = [e for _, e in results]
        for e in errs:
            if isinstance(e, errors.BucketExists):
                raise e
        err = next((e for e in errs if e is not None), None)
        if err:
            raise err

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.sets[0].get_bucket_info(bucket)

    def invalidate_bucket_cache(self, bucket: str = "") -> None:
        for s in self.sets:
            s.invalidate_bucket_cache(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self.metacache.invalidate(bucket)
        results = meta_mod.parallel_map(lambda s: s.delete_bucket(bucket, force), self.sets)
        errs = [e for _, e in results]
        for e in errs:
            if isinstance(e, errors.BucketNotEmpty):
                raise e
        err = next((e for e in errs if e is not None), None)
        if err:
            raise err

    def list_buckets(self) -> list[BucketInfo]:
        return self.sets[0].list_buckets()

    # -- objects (route to one set) -------------------------------------------

    def put_object(self, bucket, object_name, data, opts: PutObjectOptions | None = None):
        try:
            return self.get_hashed_set(object_name).put_object(bucket, object_name, data, opts)
        finally:
            self.metacache.invalidate(bucket)

    def get_object(self, bucket, object_name, opts: GetObjectOptions | None = None, offset=0, length=-1):
        return self.get_hashed_set(object_name).get_object(bucket, object_name, opts, offset, length)

    def get_object_stream(
        self, bucket, object_name, opts: GetObjectOptions | None = None, offset=0, length=-1
    ):
        return self.get_hashed_set(object_name).get_object_stream(
            bucket, object_name, opts, offset, length
        )

    def get_object_info(self, bucket, object_name, opts: GetObjectOptions | None = None):
        return self.get_hashed_set(object_name).get_object_info(bucket, object_name, opts)

    def put_object_metadata(self, bucket, object_name, version_id="", updates=None, removes=None):
        try:
            return self.get_hashed_set(object_name).put_object_metadata(
                bucket, object_name, version_id, updates, removes
            )
        finally:
            self.metacache.invalidate(bucket)

    def transition_object(
        self, bucket, object_name, version_id, tier, remote_name,
        expected_etag="", expected_mtime=0.0,
    ):
        try:
            return self.get_hashed_set(object_name).transition_object(
                bucket, object_name, version_id, tier, remote_name,
                expected_etag, expected_mtime,
            )
        finally:
            self.metacache.invalidate(bucket)

    def delete_object(self, bucket, object_name, opts: DeleteObjectOptions | None = None):
        try:
            return self.get_hashed_set(object_name).delete_object(bucket, object_name, opts)
        finally:
            self.metacache.invalidate(bucket)

    def heal_object(self, bucket, object_name, version_id="", dry_run=False) -> HealResultItem:
        return self.get_hashed_set(object_name).heal_object(bucket, object_name, version_id, dry_run)

    # -- multipart (route to one set) ------------------------------------------

    def new_multipart_upload(self, bucket, object_name, opts: PutObjectOptions | None = None) -> str:
        return self.get_hashed_set(object_name).multipart.new_multipart_upload(bucket, object_name, opts)

    def put_object_part(self, bucket, object_name, upload_id, part_number, data):
        return self.get_hashed_set(object_name).multipart.put_object_part(
            bucket, object_name, upload_id, part_number, data
        )

    def list_parts(self, bucket, object_name, upload_id, part_marker=0, max_parts=1000):
        return self.get_hashed_set(object_name).multipart.list_parts(
            bucket, object_name, upload_id, part_marker, max_parts
        )

    def complete_multipart_upload(self, bucket, object_name, upload_id, parts):
        try:
            return self.get_hashed_set(object_name).multipart.complete_multipart_upload(
                bucket, object_name, upload_id, parts
            )
        finally:
            self.metacache.invalidate(bucket)

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        return self.get_hashed_set(object_name).multipart.abort_multipart_upload(
            bucket, object_name, upload_id
        )

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for s in self.sets:
            out.extend(s.multipart.list_multipart_uploads(bucket, prefix))
        return sorted(out, key=lambda u: (u["object"], u["initiated"]))

    # -- listing (metacache over merged sorted per-drive walks) ---------------

    def _persist_cache(self, path: str, blob: bytes) -> None:
        """Write a metacache image to the first online drives (best effort,
        the putMetacacheObject role, cmd/metacache-set.go write-back)."""
        written = 0
        for d in self.sets[0].disks:
            if d is None or not d.is_online():
                continue
            d.create_file(metacache_mod.META_BUCKET, path, blob)
            written += 1
            if written >= 2:
                return
        if written == 0:
            raise errors.DiskNotFound()

    def _load_cache(self, path: str) -> bytes:
        for d in self.sets[0].disks:
            if d is None or not d.is_online():
                continue
            try:
                return d.read_file(metacache_mod.META_BUCKET, path)
            except errors.DiskError:
                continue
        raise errors.FileNotFound(metacache_mod.META_BUCKET, path)

    def _walk_merged(self, bucket: str, prefix: str = ""):
        """Yield (name, xl_meta_bytes) sorted by name, deduped across drives
        with a majority pick on the raw metadata (listPathRaw + quorum
        resolve, cmd/metacache-set.go:783, metacache-entries.go)."""
        per_name: dict[str, dict[bytes, int]] = {}
        base = prefix if prefix.endswith("/") else ""

        def collect(s: ErasureObjects):
            found: dict[str, dict[bytes, int]] = {}
            for d in s.disks:
                if d is None or not d.is_online():
                    continue
                try:
                    for name, raw in d.walk_dir(bucket, base=base.rstrip("/")):
                        if not name.startswith(prefix):
                            continue
                        found.setdefault(name, {})
                        found[name][raw] = found[name].get(raw, 0) + 1
                except errors.VolumeNotFound:
                    raise
                except errors.DiskError:
                    continue
            return found

        results = meta_mod.parallel_map(collect, self.sets)
        vol_missing = sum(1 for _, e in results if isinstance(e, errors.VolumeNotFound))
        if vol_missing == len(self.sets):
            raise errors.BucketNotFound(bucket)
        for found, err in results:
            if found is None:
                continue
            for name, variants in found.items():
                per_name.setdefault(name, {})
                for raw, cnt in variants.items():
                    per_name[name][raw] = per_name[name].get(raw, 0) + cnt
        for name in sorted(per_name):
            variants = per_name[name]
            raw = max(variants, key=lambda r: variants[r])
            yield name, raw

    def list_objects(
        self,
        bucket: str,
        prefix: str = "",
        marker: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
    ) -> ListObjectsInfo:
        self.get_bucket_info(bucket)
        max_keys = max(0, min(max_keys, 1000))
        out = ListObjectsInfo()
        if max_keys == 0:
            # S3 answers max-keys=0 with an empty, non-truncated result; a
            # truncated one would carry an empty next_marker and strand pagers.
            return out
        prefixes: set[str] = set()
        # next_marker is the LAST RETURNED item (S3 V1 semantics): an object
        # key, or a common prefix -- in which case resumption must skip the
        # whole subtree rolled up into it.
        last_item = ""
        for name, raw in self.metacache.entries_from(bucket, prefix, marker):
            if marker and (
                name <= marker
                or (delimiter and marker.endswith(delimiter) and name.startswith(marker))
            ):
                continue
            if delimiter:
                rest = name[len(prefix) :]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in prefixes:
                        if len(out.objects) + len(prefixes) >= max_keys:
                            out.is_truncated = True
                            out.next_marker = last_item
                            break
                        prefixes.add(cp)
                        last_item = cp
                    continue
            try:
                meta = XLMeta.from_bytes(raw)
                fi = meta.file_info("")
            except errors.StorageError:
                continue
            if fi.deleted:
                continue
            if len(out.objects) + len(prefixes) >= max_keys:
                out.is_truncated = True
                out.next_marker = last_item
                break
            out.objects.append(ObjectInfo.from_file_info(fi, bucket, name))
            last_item = name
        out.prefixes = sorted(prefixes)
        return out

    def list_object_versions(
        self,
        bucket: str,
        prefix: str = "",
        key_marker: str = "",
        version_marker: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
    ) -> ListObjectVersionsInfo:
        self.get_bucket_info(bucket)
        max_keys = max(0, min(max_keys, 1000))
        out = ListObjectVersionsInfo()
        if max_keys == 0:
            return out
        prefixes: set[str] = set()
        done = False
        for name, raw in self.metacache.entries_from(bucket, prefix, ""):
            if done:
                break
            if key_marker and name < key_marker:
                continue
            if delimiter:
                rest = name[len(prefix) :]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    prefixes.add(cp)
                    continue
            try:
                meta = XLMeta.from_bytes(raw)
            except errors.StorageError:
                continue
            # Resuming inside the marker object: versions are ordered newest
            # first, so skip every version up to AND INCLUDING version_marker
            # (S3 version-id-marker semantics), not just the marker itself.
            skipping = bool(key_marker and name == key_marker)
            if (
                skipping
                and version_marker
                and not any(v.version_id == version_marker for v in meta.versions)
            ):
                # Marker version was deleted between pages: emit everything
                # rather than silently dropping the key's remaining versions
                # (duplicates are recoverable client-side; losses are not).
                skipping = False
            for fi in meta.versions:
                if skipping:
                    if not version_marker:
                        skipping = False  # key_marker alone: whole object done
                        break
                    if fi.version_id == version_marker:
                        skipping = False
                    continue
                if len(out.objects) >= max_keys:
                    out.is_truncated = True
                    out.next_key_marker = out.objects[-1].name
                    out.next_version_marker = out.objects[-1].version_id
                    done = True
                    break
                fi.is_latest = fi is meta.versions[0]
                oi = ObjectInfo.from_file_info(fi, bucket, name)
                out.objects.append(oi)
        out.prefixes = sorted(prefixes)
        return out
