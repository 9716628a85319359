"""Multipart uploads on the erasure set.

Role of the reference's erasure-multipart.go: parts are erasure-coded and
staged under the system meta bucket
(.minio_tpu.sys/multipart/<bucket>/<object>/<uploadId>/), then atomically
assembled into the object on CompleteMultipartUpload by renaming the staged
shard files into the object's data dir and publishing a multi-part FileInfo
(parts carry per-part sizes so reads/heals can reframe each part's bitrot
stream).

Uses the same distribution as the final object (hash_order of bucket/object),
so each drive keeps the same shard row across parts and completion is pure
renames -- no re-coding.

Part uploads go through the erasure layer's ShardStageWriter, so a part
encodes through the set's codec -- on the batching codec, the GPU kernels.
This copy leaves out the JAX package's instrumentation hooks; the bytes
written and the behaviour are the same.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid

from ..storage.types import ErasureInfo, FileInfo, ObjectPartInfo, now
from ..utils import deadline, errors
from ..utils.hashes import hash_order
from . import metadata as meta_mod
from .erasure import BLOCK_SIZE, META_BUCKET, ErasureObjects
from .types import ObjectInfo, PutObjectOptions

MIN_PART_SIZE = 5 * (1 << 20)  # S3 minimum (except last part)
MAX_PARTS = 10_000


def _upload_dir(bucket: str, object_name: str, upload_id: str) -> str:
    return f"multipart/{bucket}/{object_name}/{upload_id}"


class MultipartManager:
    def __init__(self, eo: ErasureObjects):
        self.eo = eo

    # -- initiate ------------------------------------------------------------

    def new_multipart_upload(
        self, bucket: str, object_name: str, opts: PutObjectOptions | None = None
    ) -> str:
        opts = opts or PutObjectOptions()
        self.eo.get_bucket_info(bucket)  # cached existence gate
        upload_id = str(uuid.uuid4())
        doc = json.dumps(
            {
                "bucket": bucket,
                "object": object_name,
                "created": now(),
                "content_type": opts.content_type,
                "user_defined": opts.user_defined,
                "versioned": opts.versioned,
                "storage_class": opts.storage_class,
            }
        ).encode()
        path = _upload_dir(bucket, object_name, upload_id) + "/upload.json"

        def write(d):
            if d is None:
                raise errors.DiskNotFound()
            d.write_all(META_BUCKET, path, doc)

        results = meta_mod.parallel_map(write, self.eo._online())
        n_ok = sum(1 for _, e in results if e is None)
        if n_ok < self.eo.drive_count // 2 + 1:
            raise errors.ErasureWriteQuorum(bucket, object_name, "initiate multipart")
        return upload_id

    def _geometry(self, meta_doc: dict) -> tuple[int, int]:
        """(k, m) for this upload, honoring its stored storage class (the
        single-PUT path applies the same RRS parity, erasure.py)."""
        n = self.eo.drive_count
        m = self.eo.parity
        if (meta_doc.get("storage_class") or "").upper() == "REDUCED_REDUNDANCY" and m > 0:
            m = max(self.eo.rrs_parity, 1)
        return n - m, m

    def _upload_meta(self, bucket: str, object_name: str, upload_id: str) -> dict:
        path = _upload_dir(bucket, object_name, upload_id) + "/upload.json"
        for d in self.eo._online():
            if d is None:
                continue
            try:
                return json.loads(d.read_all(META_BUCKET, path))
            except errors.DiskError:
                continue
        raise errors.InvalidUploadID(bucket, object_name, upload_id)

    # -- parts ---------------------------------------------------------------

    def put_object_part(
        self, bucket: str, object_name: str, upload_id: str, part_number: int, data
    ) -> ObjectPartInfo:
        """Streaming part upload: `data` is bytes or a .read(n) stream.

        Blocks are grouped for the device codec and shard frames appended to
        per-drive staged part files as they are produced (bounded memory;
        erasure-multipart.go PutObjectPart streams through erasure.Encode the
        same way). The part stages under a tmp name and is published with a
        rename, so a re-upload of the same part number never leaves a
        half-written file behind."""
        from .erasure import (
            ShardStageWriter,
            _PipelinedMD5,
            _etag_update,
            _uniform_runs,
            data_windows,
            make_etag_md5,
        )

        if not (1 <= part_number <= MAX_PARTS):
            raise errors.InvalidArgument(bucket, object_name, "bad part number")
        meta_doc = self._upload_meta(bucket, object_name, upload_id)

        n = self.eo.drive_count
        k, m = self._geometry(meta_doc)
        distribution = hash_order(f"{bucket}/{object_name}", n)
        windows = data_windows(data)
        udir = _upload_dir(bucket, object_name, upload_id)
        # pid-scoped stage name, as in the JAX package: a recovery scan can
        # GC `.tmp.<pid>.` stage files once their owner pid is dead.
        stage = f"part.{part_number}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        disks = self.eo._online()
        writer = ShardStageWriter(
            self.eo.codec, disks, distribution, k, m, lambda i: f"{udir}/{stage}"
        )
        ok = writer.ok
        write_quorum = k + 1 if k == m else k
        size = 0

        def cleanup() -> None:
            def rm(i):
                if disks[i] is None:
                    return
                try:
                    disks[i].delete(META_BUCKET, f"{udir}/{stage}")
                except errors.StorageError:
                    pass

            meta_mod.parallel_map(rm, list(range(n)))

        md5h = make_etag_md5()  # pipelined on multi-core (part etag stays md5)
        try:
            try:
                for win in windows:
                    # Deadline expiry aborts into cleanup() below -- stage
                    # files are deleted, nothing leaks into the upload dir.
                    deadline.check("upload part")
                    blocks = win.blocks()
                    size += len(win)
                    for b in blocks:
                        _etag_update(md5h, b)
                    for run in _uniform_runs(blocks):
                        writer.append_group(run)
                    win.release()
                    if writer.alive() < write_quorum:
                        raise errors.ErasureWriteQuorum(
                            bucket, object_name, "upload part quorum lost mid-stream"
                        )
                writer.drain()
                writer.finalize()  # zero-byte parts still commit a shard file
                if writer.alive() < write_quorum:
                    raise errors.ErasureWriteQuorum(bucket, object_name, "upload part quorum")
            except BaseException:
                writer.abort()  # writes settle before cleanup deletes stage files
                if isinstance(md5h, _PipelinedMD5):
                    md5h.shutdown()
                cleanup()
                raise
        finally:
            closer = getattr(windows, "close", None)
            if closer is not None:
                closer()

        etag = md5h.hexdigest()
        mod_time = now()
        part_doc = json.dumps(
            {"number": part_number, "size": size, "etag": etag, "mod_time": mod_time}
        ).encode()

        def publish(i):
            if not ok[i]:
                raise errors.DiskNotFound()
            disks[i].rename_file(
                META_BUCKET, f"{udir}/{stage}", META_BUCKET, f"{udir}/part.{part_number}"
            )
            disks[i].write_all(META_BUCKET, f"{udir}/part.{part_number}.meta", part_doc)

        # The rename-publish is the part's commit point.
        results = meta_mod.parallel_map(publish, list(range(n)))
        n_ok = sum(1 for _, e in results if e is None)
        if n_ok < write_quorum:
            cleanup()
            raise errors.ErasureWriteQuorum(bucket, object_name, "upload part quorum")
        return ObjectPartInfo(part_number, size, size, mod_time, etag)

    def list_parts(
        self, bucket: str, object_name: str, upload_id: str, part_marker: int = 0, max_parts: int = 1000
    ) -> list[ObjectPartInfo]:
        self._upload_meta(bucket, object_name, upload_id)
        udir = _upload_dir(bucket, object_name, upload_id)
        out: dict[int, ObjectPartInfo] = {}
        for d in self.eo._online():
            if d is None:
                continue
            try:
                names = d.list_dir(META_BUCKET, udir)
            except errors.DiskError:
                continue
            for nme in names:
                if nme.endswith(".meta"):
                    try:
                        doc = json.loads(d.read_all(META_BUCKET, f"{udir}/{nme}"))
                        num = doc["number"]
                        if num not in out:
                            out[num] = ObjectPartInfo(
                                num, doc["size"], doc["size"], doc.get("mod_time", 0.0), doc["etag"]
                            )
                    except (errors.DiskError, ValueError, KeyError):
                        continue
            break  # one good drive is enough for listing
        parts = [out[nk] for nk in sorted(out) if nk > part_marker]
        return parts[:max_parts]

    # -- complete / abort ----------------------------------------------------

    def complete_multipart_upload(
        self, bucket: str, object_name: str, upload_id: str, parts: list[tuple[int, str]]
    ) -> ObjectInfo:
        meta_doc = self._upload_meta(bucket, object_name, upload_id)
        if not parts:
            raise errors.InvalidArgument(bucket, object_name, "no parts")
        uploaded = {p.number: p for p in self.list_parts(bucket, object_name, upload_id, 0, MAX_PARTS)}
        part_infos: list[ObjectPartInfo] = []
        prev = 0
        for idx, (num, etag) in enumerate(parts):
            if num <= prev:
                raise errors.InvalidArgument(bucket, object_name, "part order")
            prev = num
            got = uploaded.get(num)
            if got is None or got.etag != etag.strip('"'):
                raise errors.InvalidPart(bucket, object_name, f"part {num}")
            if idx < len(parts) - 1 and got.size < MIN_PART_SIZE:
                raise errors.InvalidArgument(
                    bucket, object_name, f"part {num} below minimum size"
                )
            part_infos.append(got)

        n = self.eo.drive_count
        k, m = self._geometry(meta_doc)
        distribution = hash_order(f"{bucket}/{object_name}", n)
        total_size = sum(p.size for p in part_infos)
        # S3 multipart etag: md5 of the concatenated binary part md5s + "-N".
        md5s = b"".join(bytes.fromhex(p.etag) for p in part_infos)
        etag = hashlib.md5(md5s).hexdigest() + f"-{len(part_infos)}"
        version_id = str(uuid.uuid4()) if meta_doc.get("versioned") else ""
        data_dir = str(uuid.uuid4())
        mod_time = now()
        udir = _upload_dir(bucket, object_name, upload_id)
        # pid-scoped commit staging, same GC contract as the PUT path.
        commit_id = f"{os.getpid()}.{uuid.uuid4()}"

        base_meta = {
            "etag": etag,
            "content-type": meta_doc.get("content_type", "application/octet-stream"),
            **meta_doc.get("user_defined", {}),
            **(
                {"x-internal-storage-class": "REDUCED_REDUNDANCY"}
                if (meta_doc.get("storage_class") or "").upper() == "REDUCED_REDUNDANCY"
                and self.eo.parity > 0
                else {}
            ),
        }

        def commit(args):
            i, disk = args
            if disk is None:
                raise errors.DiskNotFound()
            row = distribution[i] - 1
            tmp = f"tmp/{commit_id}/{i}"
            # Renumber parts consecutively (S3 semantics: completed part list
            # order defines part numbers 1..N for reads).
            for new_num, p in enumerate(part_infos, start=1):
                disk.rename_file(
                    META_BUCKET, f"{udir}/part.{p.number}", META_BUCKET, f"{tmp}/part.{new_num}"
                )
            fi = FileInfo(
                volume=bucket,
                name=object_name,
                version_id=version_id,
                data_dir=data_dir,
                mod_time=mod_time,
                size=total_size,
                metadata=dict(base_meta),
                parts=[
                    ObjectPartInfo(new_num, p.size, p.size, mod_time, p.etag)
                    for new_num, p in enumerate(part_infos, start=1)
                ],
                erasure=ErasureInfo(
                    data_blocks=k,
                    parity_blocks=m,
                    block_size=BLOCK_SIZE,
                    index=row + 1,
                    distribution=list(distribution),
                ),
            )
            disk.rename_data(META_BUCKET, tmp, fi, bucket, object_name)

        results = meta_mod.parallel_map(commit, list(enumerate(self.eo._online())))
        n_ok = sum(1 for _, e in results if e is None)
        write_quorum = k + 1 if k == m else k
        if n_ok < write_quorum:
            raise errors.ErasureWriteQuorum(bucket, object_name, "complete quorum")
        self.abort_multipart_upload(bucket, object_name, upload_id, missing_ok=True)
        oi = ObjectInfo(
            bucket=bucket,
            name=object_name,
            mod_time=mod_time,
            size=total_size,
            etag=etag,
            version_id=version_id,
            content_type=base_meta["content-type"],
            storage_class=(
                "REDUCED_REDUNDANCY"
                if base_meta.get("x-internal-storage-class") == "REDUCED_REDUNDANCY"
                else "STANDARD"
            ),
        )
        return oi

    def abort_multipart_upload(
        self, bucket: str, object_name: str, upload_id: str, missing_ok: bool = False
    ) -> None:
        if not missing_ok:
            self._upload_meta(bucket, object_name, upload_id)
        udir = _upload_dir(bucket, object_name, upload_id)

        def rm(d):
            if d is None:
                return
            try:
                d.delete(META_BUCKET, udir, recursive=True)
            except errors.DiskError:
                pass

        meta_mod.parallel_map(rm, self.eo._online())

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list[dict]:
        self.eo.get_bucket_info(bucket)
        out = []
        seen = set()
        for d in self.eo._online():
            if d is None:
                continue
            base = f"multipart/{bucket}"
            try:
                objects = self._walk_uploads(d, base)
            except errors.DiskError:
                continue
            for object_name, upload_id, doc in objects:
                if (object_name, upload_id) in seen or not object_name.startswith(prefix):
                    continue
                seen.add((object_name, upload_id))
                out.append(
                    {
                        "object": object_name,
                        "upload_id": upload_id,
                        "initiated": doc.get("created", 0.0),
                    }
                )
            break
        return sorted(out, key=lambda u: (u["object"], u["initiated"]))

    def _walk_uploads(self, disk, base: str):
        """Find (object, upload_id, meta) under multipart/<bucket>/."""
        results = []

        def recurse(path: str):
            try:
                names = disk.list_dir(META_BUCKET, path)
            except errors.DiskError:
                return
            for nme in names:
                if not nme.endswith("/"):
                    continue
                child = f"{path}/{nme[:-1]}"
                try:
                    disk.read_all(META_BUCKET, f"{child}/upload.json")
                    doc = json.loads(disk.read_all(META_BUCKET, f"{child}/upload.json"))
                    object_name = path[len(base) + 1 :]
                    results.append((object_name, nme[:-1], doc))
                except errors.DiskError:
                    recurse(child)

        recurse(base)
        return results
