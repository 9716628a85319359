"""Remote tiers + ILM transition + restore (the reference's cmd/tier.go
TierConfigMgr :57, cmd/bucket-lifecycle.go transition/restore logic, and
cmd/tier-journal.go deferred remote deletes).

Flow: the data scanner evaluates lifecycle Transition rules; matching
versions are uploaded to the configured remote tier under an opaque name,
then the object layer frees the local shard files and stamps the xl.meta
version with transition markers (erasure.transition_object). Reads stream
back through the tier client; RestoreObject materializes a temporary local
copy with an expiry. Deleting a transitioned version journals the remote
object for async reclamation.

A copy of the JAX package's control/tiering.py: the tier config
(`tier/config.json`, credentials sealed by control/kms.py through
control/crypto.py) and the journal (`tier/journal.json`) are the same
documents. The transition's read verifies every shard and the restore's
write encodes through the layer's codec: on the card, the CUDA kernels.
Tier traffic itself is host I/O.
"""

from __future__ import annotations

import calendar
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass

from ..object.types import GetObjectOptions, PutObjectOptions
from ..utils import errors
from .sanitizer import san_lock, san_rlock

# Internal xl.meta markers (reference: TransitionStatus/TransitionedObjName/
# TransitionTier fields of xlMetaV2Object, xl-storage-format-v2.go:163).
META_TRANSITION_STATUS = "x-internal-transition-status"
META_TRANSITION_TIER = "x-internal-transition-tier"
META_TRANSITION_NAME = "x-internal-transitioned-name"
STATUS_COMPLETE = "complete"

# User-facing restore status (S3 x-amz-restore semantics).
META_RESTORE = "x-amz-restore"

CONFIG_PATH = "tier/config.json"
JOURNAL_PATH = "tier/journal.json"


def is_transitioned(internal_meta: dict[str, str]) -> bool:
    return internal_meta.get(META_TRANSITION_STATUS) == STATUS_COMPLETE


def restore_expiry(user_meta: dict[str, str]) -> float:
    """Parse expiry out of an x-amz-restore value; 0 if absent/ongoing."""
    raw = user_meta.get(META_RESTORE, "")
    if 'ongoing-request="false"' not in raw:
        return 0.0
    marker = 'expiry-date="'
    i = raw.find(marker)
    if i < 0:
        return 0.0
    ts = raw[i + len(marker):].split('"')[0]
    try:
        # The stamp is GMT; parse as UTC (mktime would apply the host's
        # local offset and skew the expiry).
        return calendar.timegm(time.strptime(ts, "%a, %d %b %Y %H:%M:%S GMT"))
    except ValueError:
        return 0.0


@dataclass
class TierConfig:
    """One remote tier (madmin.TierConfig analogue). type "s3"/"minio" speaks
    SigV4 S3 to a remote endpoint; type "fs" is a local-directory tier
    (cold-storage directory / NFS mount)."""

    name: str
    type: str = "s3"  # "s3" | "minio" | "fs"
    endpoint: str = ""
    bucket: str = ""
    prefix: str = ""
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"
    dir: str = ""  # for type "fs"

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "TierConfig":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class FSTierBackend:
    """Directory-backed tier for cold storage on a mounted filesystem."""

    def __init__(self, cfg: TierConfig):
        self.root = cfg.dir
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, key))
        # commonpath, not startswith: "/mnt/cold2" startswith "/mnt/cold"
        # but is outside the root.
        if os.path.commonpath([root, p]) != root:
            raise errors.StorageError("tier key escapes root")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise errors.ObjectNotFound("tier", key)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def online(self) -> bool:
        return os.path.isdir(self.root)


class S3TierBackend:
    """Remote S3/minio-cluster tier via the SigV4 target client."""

    def __init__(self, cfg: TierConfig):
        from .replication import BucketTarget, TargetClient

        self.cfg = cfg
        self.client = TargetClient(
            BucketTarget(
                arn=f"tier:{cfg.name}",
                source_bucket="",
                endpoint=cfg.endpoint,
                target_bucket=cfg.bucket,
                access_key=cfg.access_key,
                secret_key=cfg.secret_key,
                region=cfg.region,
            )
        )

    def put(self, key: str, data: bytes) -> None:
        r = self.client.put_object(key, data, {"content-type": "application/octet-stream"})
        if r.status_code != 200:
            raise errors.StorageError(f"tier put failed: {r.status_code}")

    def get(self, key: str) -> bytes:
        r = self.client._request("GET", f"/{self.cfg.bucket}/{key}")
        if r.status_code == 404:
            raise errors.ObjectNotFound(self.cfg.bucket, key)
        if r.status_code != 200:
            raise errors.StorageError(f"tier get failed: {r.status_code}")
        return r.content

    def delete(self, key: str) -> None:
        self.client.delete_object(key)

    def online(self) -> bool:
        return self.client.online()


class TierConfigMgr:
    """Named remote tiers, persisted through the config store with sealed
    credentials, plus the transition/restore/journal machinery."""

    def __init__(self, store, kms=None):
        self.store = store
        self.kms = kms
        self._tiers: dict[str, TierConfig] = {}
        self._backends: dict[str, object] = {}
        self._journal: list[dict] = []  # [{"tier":..., "key":...}]
        self._lock = san_rlock("TierConfigMgr._lock")
        self.transitioned_objects = 0
        self.transitioned_bytes = 0
        self.load()

    # -- persistence ----------------------------------------------------------

    def load(self) -> None:
        from .crypto import unseal_secret

        try:
            raw = self.store.get(CONFIG_PATH) if self.store is not None else None
        except errors.StorageError:
            # Degraded-quorum boot: start with no tiers rather than failing
            # the whole node; tier saves are admin-driven, so the empty-
            # overwrite risk IAM guards against doesn't arise unprompted.
            return
        if raw:
            docs = json.loads(raw)
            with self._lock:
                self._tiers = {}
                for d in docs:
                    t = TierConfig.from_dict(d)
                    t.secret_key = unseal_secret(self.kms, f"tier/{t.name}", t.secret_key)
                    self._tiers[t.name] = t
        try:
            rawj = self.store.get(JOURNAL_PATH) if self.store is not None else None
        except errors.StorageError:
            return
        if rawj:
            with self._lock:
                self._journal = json.loads(rawj)

    def _save(self) -> None:
        from .crypto import seal_secret

        if self.store is None:
            return
        with self._lock:
            docs = []
            for t in self._tiers.values():
                d = t.to_dict()
                d["secret_key"] = seal_secret(self.kms, f"tier/{t.name}", d["secret_key"])
                docs.append(d)
        self.store.put(CONFIG_PATH, json.dumps(docs).encode())

    def _save_journal(self) -> None:
        if self.store is None:
            return
        with self._lock:
            raw = json.dumps(self._journal).encode()
        self.store.put(JOURNAL_PATH, raw)

    # -- tier CRUD (mc admin tier add/ls/rm) ----------------------------------

    def add(self, cfg: TierConfig) -> None:
        with self._lock:
            if cfg.name in self._tiers:
                raise errors.InvalidArgument("tier", cfg.name, "tier already exists")
            self._tiers[cfg.name] = cfg
        self._save()

    def edit_creds(self, name: str, access_key: str, secret_key: str) -> None:
        with self._lock:
            t = self._tiers.get(name)
            if t is None:
                raise errors.InvalidArgument("tier", name, "no such tier")
            t.access_key, t.secret_key = access_key, secret_key
            self._backends.pop(name, None)
        self._save()

    def remove(self, name: str) -> None:
        with self._lock:
            self._tiers.pop(name, None)
            self._backends.pop(name, None)
        self._save()

    def list(self) -> list[TierConfig]:
        with self._lock:
            return list(self._tiers.values())

    def backend(self, name: str):
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                return b
            cfg = self._tiers.get(name)
            if cfg is None:
                raise errors.InvalidArgument("tier", name, "no such tier")
            b = FSTierBackend(cfg) if cfg.type == "fs" else S3TierBackend(cfg)
            self._backends[name] = b
            return b

    # -- transition (scanner-driven) ------------------------------------------

    def transition(self, layer, bucket: str, object_name: str, version_id: str, tier: str):
        """Upload a version's stored bytes to the tier, then free local data.
        Bytes go as stored (post SSE/compression) so reads round-trip."""
        cfg_prefix = ""
        with self._lock:
            cfg = self._tiers.get(tier)
            if cfg is None:
                raise errors.InvalidArgument("tier", tier, "no such tier")
            cfg_prefix = cfg.prefix
        oi, data = layer.get_object(bucket, object_name, GetObjectOptions(version_id))
        if is_transitioned(oi.internal):
            return oi
        if oi.inline or oi.size == 0:
            # Inline/empty versions have no part files to reclaim; uploading
            # them would only orphan remote objects on every scan cycle.
            raise errors.InvalidArgument(bucket, object_name, "inline object not transitionable")
        remote_name = f"{cfg_prefix}{uuid.uuid4()}"
        self.backend(tier).put(remote_name, data)
        try:
            out = layer.transition_object(
                bucket,
                object_name,
                oi.version_id,
                tier,
                remote_name,
                expected_etag=oi.etag,
                expected_mtime=oi.mod_time,
            )
        except errors.StorageError:
            # Version changed (or quorum lost) after the upload: the fresh
            # remote object is an orphan — journal it for reclamation.
            self.journal_delete(
                {META_TRANSITION_TIER: tier, META_TRANSITION_NAME: remote_name}
            )
            raise
        with self._lock:
            self.transitioned_objects += 1
            self.transitioned_bytes += len(data)
        return out

    # -- reads / restore -------------------------------------------------------

    def _restore_copy_path(self, bucket: str, key: str, version_id: str) -> str:
        return f"restored/{bucket}/{key}@{version_id or 'null'}"

    def read_object(self, layer, bucket: str, key: str, oi) -> bytes:
        """Stored bytes of a transitioned version: local restored copy if
        present and unexpired, else stream from the tier."""
        from ..object.erasure import META_BUCKET

        if restore_expiry(oi.user_defined) > time.time():
            try:
                _, data = layer.pools[0].get_object(
                    META_BUCKET,
                    self._restore_copy_path(bucket, key, oi.version_id),
                    GetObjectOptions(),
                )
                return data
            except errors.ObjectError:
                pass  # restored copy missing -> fall through to the tier
        tier = oi.internal.get(META_TRANSITION_TIER, "")
        remote = oi.internal.get(META_TRANSITION_NAME, "")
        return self.backend(tier).get(remote)

    def restore(self, layer, bucket: str, key: str, version_id: str, days: int) -> None:
        """RestoreObject: fetch from the tier into a local temporary copy and
        stamp x-amz-restore with the expiry (PostRestoreObjectHandler role)."""
        from ..object.erasure import META_BUCKET

        oi = layer.get_object_info(bucket, key, GetObjectOptions(version_id))
        if not is_transitioned(oi.internal):
            raise errors.InvalidArgument(bucket, key, "object is not archived")
        tier = oi.internal.get(META_TRANSITION_TIER, "")
        remote = oi.internal.get(META_TRANSITION_NAME, "")
        data = self.backend(tier).get(remote)
        layer.pools[0].put_object(
            META_BUCKET,
            self._restore_copy_path(bucket, key, oi.version_id),
            data,
            PutObjectOptions(),
        )
        expiry = time.time() + days * 86400
        stamp = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(expiry))
        layer.put_object_metadata(
            bucket,
            key,
            oi.version_id,
            updates={META_RESTORE: f'ongoing-request="false", expiry-date="{stamp}"'},
        )

    def expire_restored_copies(self, layer) -> int:
        """Scanner hook: drop restored copies whose expiry passed (the
        reference's restored-object expiry in the scanner)."""
        from ..object.erasure import META_BUCKET

        n = 0
        try:
            listing = layer.pools[0].list_objects(META_BUCKET, prefix="restored/", max_keys=1000)
        except errors.StorageError:
            return 0
        for o in listing.objects:
            # restored/<bucket>/<key>@<vid>
            try:
                rest = o.name[len("restored/"):]
                src_bucket, tail = rest.split("/", 1)
                src_key, vid = tail.rsplit("@", 1)
                src = layer.get_object_info(
                    src_bucket, src_key, GetObjectOptions("" if vid == "null" else vid)
                )
                if restore_expiry(src.user_defined) > time.time():
                    continue
            except errors.StorageError:
                pass  # source gone -> copy is garbage either way
            try:
                layer.pools[0].delete_object(META_BUCKET, o.name)
                n += 1
            except errors.StorageError:
                pass
        return n

    # -- deferred remote deletes (tier-journal.go) ----------------------------

    def journal_delete(self, internal_meta: dict[str, str]) -> None:
        tier = internal_meta.get(META_TRANSITION_TIER, "")
        remote = internal_meta.get(META_TRANSITION_NAME, "")
        if not tier or not remote:
            return
        with self._lock:
            self._journal.append({"tier": tier, "key": remote})
        try:
            self._save_journal()
        except errors.StorageError:
            pass

    def journal_backlog(self) -> int:
        with self._lock:
            return len(self._journal)

    def drain_journal(self) -> int:
        """Delete journaled remote objects; keep entries whose tier is
        unreachable for the next pass."""
        with self._lock:
            batch, self._journal = self._journal, []
        kept, n = [], 0
        for e in batch:
            try:
                self.backend(e["tier"]).delete(e["key"])
                n += 1
            except errors.StorageError:
                kept.append(e)
            except Exception:
                kept.append(e)
        if kept:
            with self._lock:
                self._journal.extend(kept)
        try:
            self._save_journal()
        except errors.StorageError:
            pass
        return n
