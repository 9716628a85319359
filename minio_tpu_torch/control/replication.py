"""Bucket replication markers and the remote-target client (the JAX
package's control/replication.py).

Here are the constants the S3 front reads (the status values and internal
metadata keys HEAD reports, and the X-Minio-Source-* headers a source
cluster sends with replica writes and deletes), and `BucketTarget` and
`TargetClient`, copies of the JAX package's, which control/tiering.py's
`S3TierBackend` speaks through. With `S3Server.replication` left None the
front marks nothing pending and replicates nothing, as the JAX front does
without a ReplicationSys. The target registry (`BucketTargetSys`), the
replication pool and resync wait for Queue A item 8.5 (ROADMAP.md).
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass

# Replication status values (bucket-replication-utils.go replication.StatusType).
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
REPLICA = "REPLICA"

# Internal metadata keys (the reference stores these in xl.meta's internal
# metadata: ReservedMetadataPrefix + "replication-status" etc).
META_REPL_STATUS = "x-internal-replication-status"
META_REPLICA_STATUS = "x-internal-replica-status"

# Headers a source cluster sends with replica writes (the reference uses
# X-Minio-Source-* internal headers so targets preserve version identity).
HDR_SOURCE_REPL = "x-minio-source-replication-request"
HDR_SOURCE_VID = "x-minio-source-version-id"
HDR_SOURCE_MTIME = "x-minio-source-mtime"

ARN_PREFIX = "arn:minio:replication:"


@dataclass
class BucketTarget:
    """One remote replication target (madmin.BucketTarget analogue)."""

    arn: str
    source_bucket: str
    endpoint: str
    target_bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    bandwidth: int = 0  # replica bytes/s cap, 0 = unlimited (BandwidthLimit)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "BucketTarget":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class TargetClient:
    """Minimal SigV4-signing S3 client for replica traffic (the reference
    uses minio-go; this speaks the same wire subset over requests)."""

    def __init__(self, target: BucketTarget):
        import requests

        from ..api.auth import Credentials, sign_request

        self._sign = sign_request
        self.target = target
        self.creds = Credentials(target.access_key, target.secret_key)
        self.endpoint = target.endpoint.rstrip("/")
        self.host = urllib.parse.urlparse(self.endpoint).netloc
        self.session = requests.Session()

    def _request(self, method, path, query=None, body=b"", headers=None):
        query = query or []
        headers = dict(headers or {})
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers["host"] = self.host
        signed = self._sign(
            self.creds, method, path, query, headers, body, region=self.target.region
        )
        signed.pop("host", None)
        return self.session.request(method, url, data=body, headers=signed, timeout=30)

    def online(self) -> bool:
        try:
            r = self._request("HEAD", f"/{self.target.target_bucket}")
            return r.status_code in (200, 301, 307, 403)
        except Exception:
            return False

    def put_object(self, key: str, data: bytes, headers: dict[str, str]):
        return self._request(
            "PUT", f"/{self.target.target_bucket}/{key}", body=data, headers=headers
        )

    def delete_object(
        self, key: str, version_id: str = "", headers: dict[str, str] | None = None
    ):
        query = [("versionId", version_id)] if version_id else []
        return self._request(
            "DELETE",
            f"/{self.target.target_bucket}/{key}",
            query=query,
            headers=headers or {},
        )
