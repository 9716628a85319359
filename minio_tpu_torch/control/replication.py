"""Bucket replication markers (the JAX package's control/replication.py).

Only the constants the S3 front reads are here: the status values and
internal metadata keys HEAD reports, and the X-Minio-Source-* headers a
source cluster sends with replica writes and deletes. With
`S3Server.replication` left None the front marks nothing pending and
replicates nothing, as the JAX front does without a ReplicationSys. The
target registry, the replication pool and resync come with the control
plane (ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

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
