"""IAM policy documents and evaluation.

Role of the reference's policy engine (minio/pkg/iam/policy used from
cmd/iam.go): JSON policy documents with Effect/Action/Resource statements,
wildcard matching, evaluated per request. Covers the S3 action namespace for
the implemented API; condition keys can layer on later.
"""

from __future__ import annotations

import fnmatch
import ipaddress
import json
from dataclasses import dataclass, field

# Canned policies (the reference ships the same set).
READ_ONLY = {
    "Version": "2012-10-17",
    "Statement": [
        {
            "Effect": "Allow",
            "Action": ["s3:GetBucketLocation", "s3:GetObject", "s3:ListBucket"],
            "Resource": ["arn:aws:s3:::*"],
        }
    ],
}
WRITE_ONLY = {
    "Version": "2012-10-17",
    "Statement": [
        {"Effect": "Allow", "Action": ["s3:PutObject"], "Resource": ["arn:aws:s3:::*"]}
    ],
}
READ_WRITE = {
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::*"]}],
}
ADMIN_ALL = {
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["admin:*", "s3:*"], "Resource": ["arn:aws:s3:::*"]}],
}

CANNED = {
    "readonly": READ_ONLY,
    "writeonly": WRITE_ONLY,
    "readwrite": READ_WRITE,
    "consoleAdmin": ADMIN_ALL,
}


@dataclass
class Statement:
    effect: str  # "Allow" | "Deny"
    actions: list[str]
    resources: list[str]
    conditions: dict = field(default_factory=dict)

    def matches_action(self, action: str) -> bool:
        return any(fnmatch.fnmatchcase(action, pat) for pat in self.actions)

    def matches_resource(self, resource: str) -> bool:
        if not self.resources:
            return True
        return any(
            fnmatch.fnmatchcase(resource, pat) or fnmatch.fnmatchcase(resource + "/", pat)
            for pat in self.resources
        )

    SUPPORTED_CONDITION_OPS = (
        "StringEquals", "StringNotEquals", "StringLike", "StringNotLike",
        "IpAddress", "NotIpAddress", "Bool",
    )

    def matches_conditions(self, context: dict | None, fail_closed: bool = False) -> bool:
        """Evaluate the statement's Condition block against request context.

        Supported operators: StringEquals/NotEquals/Like/NotLike,
        IpAddress/NotIpAddress (CIDR), Bool; condition KEY names are
        case-insensitive like AWS. An unmet condition means the statement
        does not apply. An UNEVALUABLE condition (unknown operator,
        malformed CIDR, empty value list — rejected at write time by
        validate(), but stored policies may predate it) resolves to
        `fail_closed`: Deny statements pass True so a broken Deny still
        denies rather than failing open."""
        if not self.conditions:
            return True
        if not isinstance(self.conditions, dict):
            return fail_closed
        ctx = {str(k).lower(): v for k, v in (context or {}).items()}
        for op, kv in self.conditions.items():
            if not isinstance(kv, dict):
                return fail_closed
            for key, want in kv.items():
                vals = [str(v) for v in (want if isinstance(want, list) else [want])]
                if not vals:
                    return fail_closed
                have = ctx.get(str(key).lower())
                if op == "StringEquals":
                    if have is None or str(have) not in vals:
                        return False
                elif op == "StringNotEquals":
                    if have is not None and str(have) in vals:
                        return False
                elif op == "StringLike":
                    if have is None or not any(
                        fnmatch.fnmatchcase(str(have), v) for v in vals
                    ):
                        return False
                elif op == "StringNotLike":
                    if have is not None and any(
                        fnmatch.fnmatchcase(str(have), v) for v in vals
                    ):
                        return False
                elif op in ("IpAddress", "NotIpAddress"):
                    try:
                        addr = ipaddress.ip_address(str(have)) if have else None
                        nets = [ipaddress.ip_network(v, strict=False) for v in vals]
                    except ValueError:
                        return fail_closed
                    inside = addr is not None and any(addr in n for n in nets)
                    if op == "IpAddress" and not inside:
                        return False
                    if op == "NotIpAddress" and inside:
                        return False
                elif op == "Bool":
                    if have is None or str(have).lower() not in [v.lower() for v in vals]:
                        return False
                else:
                    return fail_closed  # unknown operator
        return True


@dataclass
class Policy:
    statements: list[Statement]

    @classmethod
    def from_dict(cls, doc: dict) -> "Policy":
        stmts = []
        raw = doc.get("Statement", [])
        if isinstance(raw, dict):
            raw = [raw]
        for s in raw:
            actions = s.get("Action", [])
            if isinstance(actions, str):
                actions = [actions]
            resources = s.get("Resource", [])
            if isinstance(resources, str):
                resources = [resources]
            stmts.append(
                Statement(
                    effect=s.get("Effect", "Deny"),
                    actions=list(actions),
                    resources=list(resources),
                    conditions=s.get("Condition", {}),
                )
            )
        return cls(stmts)

    @classmethod
    def from_json(cls, raw: str | bytes) -> "Policy":
        return cls.from_dict(json.loads(raw))

    def is_allowed(self, action: str, resource: str, context: dict | None = None) -> bool:
        """Deny overrides allow; default deny. Deny statements evaluate
        their conditions fail-CLOSED (an unevaluable condition still
        denies); Allow statements fail-open-to-deny."""
        allowed = False
        for s in self.statements:
            if s.matches_action(action) and s.matches_resource(resource):
                if s.effect == "Deny":
                    if s.matches_conditions(context, fail_closed=True):
                        return False
                elif s.matches_conditions(context, fail_closed=False):
                    allowed = True
        return allowed

    def validate(self) -> None:
        """Reject policies AWS would refuse at write time: unknown condition
        operators, empty value lists, malformed CIDRs."""
        for s in self.statements:
            if not isinstance(s.conditions, dict):
                raise ValueError("Condition must be an object")
            for op, kv in s.conditions.items():
                if op not in Statement.SUPPORTED_CONDITION_OPS:
                    raise ValueError(f"unsupported condition operator {op!r}")
                if not isinstance(kv, dict):
                    raise ValueError(f"condition block for {op!r} must be an object")
                for key, want in kv.items():
                    vals = [str(v) for v in (want if isinstance(want, list) else [want])]
                    if not vals:
                        raise ValueError(f"empty value list for condition key {key!r}")
                    if op in ("IpAddress", "NotIpAddress"):
                        for v in vals:
                            try:
                                ipaddress.ip_network(v, strict=False)
                            except ValueError:
                                raise ValueError(f"bad CIDR {v!r} in {op}") from None


def resource_arn(bucket: str, key: str = "") -> str:
    return f"arn:aws:s3:::{bucket}/{key}" if key else f"arn:aws:s3:::{bucket}"


# HTTP method+query -> s3 action mapping used by the API layer.
def s3_action(method: str, bucket: str, key: str, query: dict[str, str]) -> str:
    if not bucket:
        if "events" in query:
            return "s3:ListenNotification"
        return "s3:ListAllMyBuckets"
    if key:
        if method in ("GET", "HEAD"):
            if "tagging" in query:
                return "s3:GetObjectTagging"
            if "retention" in query:
                return "s3:GetObjectRetention"
            if "legal-hold" in query:
                return "s3:GetObjectLegalHold"
            if "acl" in query:
                return "s3:GetObjectAcl"
            return "s3:GetObject"
        if method == "PUT":
            if "tagging" in query:
                return "s3:PutObjectTagging"
            if "retention" in query:
                return "s3:PutObjectRetention"
            if "legal-hold" in query:
                return "s3:PutObjectLegalHold"
            if "acl" in query:
                return "s3:PutObjectAcl"
            return "s3:PutObject"
        if method == "DELETE":
            if "tagging" in query:
                return "s3:DeleteObjectTagging"
            return "s3:DeleteObject"
        if method == "POST":
            if "select" in query and query.get("select-type") == "2":
                return "s3:GetObject"
            return "s3:PutObject"
    else:
        if method == "GET" or method == "HEAD":
            if "versions" in query:
                return "s3:ListBucketVersions"
            if "events" in query:
                return "s3:ListenBucketNotification"
            if "policyStatus" in query:
                return "s3:GetBucketPolicyStatus"
            if "policy" in query:
                return "s3:GetBucketPolicy"
            if "lifecycle" in query:
                return "s3:GetLifecycleConfiguration"
            if "encryption" in query:
                return "s3:GetEncryptionConfiguration"
            if "replication" in query or "replication-metrics" in query:
                return "s3:GetReplicationConfiguration"
            if "notification" in query:
                return "s3:GetBucketNotification"
            if "tagging" in query:
                return "s3:GetBucketTagging"
            if "object-lock" in query:
                return "s3:GetBucketObjectLockConfiguration"
            if "acl" in query:
                return "s3:GetBucketAcl"
            return "s3:ListBucket"
        if method == "PUT":
            if "policy" in query:
                return "s3:PutBucketPolicy"
            if "versioning" in query:
                return "s3:PutBucketVersioning"
            if "lifecycle" in query:
                return "s3:PutLifecycleConfiguration"
            if "encryption" in query:
                return "s3:PutEncryptionConfiguration"
            if "replication-reset" in query:
                # Separate action from config writes, as in the reference:
                # a resync re-sends every existing object (bandwidth-heavy)
                # and must be grantable/deniable independently.
                return "s3:ResetBucketReplicationState"
            if "replication" in query:
                return "s3:PutReplicationConfiguration"
            if "notification" in query:
                return "s3:PutBucketNotification"
            if "tagging" in query:
                return "s3:PutBucketTagging"
            if "object-lock" in query:
                return "s3:PutBucketObjectLockConfiguration"
            if "acl" in query:
                return "s3:PutBucketAcl"
            return "s3:CreateBucket"
        if method == "DELETE":
            if "policy" in query:
                return "s3:DeleteBucketPolicy"
            # Config deletes require the matching Put* permission, as in the
            # reference (DeleteBucketEncryption/ReplicationConfig handlers
            # check the Put*Action) -- plain s3:DeleteBucket must not be able
            # to strip replication/encryption config.
            if "lifecycle" in query:
                return "s3:PutLifecycleConfiguration"
            if "encryption" in query:
                return "s3:PutEncryptionConfiguration"
            if "replication" in query:
                return "s3:PutReplicationConfiguration"
            if "tagging" in query:
                return "s3:PutBucketTagging"
            if "website" in query:
                return "s3:DeleteBucketWebsite"
            return "s3:DeleteBucket"
        if method == "POST" and "delete" in query:
            return "s3:DeleteObject"
    return "s3:*"
