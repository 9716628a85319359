"""Object lifecycle (ILM): expiry + transition rules.

Role of the reference's internal/bucket/lifecycle + cmd/bucket-lifecycle.go:
parse the S3 LifecycleConfiguration XML, evaluate rules against an object
(prefix/tag filters, Expiration days/date, NoncurrentVersionExpiration), and
let the scanner apply the verdicts. Transition-to-tier reuses the same rule
machinery with the tier manager (control/tiering.py) as the data mover.
A copy of the JAX package's control/lifecycle.py.
"""

from __future__ import annotations

import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field


def _text(el, name: str) -> str:
    for c in el.iter():
        if c.tag.split("}")[-1] == name:
            return c.text or ""
    return ""


@dataclass
class LifecycleRule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    expiration_days: int = 0
    expiration_date: float = 0.0
    expired_delete_marker: bool = False
    noncurrent_days: int = 0
    transition_days: int = -1  # -1 = no <Days> element (0 is valid: immediate)
    transition_date: float = 0.0
    transition_tier: str = ""
    abort_mpu_days: int = 0  # AbortIncompleteMultipartUpload/DaysAfterInitiation

    def applies(self, object_name: str) -> bool:
        return self.status == "Enabled" and object_name.startswith(self.prefix)


@dataclass
class Lifecycle:
    rules: list[LifecycleRule] = field(default_factory=list)

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "Lifecycle":
        root = ET.fromstring(raw)
        rules = []
        for rel in root:
            if rel.tag.split("}")[-1] != "Rule":
                continue
            r = LifecycleRule()
            for c in rel:
                t = c.tag.split("}")[-1]
                if t == "ID":
                    r.rule_id = c.text or ""
                elif t == "Status":
                    r.status = c.text or "Enabled"
                elif t == "Filter" or t == "Prefix":
                    r.prefix = _text(c, "Prefix") if t == "Filter" else (c.text or "")
                elif t == "Expiration":
                    days = _text(c, "Days")
                    if days:
                        r.expiration_days = int(days)
                    date = _text(c, "Date")
                    if date:
                        r.expiration_date = time.mktime(
                            time.strptime(date[:10], "%Y-%m-%d")
                        )
                    if _text(c, "ExpiredObjectDeleteMarker").lower() == "true":
                        r.expired_delete_marker = True
                elif t == "NoncurrentVersionExpiration":
                    days = _text(c, "NoncurrentDays")
                    if days:
                        r.noncurrent_days = int(days)
                elif t == "AbortIncompleteMultipartUpload":
                    days = _text(c, "DaysAfterInitiation")
                    if days:
                        r.abort_mpu_days = int(days)
                elif t == "Transition":
                    days = _text(c, "Days")
                    if days:
                        r.transition_days = int(days)
                    date = _text(c, "Date")
                    if date:
                        r.transition_date = time.mktime(
                            time.strptime(date[:10], "%Y-%m-%d")
                        )
                    r.transition_tier = _text(c, "StorageClass")
            rules.append(r)
        return cls(rules)

    def eval(self, object_name: str, mod_time: float, is_delete_marker: bool = False) -> str:
        """-> "expire" | "transition:<tier>" | "" (the scanner's verdict)."""
        now = time.time()
        for r in self.rules:
            if not r.applies(object_name):
                continue
            if is_delete_marker and r.expired_delete_marker:
                return "expire"
            if r.expiration_days and now - mod_time > r.expiration_days * 86400:
                return "expire"
            if r.expiration_date and now > r.expiration_date:
                return "expire"
            # Days=0 means transition as soon as the scanner sees the object
            # (valid per S3); a rule with only <Date> waits for that date.
            if r.transition_tier:
                if r.transition_days >= 0 and now - mod_time >= r.transition_days * 86400:
                    return f"transition:{r.transition_tier}"
                if r.transition_date and now > r.transition_date:
                    return f"transition:{r.transition_tier}"
        return ""

    def eval_abort_mpu(self, object_name: str, initiated: float) -> bool:
        """Should an incomplete multipart upload be aborted?
        (AbortIncompleteMultipartUpload, DaysAfterInitiation semantics.)"""
        now = time.time()
        for r in self.rules:
            if r.applies(object_name) and r.abort_mpu_days:
                if now - initiated > r.abort_mpu_days * 86400:
                    return True
        return False

    def eval_noncurrent(self, object_name: str, successor_mod_time: float) -> bool:
        now = time.time()
        for r in self.rules:
            if r.applies(object_name) and r.noncurrent_days:
                if now - successor_mod_time > r.noncurrent_days * 86400:
                    return True
        return False
