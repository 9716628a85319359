"""S3 Object Lock: retention modes, legal hold, WORM enforcement.

Role of the reference's internal/bucket/object/lock (retention config parse,
per-object retention/legal-hold metadata) and the enforcement checks in
cmd/object-handlers.go / erasure delete paths. Lock state lives in per-version
object metadata:

    x-amz-object-lock-mode              GOVERNANCE | COMPLIANCE
    x-amz-object-lock-retain-until-date ISO8601
    x-amz-object-lock-legal-hold        ON | OFF
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

from ..api.errors import S3Error

META_MODE = "x-amz-object-lock-mode"
META_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
META_LEGAL_HOLD = "x-amz-object-lock-legal-hold"

MODES = ("GOVERNANCE", "COMPLIANCE")


def _strip(tag: str) -> str:
    return tag.split("}", 1)[-1]


def _find_text(root, name: str) -> Optional[str]:
    for el in root.iter():
        if _strip(el.tag) == name:
            return el.text
    return None


@dataclass
class DefaultRetention:
    mode: str = ""
    days: int = 0
    years: int = 0


@dataclass
class LockConfig:
    enabled: bool = False
    default: Optional[DefaultRetention] = None

    @classmethod
    def from_xml(cls, xml_text: str) -> "LockConfig":
        if not xml_text:
            return cls()
        try:
            root = ET.fromstring(xml_text)
        except ET.ParseError:
            raise S3Error("MalformedXML", "bad object lock configuration")
        enabled = (_find_text(root, "ObjectLockEnabled") or "") == "Enabled"
        mode = _find_text(root, "Mode")
        default = None
        if mode:
            if mode.upper() not in MODES:
                raise S3Error("MalformedXML", f"unknown retention mode {mode}")
            days = int(_find_text(root, "Days") or 0)
            years = int(_find_text(root, "Years") or 0)
            if (days and years) or (not days and not years):
                raise S3Error("MalformedXML", "exactly one of Days or Years required")
            default = DefaultRetention(mode.upper(), days, years)
        return cls(enabled, default)

    def default_retention_meta(self, now: float) -> dict[str, str]:
        """Metadata for a new object under the bucket's default retention."""
        if not self.enabled or self.default is None:
            return {}
        until = datetime.datetime.fromtimestamp(now, datetime.timezone.utc)
        until += datetime.timedelta(days=self.default.days + 365 * self.default.years)
        return {
            META_MODE: self.default.mode,
            META_RETAIN_UNTIL: format_iso(until),
        }


def format_iso(dt: datetime.datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def parse_iso(s: str) -> datetime.datetime:
    t = s.strip().replace("Z", "+00:00")
    dt = datetime.datetime.fromisoformat(t)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt


def parse_retention_xml(body: bytes) -> tuple[str, str]:
    """Parse a <Retention> document; returns (mode, retain-until ISO)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML")
    mode = (_find_text(root, "Mode") or "").upper()
    until = _find_text(root, "RetainUntilDate") or ""
    if mode not in MODES:
        raise S3Error("MalformedXML", "unknown retention mode")
    if not until:
        raise S3Error("MalformedXML", "missing RetainUntilDate")
    if parse_iso(until) <= datetime.datetime.now(datetime.timezone.utc):
        raise S3Error("InvalidArgument", "RetainUntilDate must be in the future")
    return mode, until


def retention_xml(mode: str, until: str) -> str:
    return (
        f"<Retention><Mode>{mode}</Mode>"
        f"<RetainUntilDate>{until}</RetainUntilDate></Retention>"
    )


def parse_legal_hold_xml(body: bytes) -> str:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML")
    status = (_find_text(root, "Status") or "").upper()
    if status not in ("ON", "OFF"):
        raise S3Error("MalformedXML", "legal hold status must be ON or OFF")
    return status


def legal_hold_xml(status: str) -> str:
    return f"<LegalHold><Status>{status}</Status></LegalHold>"


@dataclass
class LockState:
    mode: str = ""
    retain_until: str = ""
    legal_hold: str = ""

    @classmethod
    def from_meta(cls, meta: dict[str, str]) -> "LockState":
        return cls(
            mode=meta.get(META_MODE, "").upper(),
            retain_until=meta.get(META_RETAIN_UNTIL, ""),
            legal_hold=meta.get(META_LEGAL_HOLD, "").upper(),
        )

    def retention_active(self) -> bool:
        if not self.mode or not self.retain_until:
            return False
        try:
            return parse_iso(self.retain_until) > datetime.datetime.now(datetime.timezone.utc)
        except ValueError:
            return False


def check_delete_allowed(
    meta: dict[str, str],
    bypass_governance: bool,
    may_bypass: bool,
) -> None:
    """WORM check for deleting a specific version (enforceRetentionForDeletion
    equivalent). Raises AccessDenied when locked."""
    st = LockState.from_meta(meta)
    if st.legal_hold == "ON":
        raise S3Error("AccessDenied", "object is under legal hold")
    if not st.retention_active():
        return
    if st.mode == "COMPLIANCE":
        raise S3Error("AccessDenied", "object is locked in COMPLIANCE mode")
    # GOVERNANCE: deletable only with the bypass header AND permission
    if not (bypass_governance and may_bypass):
        raise S3Error("AccessDenied", "object is locked in GOVERNANCE mode")


def check_retention_tighten(
    old: LockState,
    new_mode: str,
    new_until: str,
    bypass_governance: bool,
    may_bypass: bool,
) -> None:
    """Changing retention may only extend it, unless governance bypass applies
    (same-mode extension always allowed; COMPLIANCE can never be loosened)."""
    if not old.retention_active():
        return
    # Tightening = same-or-stricter mode with a same-or-later date.
    # GOVERNANCE -> COMPLIANCE upgrade is a tighten (AWS allows it without
    # bypass); COMPLIANCE can never be loosened or downgraded.
    date_extends = parse_iso(new_until) >= parse_iso(old.retain_until)
    mode_tightens = new_mode == old.mode or (
        old.mode == "GOVERNANCE" and new_mode == "COMPLIANCE"
    )
    if date_extends and mode_tightens:
        return
    if old.mode == "COMPLIANCE":
        raise S3Error("AccessDenied", "COMPLIANCE retention cannot be loosened")
    if not (bypass_governance and may_bypass):
        raise S3Error("AccessDenied", "GOVERNANCE retention change requires bypass")
