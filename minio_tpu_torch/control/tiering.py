"""Tier-transition markers of xl.meta (the JAX package's control/tiering.py).

Only what the object layer and the S3 front read is here: transition_object
stamps a version with the markers, heal reads them to heal a transitioned
version by its metadata alone, and the front asks `is_transitioned` and
`restore_expiry` (with `S3Server.tiering` left None it then answers as the
JAX front does without a tier manager). The rest of that module -- the tier
configuration (`TierConfigMgr`), the tier clients, the transition and
restore flow and the remote-delete journal -- is ported with the control
plane (ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

import calendar
import time

# Internal xl.meta markers (reference: TransitionStatus/TransitionedObjName/
# TransitionTier fields of xlMetaV2Object, xl-storage-format-v2.go:163).
META_TRANSITION_STATUS = "x-internal-transition-status"
META_TRANSITION_TIER = "x-internal-transition-tier"
META_TRANSITION_NAME = "x-internal-transitioned-name"
STATUS_COMPLETE = "complete"

# User-facing restore status (S3 x-amz-restore semantics).
META_RESTORE = "x-amz-restore"


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
