"""Tier-transition markers of xl.meta (the JAX package's control/tiering.py).

Only the constants the object layer reads are here: transition_object
stamps a version with them, and heal reads them to heal a transitioned
version by its metadata alone. The rest of that module -- the tier
configuration, the tier clients, the transition and restore flow and the
remote-delete journal -- is ported with the control plane (ROADMAP.md,
Queue A item 8).
"""

from __future__ import annotations

# Internal xl.meta markers (reference: TransitionStatus/TransitionedObjName/
# TransitionTier fields of xlMetaV2Object, xl-storage-format-v2.go:163).
META_TRANSITION_STATUS = "x-internal-transition-status"
META_TRANSITION_TIER = "x-internal-transition-tier"
META_TRANSITION_NAME = "x-internal-transitioned-name"
STATUS_COMPLETE = "complete"
