"""Network fault hook: one seam under every internode RPC.

All inter-node traffic -- storage-REST (RemoteDrive), peer fanout
(PeerClient / NotificationSys), and RemoteLocker lock calls -- rides
dist/transport.py's RestClient.call, so a single check there covers the
whole control and data plane. transport.py guards the call with
`REGISTRY.net is None` (the zero-overhead check) and only then enters
before_rpc.

Kinds:
  partition  -- raise DiskNotFound before the request leaves the process
                (a blackholed peer as the caller experiences it: the typed
                error the requests-failure path would produce, minus the
                connect timeout). probability < 1 models a lossy link.
  slow-rpc   -- sleep delay_ms, then let the call proceed; combine with a
                probability for jittery/lossy links.
  lock-death -- partition semantics, but matched only against lock REST
                endpoints, so a node's LOCAL locker API dies while its
                storage and peer planes stay up (the lock-server-crash
                scenario dsync is designed around).
"""

from __future__ import annotations

import time

from ..utils import errors
from .faults import REGISTRY, SLOW_RPC


def before_rpc(base_url: str, path: str = "", registry=None) -> None:
    """Consult armed net faults for one outbound RPC; called by
    RestClient.call only when the net snapshot is armed."""
    reg = registry if registry is not None else REGISTRY
    spec = reg.match_net(base_url, path)
    if spec is None:
        return
    if spec.kind == SLOW_RPC:
        if spec.delay_ms > 0:
            time.sleep(spec.delay_ms / 1e3)
        return
    raise errors.DiskNotFound(f"chaos: {spec.kind} injected for {base_url}{path}")
