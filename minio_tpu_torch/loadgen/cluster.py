"""In-process multi-node cluster for loadgen runs.

The same machinery the distributed tests trust (tests/test_dist.py): N
Node instances over local temp-dir drives, each behind its own
ThreadedServer on a localhost port, sharing nothing but the endpoint list
-- real sigv4 auth, real internode REST, real erasure IO, one process.
Packaged here (not in tests/) so `python -m minio_tpu_torch.tools.loadgen`
can stand a cluster up outside pytest.

Every node serves one codec: the caller's (``codec=``), or one built once on
``device``. On "cuda" that is the batching codec behind the device probe,
with no fallback: without a card the constructor raises. "cpu" runs the
kernels' plain versions, and only because the caller asked for it. stop()
closes every node, and then the codec if the cluster built it.
"""

from __future__ import annotations

import os
import socket
import threading
from types import SimpleNamespace

ROOT_USER = "loadgenadmin"
ROOT_PASSWORD = "loadgen-secret-key"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


class InProcessCluster:
    """N-node erasure cluster in this process; `urls` is the S3 surface."""

    def __init__(
        self,
        workdir: str,
        n_nodes: int = 4,
        drives_per_node: int = 4,
        root_user: str = ROOT_USER,
        root_password: str = ROOT_PASSWORD,
        build_timeout_s: float = 120.0,
        pools: int = 1,
        codec=None,
        device="cuda",
    ):
        from ..api.server import ThreadedServer
        from ..dist.node import Node

        self.nodes = []
        self.servers = []
        self._own_codec = None
        if codec is None:
            codec = self._own_codec = _build_codec(device)
        self.codec = codec
        self.root_user = root_user
        self.root_password = root_password
        ports = [_free_port() for _ in range(n_nodes)]
        self.urls = [f"http://127.0.0.1:{p}" for p in ports]
        # pools > 1 builds a server-pools cluster: each pool is an
        # independent endpoint group of the same shape (the reference's
        # `minio server poolA{1...n} poolB{1...n}` expansion), which is
        # what the pool-lifecycle scenarios decommission out from under
        # live traffic.
        endpoint_pools: list[list[str]] = []
        for pi in range(pools):
            group = []
            for ni in range(n_nodes):
                for di in range(drives_per_node):
                    tag = f"p{pi}n{ni}d{di}" if pools > 1 else f"n{ni}d{di}"
                    d = os.path.join(workdir, tag)
                    os.makedirs(d, exist_ok=True)
                    group.append(f"{self.urls[ni]}{d}")
            endpoint_pools.append(group)
        endpoints = endpoint_pools if pools > 1 else endpoint_pools[0]
        try:
            self.nodes = [
                Node(
                    endpoints,
                    url=self.urls[ni],
                    root_user=root_user,
                    root_password=root_password,
                    set_drive_count=n_nodes * drives_per_node,
                    codec=codec,
                )
                for ni in range(n_nodes)
            ]
            for ni, node in enumerate(self.nodes):
                ts = ThreadedServer(SimpleNamespace(app=node.make_app()), port=ports[ni])
                ts.start()
                self.servers.append(ts)
            # Build concurrently: node 0 leads the format, the rest wait
            # for quorum (the same dance real multi-server boot does).
            threads = [threading.Thread(target=n.build, daemon=True) for n in self.nodes]
            for t in threads:
                t.start()
            for t in threads:
                t.join(build_timeout_s)
            if not all(n.pools is not None for n in self.nodes):
                raise RuntimeError(
                    f"cluster failed to build within {build_timeout_s:.0f}s "
                    f"({n_nodes} nodes x {drives_per_node} drives)"
                )
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for ts in self.servers:
            try:
                ts.stop()
            except Exception:  # noqa: BLE001 - teardown must reach every server
                pass
        self.servers = []
        # Stop every node's background workers too (replication, MRF heal,
        # disk-heal monitor, ...): a sanitized run (MTPU_TSAN=1) leak-checks
        # threads at exit, and a plain run shouldn't strand daemons either.
        for node in self.nodes:
            try:
                node.close()
            except Exception:  # noqa: BLE001
                pass
        self.nodes = []
        own, self._own_codec = self._own_codec, None
        if own is not None:
            from ..object import codec as codec_mod

            with codec_mod._default_lock:
                if codec_mod._default is own:
                    codec_mod._default = None
            own.close()


def _build_codec(device):
    """The cluster's one codec on `device`: on "cuda" the probe's verdict
    must be ok (runtime.install_data_plane_codec raises otherwise), and with
    no card at all this raises before any probe runs."""
    from ..runtime import install_data_plane_codec

    if not str(device).startswith("cpu"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA card is visible (torch.cuda.is_available() "
                "is false); pass device='cpu' to run the kernels' plain versions"
            )
    return install_data_plane_codec(device=device)
