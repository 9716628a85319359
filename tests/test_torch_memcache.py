"""The hot-read memory cache of minio_tpu_torch on the CPU (object/memcache.py
and its wiring into dist/node.py), held against the JAX package's.

The cases of tests/test_memcache.py run on the port: the file is executed with
its `minio_tpu.` imports pointed at `minio_tpu_torch.`, the erasure harness of
tests/harness.py built from the port's modules, and its two-node cluster built
on device="cpu" (the kernels' plain versions); every other line is the JAX
file's. Then the two packages meet in one cluster of a JAX node and a port
node under MTPU_MEMCACHE_MB=64 and MTPU_MEMCACHE_VALIDATE=0: a PUT or a
DELETE through either package leaves no stale read on the other package's
warm node, because the writer fans the invalidation out before its ack; and
both nodes' /metrics give the same memcache series (names, labels, HELP and
TYPE lines). Tolerance: exact.
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np
import pytest

from minio_tpu import cli as jax_cli
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.memcache import MemCacheObjectLayer
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from tests.s3client import S3TestClient
from tests.test_torch_loadgen import rerun_on_port

ROOT = "mixedmem"
SECRET = "mixed-memcache-secret"
ADMIN = "/mtpu/admin/v1"

_HARNESS = rerun_on_port("harness", [("from minio_tpu.", "from minio_tpu_torch.", 4)], {})
_PORT_CASES = rerun_on_port(
    "test_memcache",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 5),
        ("from tests.harness import ErasureHarness\n", "", 1),
        ("set_drive_count=8)", 'set_drive_count=8, device="cpu")', 1),
    ],
    globals(),
    preset={"ErasureHarness": _HARNESS.ErasureHarness},
)


@pytest.fixture(scope="module", autouse=True)
def cpu_default_codec():
    """The process default codec of this file's layers built without codec=
    (the harness's): the batching codec on the CPU. At the end every node the
    file built is closed, and then the codec."""
    codec = BatchingDeviceCodec(device="cpu")
    codec_mod.set_default_codec(codec)
    try:
        yield codec
    finally:
        Node.close_all()
        with codec_mod._default_lock:
            if codec_mod._default is codec:
                codec_mod._default = None
        codec.close()


def test_the_jax_cases_run_on_the_port():
    cases = [
        (cls, m)
        for cls, obj in vars(_PORT_CASES).items()
        if cls.startswith("Test") and isinstance(obj, type)
        for m in vars(obj)
        if m.startswith("test_")
    ]
    assert len(cases) == 10
    assert _PORT_CASES.MemCacheObjectLayer is MemCacheObjectLayer
    assert _HARNESS.ErasureObjects.__module__ == "minio_tpu_torch.object.erasure"


# -- one cluster of a JAX node and a port node -----------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Served:
    """One node and its HTTP server."""

    def __init__(self, node, run_app_until, port: int):
        self.node = node
        self.stop_evt = threading.Event()
        self.thread, errs = run_app_until(node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs

    def stop(self) -> None:
        self.stop_evt.set()
        self.thread.join(10)
        self.node.close()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Node 0 of the JAX package and node 1 of the port over one 8-drive set,
    both with the memory tier armed and per-hit validation off: coherence
    rides on the write-path peer fan-out alone."""
    root = tmp_path_factory.mktemp("mixedmem")
    codec = BatchingDeviceCodec(device="cpu")
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    endpoints = [f"{urls[n]}{root}/n{n}d{d}" for n in range(2) for d in range(4)]
    served = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_MEMCACHE_MB", "64")
        mp.setenv("MTPU_MEMCACHE_VALIDATE", "0")
        try:
            jax_node = JaxNode(endpoints, url=urls[0], root_user=ROOT, root_password=SECRET, set_drive_count=8,
                               codec=JaxHostCodec())
            port_node = Node(endpoints, url=urls[1], root_user=ROOT, root_password=SECRET, set_drive_count=8,
                             codec=codec, device="cpu")
            served = [Served(jax_node, jax_cli._run_app_until, ports[0]),
                      Served(port_node, cli._run_app_until, ports[1])]
            threads = [threading.Thread(target=s.node.build) for s in served]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert jax_node.pools is not None and port_node.pools is not None
            assert jax_node.memcache is not None and port_node.memcache is not None
            assert port_node.metrics.memcache is port_node.memcache
            assert isinstance(port_node.s3.layer, MemCacheObjectLayer)
            clients = {"jax": S3TestClient(urls[0], ROOT, SECRET), "port": S3TestClient(urls[1], ROOT, SECRET)}
            assert clients["jax"].make_bucket("mixed").status_code == 200
            yield {"nodes": {"jax": jax_node, "port": port_node}, "clients": clients}
        finally:
            for s in served:
                s.stop()
            codec.close()


BODIES = {
    n: np.random.default_rng(16 + i).integers(0, 256, n, dtype=np.uint8).tobytes()
    for i, n in enumerate((48 << 10, 160 << 10))  # inline, and streamed past 128 KiB
}


@pytest.mark.parametrize("size", sorted(BODIES), ids=["inline", "streamed"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_write_through_one_package_leaves_no_stale_read_on_the_other(mixed, writer, reader, size):
    w, r = mixed["clients"][writer], mixed["clients"][reader]
    reader_mc = mixed["nodes"][reader].memcache
    key = f"{writer}-to-{reader}-{size}"
    v1 = BODIES[size]
    v2 = v1[::-1]
    assert w.put_object("mixed", key, v1).status_code == 200
    got = r.get_object("mixed", key)
    assert (got.status_code, got.content == v1) == (200, True)
    assert reader_mc.get(("mixed", key, "", ())) is not None  # warm
    # The overwrite's ack comes after the writer's fan-out: the reader's
    # entry is gone when put_object returns, with no sleep and no retry.
    assert w.put_object("mixed", key, v2).status_code == 200
    assert reader_mc.get(("mixed", key, "", ())) is None
    got = r.get_object("mixed", key)
    assert (got.status_code, got.content == v2) == (200, True)
    assert reader_mc.get(("mixed", key, "", ())) is not None  # warm again
    assert w.delete_object("mixed", key).status_code == 204
    assert reader_mc.get(("mixed", key, "", ())) is None
    assert r.get_object("mixed", key).status_code == 404


def _memcache_shape(text: str) -> list[str]:
    """The memcache lines of an exposition with every sample value and the
    node's own label values blanked: HELP, TYPE, names and label names."""
    out = []
    for line in text.splitlines():
        if "minio_tpu_memcache_" not in line:
            continue
        if not line.startswith("#"):
            line = re.sub(r'="[^"]*"', '=""', line.rsplit(" ", 1)[0])
        out.append(line)
    return out


def test_metrics_memcache_series_match(mixed):
    clients = mixed["clients"]
    key = "metrics-hot"
    assert clients["port"].put_object("mixed", key, BODIES[48 << 10]).status_code == 200
    for c in clients.values():
        for _ in range(2):  # a fill, then a hit, on each node
            assert c.get_object("mixed", key).status_code == 200
    shapes = {}
    for name, c in clients.items():
        r = c.request("GET", f"{ADMIN}/metrics")
        assert r.status_code == 200, r.text[:300]
        shapes[name] = _memcache_shape(r.text)
    assert len([x for x in shapes["port"] if x.startswith("# TYPE")]) == 9
    assert shapes["port"] == shapes["jax"]
    st = mixed["nodes"]["port"].memcache.stats()
    assert st["hits"] >= 1 and st["fills"] >= 1


def teardown_module(module):
    runtime.shutdown_data_plane()
