"""The disk read-cache of minio_tpu_torch on the CPU (object/cache.py and its
wiring into dist/node.py), held against the JAX package's.

The cases of tests/test_disk_cache.py run on the port: the file is executed
with its `minio_tpu.` imports pointed at `minio_tpu_torch.` and the erasure
harness of tests/harness.py built from the port's modules, over the batching
codec on the CPU (the kernels' plain versions); every other line is the JAX
file's. Then the two packages meet: the cache's directory is an on-disk
format, so the same objects read through each package's CacheObjectLayer,
under a pinned clock, leave the same files with the same bytes (entry
names, part.1, cache.json, the format marker, range entries and what the
LRU collection keeps). A port Node under MTPU_CACHE_DRIVES serves its S3
front through the cache. Tolerance: exact.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from minio_tpu.object import cache as jax_cache
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.object.types import ObjectInfo as JaxObjectInfo
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import runtime
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object import cache as port_cache
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.object.memcache import MemCacheObjectLayer
from minio_tpu_torch.object.types import ObjectInfo
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from tests.test_torch_loadgen import rerun_on_port

_HARNESS = rerun_on_port("harness", [("from minio_tpu.", "from minio_tpu_torch.", 4)], {})
_PORT_CASES = rerun_on_port(
    "test_disk_cache",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 6),
        ("from tests.harness import ErasureHarness\n", "", 1),
    ],
    globals(),
    preset={"ErasureHarness": _HARNESS.ErasureHarness},
)

NOW = 1_760_000_000.0
PKGS = {
    "jax": (jax_cache, JaxObjectInfo, JaxErasureObjects, jax_format, JaxLocalDrive),
    "port": (port_cache, ObjectInfo, ErasureObjects, port_format, LocalDrive),
}


@pytest.fixture(scope="module", autouse=True)
def cpu_default_codec():
    """The process default codec of the layers built without codec= (the JAX
    file's ErasureSets and the harness's): the batching codec on the CPU."""
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
    cases = [k for k in vars(_PORT_CASES) if k.startswith("test_")]
    assert len(cases) == 11
    assert _PORT_CASES.CacheObjectLayer is port_cache.CacheObjectLayer
    assert _HARNESS.ErasureObjects is ErasureObjects


def _tree(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


class _Backend:
    """A fixed object per key, in one package's ObjectInfo: the cache sees
    the same answers from both packages."""

    def __init__(self, info_cls, objects: dict):
        self.info_cls = info_cls
        self.objects = objects

    def _oi(self, bucket, name):
        data = self.objects[name]
        return self.info_cls(
            bucket=bucket, name=name, size=len(data), etag=f"etag-{len(data)}", version_id="",
            mod_time=NOW - 100, content_type="application/x-test", user_defined={"x-amz-meta-k": name},
            internal={"x-internal-compression": "s2"} if name.endswith(".s2") else {}, actual_size=len(data),
        )

    def get_object_info(self, bucket, name, opts=None):
        return self._oi(bucket, name)

    def get_object(self, bucket, name, opts=None, offset=0, length=-1):
        data = self.objects[name]
        end = len(data) if length < 0 else offset + length
        return self._oi(bucket, name), data[offset:end]


OBJECTS = {
    f"obj-{i}{'.s2' if i % 3 == 0 else ''}": np.random.default_rng(60 + i).integers(
        0, 256, 4000 + 1500 * i, dtype=np.uint8).tobytes()
    for i in range(12)
}


def test_same_objects_leave_the_same_cache_files(tmp_path, monkeypatch):
    """Fills, hits (atime and hit count rewritten), a range entry, an
    invalidation and the LRU collection past the high watermark, each at its
    own pinned second: both packages' cache directories hold the same files
    with the same bytes, and the reads return the same data."""
    trees, reads = {}, {}
    for name, (cache_mod, info_cls, *_rest) in PKGS.items():
        clock = {"t": NOW}
        monkeypatch.setattr(time, "time", lambda: clock["t"])
        drives = [str(tmp_path / name / f"cache{i}") for i in range(2)]
        layer = cache_mod.CacheObjectLayer(_Backend(info_cls, OBJECTS),
                                           cache_mod.CacheConfig(drives=drives, quota_bytes=40_000))
        got = []
        for i, key in enumerate(OBJECTS):
            clock["t"] = NOW + i
            got.append(layer.get_object("b", key)[1])
            if i % 2:
                clock["t"] = NOW + i + 0.5
                got.append(layer.get_object("b", key)[1])  # a hit
        clock["t"] = NOW + 50
        got.append(layer.get_object("b", "obj-11", offset=100, length=64)[1])  # served by the whole entry
        layer._invalidate("b", "obj-10")
        got.append(layer.get_object("b", "obj-10", offset=7, length=300)[1])  # a range entry
        monkeypatch.undo()
        trees[name] = [_tree(d) for d in drives]
        reads[name] = (got, layer.stats()["hits"], layer.stats()["misses"])
    assert trees["port"] == trees["jax"]
    assert reads["port"] == reads["jax"]
    assert any("_7-300" in k for t in trees["port"] for k in t)  # the range entry is there
    kept = sum(k.endswith("part.1") for t in trees["port"] for k in t)
    assert 2 <= kept < len(OBJECTS)  # the collection ran


def test_same_erasure_object_leaves_the_same_cache_files(tmp_path, monkeypatch):
    """The same bytes PUT into each package's erasure set (one format.json,
    a pinned clock) and read through its CacheObjectLayer: the same cache.json
    and part.1 in both, and a hit returns the same object info."""
    trees, infos = {}, {}
    formats = jax_format.init_format(1, 4)
    data = np.random.default_rng(61).integers(0, 256, 200 << 10, dtype=np.uint8).tobytes()
    for name, (cache_mod, _info, eo_cls, fmt_mod, drive_cls) in PKGS.items():
        dirs = [str(tmp_path / name / f"d{i}") for i in range(4)]
        for d, f in zip(dirs, formats):
            os.makedirs(d)
            f.save(d)
        eo = eo_cls([drive_cls(d) for d in dirs], parity=2)
        eo.make_bucket("b")
        monkeypatch.setattr(time, "time", lambda: NOW)
        try:
            eo.put_object("b", "big.bin", data)
            layer = cache_mod.CacheObjectLayer(eo, cache_mod.CacheConfig(drives=[str(tmp_path / name / "c")]))
            oi1, got1 = layer.get_object("b", "big.bin")
            oi2, got2 = layer.get_object("b", "big.bin")
        finally:
            monkeypatch.undo()
        assert got1 == got2 == data
        trees[name] = _tree(str(tmp_path / name / "c"))
        infos[name] = (oi2.etag, oi2.mod_time, oi2.size, oi2.user_defined, oi2.internal, oi1.etag)
    assert trees["port"] == trees["jax"]
    assert infos["port"] == infos["jax"]


def test_node_serves_through_the_disk_cache(tmp_path, monkeypatch):
    """MTPU_CACHE_DRIVES on a port Node: the S3 front serves the cache layer
    (under the memory tier when MTPU_MEMCACHE_MB is set too), background
    subsystems the raw pools."""
    codec = BatchingDeviceCodec(device="cpu")
    cache_dir = str(tmp_path / "ssd")
    monkeypatch.setenv("MTPU_CACHE_DRIVES", cache_dir)
    try:
        node = Node([str(tmp_path / f"d{i}") for i in range(4)], codec=codec, device="cpu").build()
        try:
            assert isinstance(node.cache, port_cache.CacheObjectLayer) and node.memcache is None
            assert node.s3.layer is node.cache and node.cache.backend is node.pools
            assert node.metrics.layer is node.pools and node.metrics.memcache is None
            node.s3.layer.make_bucket("bkt")
            node.s3.layer.put_object("bkt", "k", b"cached" * 100)
            assert node.s3.layer.get_object("bkt", "k")[1] == b"cached" * 100
            assert node.cache.stats()["misses"] == 1 and os.path.isfile(os.path.join(cache_dir, "format.cache.json"))
        finally:
            node.close()
        monkeypatch.setenv("MTPU_MEMCACHE_MB", "8")
        node = Node([str(tmp_path / f"d{i}") for i in range(4)], codec=codec, device="cpu").build()
        try:
            assert isinstance(node.s3.layer, MemCacheObjectLayer)
            assert node.s3.layer.backend is node.cache and node.metrics.memcache is node.memcache
        finally:
            node.close()
    finally:
        codec.close()


def teardown_module(module):
    runtime.shutdown_data_plane()
