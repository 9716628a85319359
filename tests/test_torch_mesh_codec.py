"""The batching codec's mesh handling in the port (parallel/batching.py:
mesh routing, dp padding and chip_blocks accounting) on the CPU, held
against the JAX package's codec on its 8-device virtual CPU platform.

The port's CPU mesh repeats the CPU device (a virtual mesh); the JAX
codec gets a mesh of the same shape over its virtual devices. Blocks come
from numpy generators at a 48 KiB block size (shards of 4,096 bytes, so the
CPU plain hash stays quick); tolerance is exact equality for bytes and
counters.
"""

from __future__ import annotations

import re
import sys
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.parallel import batching as jax_batching
from minio_tpu.parallel import mesh as jax_mesh
from minio_tpu_torch.control import metrics as port_metrics
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.codec import HostCodec
from minio_tpu_torch.ops import highwayhash_cuda, rs_matrix
from minio_tpu_torch.parallel import batching
from minio_tpu_torch.parallel import mesh as mesh_lib
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

BLOCK = 12 * 4096
CPU = torch.device("cpu")


def _blocks(seed: int, n: int, size: int = BLOCK) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


def _norm(results) -> list:
    return [([bytes(x) for x in shards], [bytes(x) for x in digests]) for shards, digests in results]


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape=shape, devices=[CPU] * int(np.prod(shape)))


def _chip_blocks(dp: int, batches: list[int]) -> list[int]:
    """The JAX package's accounting (parallel/batching.py _resolve_batch)
    for batches of b_real blocks."""
    out = [0] * dp
    for b_real in batches:
        b_pad = -(-jax_batching._bucket(b_real) // dp) * dp
        per = b_pad // dp
        for g in range(dp):
            out[g] += min(max(b_real - g * per, 0), per)
    return out


KEYS = ("blocks_encoded", "batches_run", "blocks_padded", "mesh_devices", "chip_blocks")


def test_mesh_codec_bytes_and_counters_equal_jax():
    port = BatchingDeviceCodec(block_size=BLOCK, max_batch=6, batch_timeout_s=0.5, device="cpu",
                               mesh=_cpu_mesh((4, 1, 1)))
    jax_codec = jax_batching.BatchingDeviceCodec(block_size=BLOCK, max_batch=6, batch_timeout_s=0.5,
                                                 mesh=jax_mesh.make_mesh(4, (4, 1, 1)))
    try:
        for seed, n in ((40, 6), (41, 3)):
            blocks = _blocks(seed, n)
            got = _norm(port.encode(blocks, 12, 4))
            assert got == _norm(HostCodec().encode(blocks, 12, 4))
            assert got == _norm(jax_codec.encode(blocks, 12, 4))
            assert got == _norm(JaxHostCodec().encode(blocks, 12, 4))
        st, jst = port.stats(), jax_codec.stats()
        assert {k: st[k] for k in KEYS} == {k: jst[k] for k in KEYS}
        assert st["mesh_devices"] == 4
        assert st["chip_blocks"] == _chip_blocks(4, [6, 3]) == [3, 3, 3, 0]
        assert sum(st["chip_blocks"]) == st["blocks_encoded"] == 9
        assert st["blocks_padded"] == 12
    finally:
        port.close()
        jax_codec.close()


@pytest.mark.parametrize("k,m,shape,block", [
    (4, 2, (2, 2, 2), BLOCK),  # 6 streams do not tile tp x sp = 4
    (12, 4, (1, 2, 4), 12 * 4095),  # 4,095-byte shards do not tile sp = 4
])
def test_geometry_that_does_not_tile_runs_single_device(k, m, shape, block):
    port = BatchingDeviceCodec(block_size=block, max_batch=4, batch_timeout_s=0.2, device="cpu",
                               mesh=_cpu_mesh(shape))
    jax_codec = jax_batching.BatchingDeviceCodec(block_size=block, max_batch=4, batch_timeout_s=0.2,
                                                 mesh=jax_mesh.make_mesh(8, shape))
    try:
        blocks = _blocks(42, 3, block)
        got = _norm(port.encode(blocks, k, m))
        assert got == _norm(HostCodec().encode(blocks, k, m))
        assert port._pipelines[(k, m)].mesh is None
        assert got == _norm(jax_codec.encode(blocks, k, m))
        st = port.stats()
        assert st["mesh_devices"] == 1 and st["chip_blocks"] == []
        assert {key: st[key] for key in KEYS} == {key: jax_codec.stats()[key] for key in KEYS}
    finally:
        port.close()
        jax_codec.close()


def test_auto_on_the_cpu_is_no_mesh(monkeypatch):
    def no_codec_mesh():
        raise AssertionError("codec_mesh() consulted for a CPU codec")

    monkeypatch.setattr(mesh_lib, "codec_mesh", no_codec_mesh)
    codec = BatchingDeviceCodec(block_size=BLOCK, device="cpu")
    try:
        assert codec.mesh == "auto"
        blocks = _blocks(43, 2)
        assert _norm(codec.encode(blocks, 12, 4)) == _norm(HostCodec().encode(blocks, 12, 4))
        assert codec.mesh is None
        st = codec.stats()
        assert st["mesh_devices"] == 1 and st["chip_blocks"] == []
    finally:
        codec.close()


def test_a_mesh_of_another_device_type_is_refused():
    with pytest.raises(ValueError, match="mesh"):
        BatchingDeviceCodec(device="cpu", mesh=mesh_lib.make_mesh(shape=(4, 1, 1), devices=[torch.device("cuda", 0)] * 4))


def test_no_mesh_codec_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingDeviceCodec(mesh=mesh_lib.make_mesh(shape=(4, 1, 1), devices=[torch.device("cuda", 0)] * 4))


def test_a_failure_on_one_mesh_entry_raises_through_every_future(monkeypatch):
    codec = BatchingDeviceCodec(block_size=BLOCK, max_batch=4, batch_timeout_s=0.5, device="cpu",
                                mesh=_cpu_mesh((2, 1, 2)))
    calls = []
    real = highwayhash_cuda.hash256_batch

    def failing_on_the_third_entry(rows, *a):
        calls.append(rows.shape)
        if len(calls) == 3:
            raise RuntimeError("launch failed on grid entry 3")
        return real(rows, *a)

    monkeypatch.setattr(highwayhash_cuda, "hash256_batch", failing_on_the_third_entry)
    try:
        q = codec._ensure_worker(12, 4)
        futures = [Future() for _ in range(4)]
        for block, f in zip(_blocks(44, 4), futures):
            q.put(batching._Request(rs_matrix.split(np.frombuffer(block, np.uint8), 12), f))
        for f in futures:
            with pytest.raises(RuntimeError, match="grid entry 3"):
                f.result(timeout=30)
        assert codec.stats()["blocks_encoded"] == 0 and codec.stats()["chip_blocks"] == [0, 0]
    finally:
        codec.close()


def test_concurrent_puts_account_every_block(monkeypatch):
    """16 threads encode through one (4,1,1) mesh codec: every result equals
    the host codec's and the per-group counts add up to blocks_encoded."""
    codec = BatchingDeviceCodec(block_size=BLOCK, max_batch=8, batch_timeout_s=0.002, device="cpu",
                                mesh=_cpu_mesh((4, 1, 1)))
    work = {i: _blocks(100 + i, 1 + i % 3) for i in range(16)}
    results: dict = {}
    errors: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def put(i):
        try:
            results[i] = codec.encode(work[i], 12, 4)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=put, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        codec.close()
    assert errors == []
    for i, blocks in work.items():
        assert _norm(results[i]) == _norm(HostCodec().encode(blocks, 12, 4))
    st = codec.stats()
    assert st["blocks_encoded"] == sum(len(b) for b in work.values())
    assert sum(st["chip_blocks"]) == st["blocks_encoded"]
    assert st["blocks_padded"] % 4 == 0 and len(st["chip_blocks"]) == 4


SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def test_metrics_render_the_mesh_counters(monkeypatch):
    codec = BatchingDeviceCodec(block_size=BLOCK, max_batch=5, batch_timeout_s=0.5, device="cpu",
                                mesh=_cpu_mesh((4, 1, 1)))
    try:
        monkeypatch.setattr(codec_mod, "_default", codec)
        codec.encode(_blocks(45, 5), 12, 4)
        text = port_metrics.MetricsSys().render_node()
        st = codec.stats()
    finally:
        codec.close()
    series: dict = {}
    for line in text.splitlines():
        hit = SAMPLE.match(line)
        if hit:
            series.setdefault(hit.group(1), {})[hit.group(2) or ""] = hit.group(3)
    assert st["chip_blocks"] == _chip_blocks(4, [5]) == [2, 2, 1, 0]
    assert series["minio_tpu_codec_mesh_devices"] == {"": "4"}
    assert series["minio_tpu_codec_chip_blocks_total"] == {
        f'{{chip="{g}"}}': str(n) for g, n in enumerate(st["chip_blocks"])}
