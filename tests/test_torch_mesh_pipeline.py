"""The port's mesh path (parallel/mesh.py and the mesh branch of
models/pipeline.py) on the CPU, held byte for byte against the JAX package.

The JAX side runs its shard_map pipeline on the conftest's 8-device virtual
CPU platform; the port's counterpart is a mesh of 8 grid entries that all
map to the CPU device, each with its own blocks, kernel calls and
all-to-all tiles. Inputs come from numpy generators; tolerance is exact
equality (shard bytes and digests are an on-disk format). The port is also
held against its own host oracle (its copies of rs_ref and the numpy
HighwayHash).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minio_tpu.models.pipeline import ErasurePipeline as JaxPipeline
from minio_tpu.models.pipeline import Geometry as JaxGeometry
from minio_tpu.ops import rs_ref as jax_rs_ref
from minio_tpu.parallel import mesh as jax_mesh
from minio_tpu_torch.models.pipeline import ErasurePipeline, Geometry
from minio_tpu_torch.ops import highwayhash as hh
from minio_tpu_torch.ops import highwayhash_cuda, rs_cuda, rs_matrix, rs_ref
from minio_tpu_torch.parallel import mesh as mesh_lib

K, M = 12, 4
SHAPES = [(2, 2, 2), (4, 2, 1), (8, 1, 1), (1, 2, 4)]
CPU8 = [torch.device("cpu")] * 8


def _host_oracle(data):
    """[B, K, S] -> (shards, digests) via the port's numpy reference."""
    shards = np.stack([rs_ref.encode(data[i], M) for i in range(data.shape[0])])
    digests = np.stack([
        np.stack([np.frombuffer(hh.hash256(shards[i, j].tobytes()), dtype=np.uint8) for j in range(K + M)])
        for i in range(data.shape[0])
    ])
    return shards, digests


def _jax_encode(data, shape=None):
    mesh = jax_mesh.make_mesh(8, shape=shape)
    pipe = JaxPipeline(JaxGeometry(K, M, block_size=K * data.shape[2]), mesh=mesh)
    shards, digests = pipe.encode(jax.device_put(data, jax_mesh.data_sharding(mesh)))
    return np.asarray(shards), np.asarray(digests)


@pytest.fixture(autouse=True)
def _eight_jax_devices():
    assert jax.device_count() >= 8, "needs the 8-device virtual platform from conftest"


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_encode_matches_jax_and_host(shape):
    mesh = mesh_lib.make_mesh(8, shape=shape, devices=CPU8)
    dp, tp, sp = shape
    geom = Geometry(K, M, block_size=K * 64 * sp)
    pipe = ErasurePipeline(geom, device="cpu", mesh=mesh)
    data = np.random.default_rng(42).integers(0, 256, (2 * dp, K, geom.shard_size), dtype=np.uint8)
    rs_cuda.KERNEL.launches = highwayhash_cuda.KERNEL.launches = 0
    shards, digests = pipe.encode(data)
    want_shards, want_digests = _host_oracle(data)
    np.testing.assert_array_equal(shards.numpy(), want_shards)
    np.testing.assert_array_equal(digests.numpy(), want_digests)
    jax_shards, jax_digests = _jax_encode(data, shape)
    np.testing.assert_array_equal(shards.numpy(), jax_shards)
    np.testing.assert_array_equal(digests.numpy(), jax_digests)
    # The CPU runs the plain versions: no kernel launch is counted.
    assert rs_cuda.KERNEL.launches == highwayhash_cuda.KERNEL.launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_each_grid_entry_runs_the_body_on_its_own_blocks(shape, monkeypatch):
    """Each step calls the RS map and the hash once per grid entry, on
    contiguous [B/dp, K, S/sp] blocks and [B/dp * t_loc, S] rows; digests
    come back sp-major over the stream axis."""
    dp, tp, sp = shape
    mesh = mesh_lib.make_mesh(8, shape=shape, devices=CPU8)
    geom = Geometry(K, M, block_size=K * 64 * sp)
    pipe = ErasurePipeline(geom, device="cpu", mesh=mesh)
    calls = {"rs": [], "hh": []}
    real_rs, real_hh = rs_cuda.apply, highwayhash_cuda.hash256_batch

    def rs_spy(x, coeffs, out=None):
        calls["rs"].append((tuple(x.shape), x.stride(1) == x.shape[2]))
        return real_rs(x, coeffs, out=out)

    def hh_spy(rows, *a):
        calls["hh"].append((tuple(rows.shape), rows.is_contiguous()))
        return real_hh(rows, *a)

    monkeypatch.setattr(rs_cuda, "apply", rs_spy)
    monkeypatch.setattr(highwayhash_cuda, "hash256_batch", hh_spy)
    data = np.random.default_rng(7).integers(0, 256, (2 * dp, K, geom.shard_size), dtype=np.uint8)
    s = geom.shard_size
    blocks = mesh_lib.place_data(torch.from_numpy(data), mesh)
    assert all(b.is_contiguous() and tuple(b.shape) == (2, K, s // sp) for b in blocks.values())
    pieces = pipe.encode_blocks(blocks)
    t_loc = (K + M) // (sp * tp)
    assert calls["rs"] == [((2, K, s // sp), True)] * 8
    assert calls["hh"] == [((2 * t_loc, s), True)] * 8
    want_shards, want_digests = _host_oracle(data)
    for (d, t, si), (shards, digests) in pieces.items():
        np.testing.assert_array_equal(shards.numpy(), want_shards[2 * d:2 * d + 2, :, si * s // sp:(si + 1) * s // sp])
        j = si * tp + t
        np.testing.assert_array_equal(digests.numpy(), want_digests[2 * d:2 * d + 2, j * t_loc:(j + 1) * t_loc])


@pytest.mark.parametrize("n", range(1, 65))
def test_factor_mesh_equals_jax(n):
    assert mesh_lib.factor_mesh(n) == jax_mesh.factor_mesh(n)


@pytest.mark.parametrize("raw", ["4,2,1", "off", "0", "1", "", "auto", "banana", "2,2", "3,3,3", "-1,4,2", " 2,2,2 "])
def test_mesh_shape_from_env_equals_jax(raw, monkeypatch):
    monkeypatch.setenv("MTPU_MESH_SHAPE", raw)
    for n in (1, 2, 4, 8, 16):
        assert mesh_lib.mesh_shape_from_env(n) == jax_mesh.mesh_shape_from_env(n), n


def test_mesh_shape_values(monkeypatch):
    monkeypatch.setenv("MTPU_MESH_SHAPE", "4,2,1")
    assert mesh_lib.mesh_shape_from_env(8) == (4, 2, 1)
    for raw in ("off", "0", "1"):
        monkeypatch.setenv("MTPU_MESH_SHAPE", raw)
        assert mesh_lib.mesh_shape_from_env(8) is None
    for raw in ("", "auto", "banana", "2,2", "3,3,3", "-1,4,2"):
        monkeypatch.setenv("MTPU_MESH_SHAPE", raw)
        assert mesh_lib.mesh_shape_from_env(8) == mesh_lib.factor_mesh(8) == (2, 2, 2)


def test_codec_mesh_cached(monkeypatch):
    monkeypatch.setattr(mesh_lib, "_codec_mesh_cache", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("MTPU_MESH_SHAPE", "8,1,1")
    m1 = mesh_lib.codec_mesh()
    assert m1 is not None and m1.shape == {"dp": 8, "tp": 1, "sp": 1} and m1.size == 8
    assert m1.devices == tuple(torch.device("cuda", i) for i in range(8))
    # Cached: a later env change does not rebuild (one mesh per process).
    monkeypatch.setenv("MTPU_MESH_SHAPE", "off")
    assert mesh_lib.codec_mesh() is m1


@pytest.mark.parametrize("cards,raw", [(8, "off"), (1, "auto"), (0, "auto"), (1, "1,1,1")])
def test_codec_mesh_none(cards, raw, monkeypatch):
    """Off, one card or none: no mesh, and never a mesh of CPU devices."""
    monkeypatch.setattr(mesh_lib, "_codec_mesh_cache", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("MTPU_MESH_SHAPE", raw)
    assert mesh_lib.codec_mesh() is None


def test_codec_mesh_auto_factors_every_card(monkeypatch):
    monkeypatch.setattr(mesh_lib, "_codec_mesh_cache", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("MTPU_MESH_SHAPE", "auto")
    m = mesh_lib.codec_mesh()
    assert (m.shape["dp"], m.shape["tp"], m.shape["sp"]) == jax_mesh.factor_mesh(4)
    assert m.distinct_devices() == [torch.device("cuda", i) for i in range(4)]


def test_dp_only_rs_under_mesh_matches_host():
    """The RS map data-parallel over all 8 grid entries (the counterpart of
    the JAX package's Pallas RS under a dp-only shard_map) stays
    bit-identical to the host oracles of both packages."""
    n = 8
    mesh = mesh_lib.make_mesh(n, (n, 1, 1), devices=CPU8)
    data = np.random.default_rng(13).integers(0, 256, (n, K, 4096), dtype=np.uint8)
    parity = rs_matrix.parity_matrix(K, M)
    blocks = mesh_lib.place_data(torch.from_numpy(data), mesh)
    out = torch.empty((n, M, 4096), dtype=torch.uint8)
    pieces = {c: rs_cuda.apply(b, parity) for c, b in blocks.items()}
    mesh_lib.gather_shards(pieces, mesh, out)
    for i in range(n):
        np.testing.assert_array_equal(out[i].numpy(), rs_ref.encode(data[i], M)[K:])
        np.testing.assert_array_equal(out[i].numpy(), jax_rs_ref.encode(data[i], M)[K:])


def test_default_mesh_dryrun():
    """The default factoring of 8 entries, as the JAX package's dry run."""
    mesh = mesh_lib.make_mesh(8, devices=CPU8)
    assert (mesh.shape["dp"], mesh.shape["tp"], mesh.shape["sp"]) == (2, 2, 2)
    geom = Geometry(K, M, block_size=K * 128 * mesh.shape["sp"])
    pipe = ErasurePipeline(geom, device="cpu", mesh=mesh)
    data = np.random.default_rng(7).integers(0, 256, (2 * mesh.shape["dp"], K, geom.shard_size), dtype=np.uint8)
    shards, digests = pipe.encode(data)
    want_shards, want_digests = _host_oracle(data)
    np.testing.assert_array_equal(shards.numpy(), want_shards)
    np.testing.assert_array_equal(digests.numpy(), want_digests)
    jax_shards, jax_digests = _jax_encode(data)
    np.testing.assert_array_equal(shards.numpy(), jax_shards)
    np.testing.assert_array_equal(digests.numpy(), jax_digests)


@pytest.mark.parametrize("k,m,shape", [(4, 2, (2, 2, 2)), (12, 3, (2, 2, 2)), (5, 2, (4, 2, 1))])
def test_streams_that_do_not_tile_raise_as_in_jax(k, m, shape):
    with pytest.raises(ValueError) as jax_err:
        JaxPipeline(JaxGeometry(k, m), mesh=jax_mesh.make_mesh(8, shape=shape))
    with pytest.raises(ValueError) as port_err:
        ErasurePipeline(Geometry(k, m), device="cpu", mesh=mesh_lib.make_mesh(8, shape=shape, devices=CPU8))
    assert str(port_err.value) == str(jax_err.value)


def test_blocks_that_do_not_tile_raise():
    mesh = mesh_lib.make_mesh(8, shape=(4, 1, 2), devices=CPU8)
    pipe = ErasurePipeline(Geometry(K, M, block_size=K * 128), device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="tile"):
        pipe.encode(rng.integers(0, 256, (6, K, 128), dtype=np.uint8))  # 6 % dp
    with pytest.raises(ValueError, match="tile"):
        pipe.encode(rng.integers(0, 256, (4, K, 127), dtype=np.uint8))  # 127 % sp


def test_mesh_construction_checks():
    with pytest.raises(ValueError):
        mesh_lib.Mesh(CPU8, (2, 2, 1))
    with pytest.raises(ValueError):
        mesh_lib.Mesh([torch.device("cpu"), torch.device("cuda", 0)], (2, 1, 1))
    m = mesh_lib.make_mesh(shape=(4, 1, 1), devices=CPU8[:4])
    assert m.shape == {"dp": 4, "tp": 1, "sp": 1} and m.size == 4 and m.type == "cpu"
    assert [m.device(c) for c in m.coords()] == CPU8[:4]
    assert list(m.coords()) == [(d, 0, 0) for d in range(4)]


def test_no_fallback_without_a_card(monkeypatch):
    """With no card, a mesh of cards cannot be built, and a pipeline on a
    mesh of cuda entries raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        mesh_lib.make_mesh()
    virtual = mesh_lib.make_mesh(shape=(4, 1, 1), devices=[torch.device("cuda", 0)] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErasurePipeline(Geometry(K, M), mesh=virtual)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErasurePipeline(Geometry(K, M), device="cpu", mesh=virtual)
