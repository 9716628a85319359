"""Pool lifecycle of minio_tpu_torch on the CPU (object/poolmgr.py and
control/rebalance.py), held against the JAX package's.

The cases of tests/test_poolmgr.py run on the port: attach, checkpointed
decommission with a kill and a resume, rebalance-on-expansion, the
throttle's arithmetic, status. Then both packages get the same pools (the
same format.json on every drive) and the same numpy-seeded objects, the
port on BatchingDeviceCodec(device="cpu") and the JAX package on its numpy
HostCodec, with the clock and uuid4 pinned while they write: the persisted
pool config, the decommission checkpoint and the drained objects' part
files and xl.meta must be the same bytes, each package must resume a drain
the other one checkpointed, and a rebalance must end at the same per-pool
counts. Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from minio_tpu.object import erasure as jax_erasure
from minio_tpu.object import poolmgr as jax_poolmgr
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import PutObjectOptions as JaxPutObjectOptions
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.control import rebalance as rebalance_mod
from minio_tpu_torch.control.rebalance import ObjectMover, RebalanceEngine, ThrottleBudget
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object import erasure as port_erasure
from minio_tpu_torch.object import poolmgr as poolmgr_mod
from minio_tpu_torch.object.poolmgr import CONFIG_FILE, DRAIN_FILE, DecommissionTracker, PoolManager, _read_sys
from minio_tpu_torch.object.pools import POOL_ACTIVE, POOL_DECOMMISSIONED, POOL_DRAINING, ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import DeleteObjectOptions, GetObjectOptions, PutObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors

MOD_TIME = 1_760_000_000.25
CLOCK = 1_760_000_100.5


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


def make_sets(tmp_path, pi: int, codec, n_disks: int = 4) -> ErasureSets:
    formats = fmt.init_format(1, n_disks)
    drives = []
    for i in range(n_disks):
        root = str(tmp_path / f"pool{pi}" / f"disk{i}")
        os.makedirs(root, exist_ok=True)
        formats[i].save(root)
        drives.append(LocalDrive(root))
    return ErasureSets.from_drives(drives, formats[0], codec=codec, pool_index=pi)


@pytest.fixture
def layer(tmp_path, codec):
    lp = ServerPools([make_sets(tmp_path, 0, codec), make_sets(tmp_path, 1, codec)])
    lp.make_bucket("bucket")
    return lp


# -- the cases of tests/test_poolmgr.py, on the port ---------------------------------------------


class TestThrottleBudget:
    def test_unlimited_never_sleeps(self):
        slept = []
        b = ThrottleBudget(bytes_per_s=0, ops_per_s=0, clock=lambda: 0.0, sleep=slept.append)
        for _ in range(10):
            assert b.consume(1 << 20) == 0.0
        assert slept == []
        assert b.throttle_waits == 0
        assert b.bytes == 10 << 20

    def test_bytes_budget_paces(self):
        now = [0.0]
        slept = []
        b = ThrottleBudget(bytes_per_s=1000, ops_per_s=0, clock=lambda: now[0], sleep=slept.append)
        assert b.consume(500) == 0.0
        assert b.consume(500) == pytest.approx(0.5)
        assert slept == [pytest.approx(0.5)]
        assert b.throttle_waits == 1
        assert b.throttled_seconds == pytest.approx(0.5)
        now[0] = 10.0
        assert b.consume(500) == 0.0

    def test_ops_budget_paces(self):
        now = [0.0]
        slept = []
        b = ThrottleBudget(bytes_per_s=0, ops_per_s=2, clock=lambda: now[0], sleep=slept.append)
        assert b.consume(0) == 0.0
        assert b.consume(0) == pytest.approx(0.5)
        assert b.ops == 2

    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv("MTPU_REBALANCE_BYTES_PER_S", "2048")
        monkeypatch.setenv("MTPU_REBALANCE_OPS_PER_S", "7")
        b = ThrottleBudget(clock=lambda: 0.0, sleep=lambda s: None)
        assert b.bytes_per_s == 2048.0
        assert b.ops_per_s == 7.0


class TestAttach:
    def test_attach_is_two_phase_and_persisted(self, tmp_path, layer, codec):
        pm = PoolManager(layer)
        idx = pm.attach(make_sets(tmp_path, 2, codec), endpoints=["/fake/ep"])
        assert idx == 2
        assert layer.statuses == [POOL_ACTIVE] * 3
        assert pm.epoch == 2
        doc = json.loads(_read_sys(layer, CONFIG_FILE).decode())
        assert doc["epoch"] == 2
        assert [p["status"] for p in doc["pools"]] == [POOL_ACTIVE] * 3
        assert doc["pools"][2]["endpoints"] == ["/fake/ep"]

    def test_attach_replicates_buckets(self, tmp_path, layer, codec):
        pm = PoolManager(layer)
        pm.attach(make_sets(tmp_path, 2, codec))
        assert layer.pools[2].get_bucket_info("bucket").name == "bucket"
        layer.pools[2].put_object("bucket", "landed", b"x")
        _, data = layer.get_object("bucket", "landed")
        assert data == b"x"

    def test_load_config_applies_newer_epoch(self, tmp_path, layer, codec):
        pm = PoolManager(layer)
        pm.attach(make_sets(tmp_path, 2, codec))
        layer.set_pool_status(2, POOL_DRAINING)
        pm._bump_epoch_and_fanout()
        pm2 = PoolManager(layer)
        assert pm2.load_config() is True
        assert pm2.epoch == 3
        assert layer.statuses[2] == POOL_DRAINING
        assert pm2.load_config() is False


class TestDecommission:
    def _fill(self, layer, n=12, prefix="obj"):
        for i in range(n):
            layer.pools[0].put_object("bucket", f"{prefix}-{i:03d}", f"payload-{i}".encode() * 8)

    def test_drain_moves_everything(self, layer):
        self._fill(layer, 12)
        pm = PoolManager(layer)
        pm.start_decommission(0, wait=True)
        tr = pm.trackers[0]
        assert tr.finished and not tr.failed
        assert tr.objects_moved == 12
        assert layer.statuses[0] == POOL_DECOMMISSIONED
        assert pm._pool_object_count(layer.pools[0]) == 0
        names = [o.name for o in layer.list_objects("bucket", max_keys=100).objects]
        assert len(names) == 12
        for i in range(12):
            _, data = layer.get_object("bucket", f"obj-{i:03d}")
            assert data == f"payload-{i}".encode() * 8

    def test_drain_preserves_versions_and_markers(self, layer):
        vids = []
        for i in range(3):
            oi = layer.pools[0].put_object("bucket", "ver", f"v{i}".encode(), PutObjectOptions(versioned=True))
            vids.append(oi.version_id)
        layer.pools[0].put_object("bucket", "gone", b"soon", PutObjectOptions(versioned=True))
        layer.pools[0].delete_object("bucket", "gone", DeleteObjectOptions(versioned=True))
        pm = PoolManager(layer)
        pm.start_decommission(0, wait=True)
        assert pm.trackers[0].finished
        for i, vid in enumerate(vids):
            _, data = layer.get_object("bucket", "ver", GetObjectOptions(version_id=vid))
            assert data == f"v{i}".encode()
        with pytest.raises(errors.ObjectError):
            layer.get_object("bucket", "gone")

    def test_cannot_drain_last_active_pool(self, layer):
        layer.set_pool_status(1, POOL_DRAINING)
        pm = PoolManager(layer)
        with pytest.raises(errors.InvalidArgument):
            pm.start_decommission(0)

    def test_double_drain_rejected(self, layer):
        self._fill(layer, 4)
        pm = PoolManager(layer)
        pm.start_decommission(0, wait=True)
        with pytest.raises(errors.InvalidArgument):
            pm.start_decommission(0)

    def test_drain_excluded_from_placement(self, layer):
        layer.set_pool_status(0, POOL_DRAINING)
        assert layer._pool_with_space() is layer.pools[1]


class _Killed(Exception):
    pass


class TestCrashResume:
    def test_kill_mid_drain_resumes_from_checkpoint(self, layer):
        n = 24
        for i in range(n):
            layer.pools[0].put_object("bucket", f"k-{i:03d}", b"d" * 64)
        pm = PoolManager(layer)
        kills = {"left": 2}

        def hook(tracker):
            kills["left"] -= 1
            if kills["left"] == 0:
                raise _Killed("node killed mid-drain")

        pm._drain_hook = hook
        pm.start_decommission(0, wait=True, checkpoint_every=4)
        tr1 = pm.trackers[0]
        assert not tr1.finished and "Killed" in tr1.failed
        moved_before = tr1.objects_moved
        assert 0 < moved_before < n
        assert layer.statuses[0] == POOL_DRAINING
        pm2 = PoolManager(layer)
        pm2.load_config()
        saved = DecommissionTracker.load(layer, 0)
        assert saved is not None and saved.resume_object
        assert saved.objects_moved == moved_before
        assert pm2.resume_pending() == [0]
        pm2.join()
        tr2 = pm2.trackers[0]
        assert tr2.finished and not tr2.failed
        assert tr2.objects_moved - saved.objects_moved == n - moved_before
        assert layer.statuses[0] == POOL_DECOMMISSIONED
        listing = layer.list_objects("bucket", max_keys=100).objects
        assert [o.name for o in listing] == [f"k-{i:03d}" for i in range(n)]
        for i in range(n):
            _, data = layer.get_object("bucket", f"k-{i:03d}")
            assert data == b"d" * 64
        assert pm2._pool_object_count(layer.pools[0]) == 0

    def test_resume_noop_when_nothing_draining(self, layer):
        pm = PoolManager(layer)
        assert pm.resume_pending() == []


class TestRebalance:
    def test_skew_converges_without_oscillation(self, tmp_path, layer, codec):
        for i in range(20):
            layer.pools[0].put_object("bucket", f"r-{i:03d}", b"z" * 256)
        pm = PoolManager(layer)
        pm.attach(make_sets(tmp_path, 2, codec))
        eng: RebalanceEngine = pm.rebalancer
        pm.start_rebalance(threshold=0.10)
        eng.join(60)
        assert not eng.running
        assert eng.objects_moved > 0
        assert max(eng._skews().values()) <= 0.10
        for i in range(20):
            _, data = layer.get_object("bucket", f"r-{i:03d}")
            assert data == b"z" * 256

    def test_balanced_cluster_is_noop(self, layer):
        pm = PoolManager(layer)
        eng = pm.rebalancer
        assert eng._round(0.10) == 0
        assert eng.objects_moved == 0


class TestStatusAndStats:
    def test_status_shape(self, layer):
        layer.pools[0].put_object("bucket", "one", b"x" * 100)
        pm = PoolManager(layer)
        st = pm.status()
        assert st["epoch"] == 0
        assert {"pools_attached", "objects_moved", "checkpoints"} <= set(st["stats"])
        assert len(st["pools"]) == 2
        row = st["pools"][0]
        assert row["status"] == POOL_ACTIVE
        assert row["capacity_bytes"] > 0
        assert row["objects"] >= 1

    def test_drain_progress_in_status(self, layer):
        for i in range(6):
            layer.pools[0].put_object("bucket", f"s-{i}", b"y" * 32)
        pm = PoolManager(layer)
        pm.start_decommission(0, wait=True)
        pm._gauge_cache.clear()
        row = pm.status()["pools"][0]
        assert row["status"] == POOL_DECOMMISSIONED
        assert row["drain"]["finished"] is True
        assert row["drain"]["objects_moved"] == 6

    def test_stats_count_what_the_metrics_render(self, layer):
        """The JAX case renders these counters as minio_tpu_pool_* series;
        the port's metrics wait for Queue A item 8.4, so the counters are
        held here, as the same snapshot the exposition reads."""
        layer.pools[0].put_object("bucket", "m-0", b"w" * 50)
        before = poolmgr_mod.STATS.snapshot()
        pm = PoolManager(layer)
        pm.start_decommission(0, wait=True)
        after = poolmgr_mod.STATS.snapshot()
        assert set(after) == set(jax_poolmgr.STATS.snapshot())
        assert after["decommissions_started"] - before["decommissions_started"] == 1
        assert after["decommissions_completed"] - before["decommissions_completed"] == 1
        assert after["objects_moved"] - before["objects_moved"] == 1
        assert after["epoch_bumps"] - before["epoch_bumps"] == 2
        assert pm.pool_gauges(0)["status"] == POOL_DECOMMISSIONED

    def test_tracker_roundtrip(self, layer):
        tr = DecommissionTracker(pool_index=0, started=1.0, objects_moved=7, resume_bucket="bucket",
                                 resume_object="k-5")
        tr.save(layer)
        back = DecommissionTracker.load(layer, 0)
        assert back is not None
        assert back.objects_moved == 7
        assert (back.resume_bucket, back.resume_object) == ("bucket", "k-5")
        assert DecommissionTracker.load(ServerPools([layer.pools[1]]), 0) is not None


def test_mover_raises_before_a_codec_is_installed(tmp_path, monkeypatch):
    """Sets built without codec= take the process default, which is the
    cuda codec and raises without a card: the mover does not start."""
    monkeypatch.setattr(codec_mod, "_default", None)
    layer = ServerPools([make_sets(tmp_path, 0, None), make_sets(tmp_path, 1, None)])
    with pytest.raises(RuntimeError):
        ObjectMover(layer, ThrottleBudget(clock=lambda: 0.0, sleep=lambda s: None))
    with pytest.raises(RuntimeError):
        rebalance_mod.require_codec(layer)


# -- against the JAX package --------------------------------------------------------------------

JAX = SimpleNamespace(name="jax", ServerPools=JaxServerPools, ErasureSets=JaxErasureSets, LocalDrive=JaxLocalDrive,
                      DriveFormat=jax_format.DriveFormat, Put=JaxPutObjectOptions, poolmgr=jax_poolmgr,
                      erasure=jax_erasure)
PORT = SimpleNamespace(name="port", ServerPools=ServerPools, ErasureSets=ErasureSets, LocalDrive=LocalDrive,
                       DriveFormat=fmt.DriveFormat, Put=PutObjectOptions, poolmgr=poolmgr_mod, erasure=port_erasure)
PKGS = (JAX, PORT)
N_POOLS, SET_DRIVES = 2, 4


def _objects() -> dict:
    """Seeded objects: inline ones of a few bytes to 20 KiB, two past the
    inline limit (part files), one reduced-redundancy."""
    rng = np.random.default_rng(1313)
    sizes = [int(s) for s in rng.integers(1, 20 << 10, 10)] + [150 << 10, 140 << 10]
    out = {f"obj-{i:03d}": rng.integers(0, 256, n, dtype=np.uint8).tobytes() for i, n in enumerate(sizes)}
    out["rrs-000"] = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    return out


OBJECTS = _objects()


def _uuids(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: uuid.UUID(bytes=rng.integers(0, 256, 16, dtype=np.uint8).tobytes(), version=4)


class _Clock:
    """The time module as poolmgr sees it, with time() pinned."""

    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


class Twins:
    """The same N_POOLS pools in both packages (the same format.json on
    every drive). Each package's layer starts with pool 0 alone, filled
    with OBJECTS under a pinned clock and uuid4; the other pools are
    attached by the cases."""

    def __init__(self, root: str, codec, mp):
        self.mp = mp
        formats = [jax_format.init_format(1, SET_DRIVES) for _ in range(N_POOLS)]
        self.dirs = {}
        self.layers = {}
        self.codecs = {"jax": JaxHostCodec(), "port": codec}
        for pkg in PKGS:
            self.dirs[pkg.name] = []
            for p in range(N_POOLS):
                dirs = []
                for i, f in enumerate(formats[p]):
                    d = os.path.join(root, pkg.name, f"pool{p}", f"d{i}")
                    os.makedirs(d)
                    f.save(d)
                    dirs.append(d)
                self.dirs[pkg.name].append(dirs)
            layer = self.layers[pkg.name] = self.open(pkg, pkg.name, 1)
            layer.make_bucket("bucket")
            for i, (name, data) in enumerate(OBJECTS.items()):
                with self.pinned(pkg, 100 + i, MOD_TIME + i):
                    sc = "REDUCED_REDUNDANCY" if name.startswith("rrs") else ""
                    layer.pools[0].put_object("bucket", name, data, pkg.Put(storage_class=sc))

    def sets(self, pkg, dirs_of: str, p: int):
        """pkg's ErasureSets over pool p's drive directories of package dirs_of."""
        dirs = self.dirs[dirs_of][p]
        return pkg.ErasureSets.from_drives([pkg.LocalDrive(d) for d in dirs], pkg.DriveFormat.load(dirs[0]),
                                           codec=self.codecs[pkg.name], pool_index=p)

    def open(self, pkg, dirs_of: str, n_pools: int):
        return pkg.ServerPools([self.sets(pkg, dirs_of, p) for p in range(n_pools)])

    @contextlib.contextmanager
    def pinned(self, pkg, seed: int, mod_time: float):
        with self.mp.context() as m:
            m.setattr(pkg.erasure, "now", lambda: mod_time)
            m.setattr(uuid, "uuid4", _uuids(seed))
            m.setattr(pkg.poolmgr, "time", _Clock(CLOCK))
            yield


def _tree(dirs: list, bucket: str = "bucket") -> dict:
    out = {}
    for i, d in enumerate(dirs):
        base = os.path.join(d, bucket)
        for dirpath, _, files in os.walk(base):
            for f in files:
                full = os.path.join(dirpath, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, base))] = fh.read()
    return out


def _sys_file(dirs: list, name: str) -> bytes:
    with open(os.path.join(dirs[0], fmt.SYS_DIR, name), "rb") as fh:
        return fh.read()


@pytest.fixture
def twins(tmp_path, codec, monkeypatch):
    monkeypatch.setenv("MTPU_DECOM_WORKERS", "1")  # one mover: the uuid4 sequence is in walk order
    return Twins(str(tmp_path), codec, monkeypatch)


def _attach(twins, pkg, pm) -> None:
    with twins.pinned(pkg, 400, MOD_TIME + 50):
        assert pm.attach(twins.sets(pkg, pkg.name, 1), endpoints=["/pool1/ep{1...4}"]) == 1


def _attach_and_drain(twins, pkg):
    pm = pkg.poolmgr.PoolManager(twins.layers[pkg.name])
    _attach(twins, pkg, pm)
    with twins.pinned(pkg, 500, MOD_TIME + 100):
        pm.start_decommission(0, wait=True)
    return pm


def test_pool_config_and_checkpoint_bytes_equal(twins):
    out = {}
    for pkg in PKGS:
        pm = _attach_and_drain(twins, pkg)
        assert pm.trackers[0].finished and pm.trackers[0].objects_moved == len(OBJECTS)
        dirs = twins.dirs[pkg.name]
        out[pkg.name] = (_sys_file(dirs[1], jax_poolmgr.CONFIG_FILE), _sys_file(dirs[1], DRAIN_FILE.format(0)))
    assert out["port"] == out["jax"]
    doc = json.loads(out["port"][0])
    assert doc["pools"] == [{"endpoints": None, "status": "decommissioned"},
                            {"endpoints": ["/pool1/ep{1...4}"], "status": "active"}]
    assert json.loads(out["port"][1])["last_update"] == CLOCK


def test_drained_objects_on_the_target_pool_equal_the_jax_drain(twins):
    for pkg in PKGS:
        _attach_and_drain(twins, pkg)
    jax_tree, port_tree = (_tree(twins.dirs[n][1]) for n in ("jax", "port"))
    assert sorted(port_tree) == sorted(jax_tree)
    assert any(k[1].endswith("/part.1") for k in port_tree)
    for k in jax_tree:
        assert port_tree[k] == jax_tree[k], k
    for n in ("jax", "port"):
        assert not [k for k in _tree(twins.dirs[n][0]) if k[1].endswith("xl.meta")]
    for name, data in OBJECTS.items():
        assert twins.layers["port"].get_object("bucket", name)[1] == data


@pytest.mark.parametrize("killer,resumer", [("jax", "port"), ("port", "jax")])
def test_each_package_resumes_the_others_checkpoint(twins, killer, resumer):
    """A drain killed after two move batches in one package; the other
    package, over the same drives, loads the persisted config and resumes
    from the checkpointed cursor."""
    pk = {"jax": JAX, "port": PORT}
    layer = twins.layers[killer]
    pm = pk[killer].poolmgr.PoolManager(layer)
    _attach(twins, pk[killer], pm)
    kills = {"left": 2}

    def hook(tracker):
        kills["left"] -= 1
        if kills["left"] == 0:
            raise _Killed("node killed mid-drain")

    pm._drain_hook = hook
    pm.start_decommission(0, wait=True, checkpoint_every=1)
    moved = pm.trackers[0].objects_moved
    assert 0 < moved < len(OBJECTS) and not pm.trackers[0].finished
    other = twins.open(pk[resumer], killer, 2)
    pm2 = pk[resumer].poolmgr.PoolManager(other)
    assert pm2.load_config() is True
    assert other.statuses[0] == POOL_DRAINING
    saved = pk[resumer].poolmgr.DecommissionTracker.load(other, 0)
    assert saved.objects_moved == moved and saved.resume_object
    assert pm2.resume_pending() == [0]
    pm2.join()
    tr = pm2.trackers[0]
    assert tr.finished and not tr.failed
    assert tr.objects_moved == len(OBJECTS)
    assert other.statuses[0] == POOL_DECOMMISSIONED
    for name, data in OBJECTS.items():
        assert other.get_object("bucket", name)[1] == data
    assert not [k for k in _tree(twins.dirs[killer][0]) if k[1].endswith("xl.meta")]


def test_rebalance_ends_at_the_same_per_pool_counts(twins):
    counts = {}
    for pkg in PKGS:
        pm = pkg.poolmgr.PoolManager(twins.layers[pkg.name])
        _attach(twins, pkg, pm)
        eng = pm.rebalancer
        with twins.pinned(pkg, 700, MOD_TIME + 200):
            eng.start(threshold=0.10)
            eng.join(120)
        assert not eng.running and eng.objects_moved > 0
        counts[pkg.name] = [sum(1 for k in _tree(twins.dirs[pkg.name][p]) if k[0] == 0 and k[1].endswith("xl.meta"))
                            for p in range(N_POOLS)]
        assert sum(counts[pkg.name]) == len(OBJECTS)
        assert max(eng._skews().values()) <= 0.10
    assert counts["port"] == counts["jax"]
    for name, data in OBJECTS.items():
        assert twins.layers["port"].get_object("bucket", name)[1] == data
