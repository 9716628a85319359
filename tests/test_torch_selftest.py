"""The live self-measurement probes of minio_tpu_torch on the CPU
(control/selftest.py), held against the JAX package's.

The autotune ramp takes the same steps for the same round scores in both
packages. Then each package gets the same deployment (one 4-drive set, the
same format.json; the port on BatchingDeviceCodec(device="cpu"), the JAX
package on its HostCodec) and runs the object speedtest, the drive probe and
a netperf with no peers: the reports have the same keys and shapes, the
numbers being each run's own, and both leave the `.mtpu-speedtest` scratch
bucket off every drive. The port's plain hash costs ~1.3 s per 64 KiB
PUT+GET on the CPU, so the object speedtest here runs one ramp step (64 KiB
objects, concurrency 1); the full default ramp runs on the card
(chip_smoke.py phase 12). Tolerance: exact for the ramp and the keys.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from minio_tpu.control import selftest as jax_selftest
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.control import selftest
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage import recovery
from minio_tpu_torch.storage.local import LocalDrive

PKGS = {"jax": jax_selftest, "port": selftest}
KiB = 1024


def kind(value):
    """A JSON value's shape: dict keys and list lengths kept, numbers by type."""
    if isinstance(value, dict):
        return {k: kind(v) for k, v in value.items()}
    if isinstance(value, list):
        return [kind(v) for v in value]
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float)):
        return "number"
    return type(value).__name__


def _scores(seed: int) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(x) for x in np.cumsum(rng.random(8) * rng.choice([-1, 1, 1], 8)) + 10]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("start,max_c", [(4, 32), (1, 8), (3, 3)])
def test_autotune_ramp_equal(seed, start, max_c):
    scores = _scores(seed)
    got = {}
    for name, mod in PKGS.items():
        seen = []

        def round_fn(c, seen=seen):
            seen.append(c)
            return {"score": scores[len(seen) - 1], "c2": c * 2}

        best, ramp = mod.autotune(round_fn, start=start, max_concurrency=max_c)
        got[name] = (best, ramp, seen)
    assert got["port"] == got["jax"]


def test_scratch_bucket_name_matches_recovery_sweep():
    assert selftest.SCRATCH_BUCKET == jax_selftest.SCRATCH_BUCKET == recovery._SELFTEST_BUCKET


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("selftest"))
    formats = jax_format.init_format(1, 4)
    codec = BatchingDeviceCodec(device="cpu")
    sides = {
        "jax": (JaxLocalDrive, jax_format.DriveFormat, JaxErasureSets, JaxServerPools, JaxHostCodec()),
        "port": (LocalDrive, port_format.DriveFormat, ErasureSets, ServerPools, codec),
    }
    out = {}
    try:
        for name, (LD, DF, ES, SP, c) in sides.items():
            dirs = []
            for i, f in enumerate(formats):
                d = os.path.join(root, name, f"d{i}")
                os.makedirs(d)
                f.save(d)
                dirs.append(d)
            drives = [LD(d) for d in dirs]
            layer = SP([ES.from_drives(drives, DF.load(dirs[0]), codec=c, pool_index=0)])
            mod = PKGS[name]
            runs0 = mod.STATS.snapshot()
            obj = mod.object_speedtest(layer, node_url="local", size=64 * KiB, start=1, max_concurrency=1)
            drive = mod.drive_probe({d: LD(d) for d in dirs[:2]}, size=64 * KiB, files=2, rand_reads=4)
            net = mod.netperf([], node_url="local", size=64 * KiB, rounds=1)
            round_ = mod.run_object_round(layer, 64 * KiB, 2, 2, tag="t")
            mod.cleanup_scratch(layer)
            out[name] = {
                "object": obj, "drive": drive, "net": net, "round": round_,
                "last": {k: mod.last_result(k) for k in ("object", "drive", "net")},
                "stats": {k: v - runs0[k] for k, v in mod.STATS.snapshot().items()},
                "debris": [d for d in dirs if os.path.exists(os.path.join(d, selftest.SCRATCH_BUCKET))],
                "buckets": [b.name for b in layer.list_buckets()],
            }
        yield out
    finally:
        codec.close()


@pytest.mark.parametrize("probe", ["object", "drive", "net", "round"])
def test_report_has_the_jax_shape(probed, probe):
    j, p = probed["jax"][probe], probed["port"][probe]
    if probe == "drive":  # keyed by drive path
        j, p = list(j["drives"].values()), list(p["drives"].values())
    assert kind(p) == kind(j)
    if probe != "round":
        assert (p if probe == "drive" else p["ok"]) and (j if probe == "drive" else j["ok"])


def test_object_report_ramp_and_nodes(probed):
    p = probed["port"]["object"]
    assert p["probe"] == "object" and p["size"] == 64 * KiB and p["concurrency"] == 1
    assert [r["concurrency"] for r in p["ramp"]] == [1]
    assert list(p["nodes"]) == ["local"] and p["nodes"]["local"]["ok"]
    assert p["scaling"]["nodes"] == 1 and p["aggregate"]["total_ops_per_s"] > 0


def test_probes_store_their_last_result(probed):
    for name in ("jax", "port"):
        last = probed[name]["last"]
        assert last["object"] == probed[name]["object"] and last["drive"] == probed[name]["drive"]
        assert last["net"] == probed[name]["net"]
    assert probed["port"]["stats"] == probed["jax"]["stats"] == {
        "object_runs": 1, "drive_runs": 1, "net_runs": 1, "probe_failures": 0, "scratch_cleanups": 2}


def test_probes_leave_no_scratch_bucket(probed):
    for name in ("jax", "port"):
        assert probed[name]["debris"] == [] and probed[name]["buckets"] == []
