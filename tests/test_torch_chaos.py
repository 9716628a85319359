"""The fault plane of minio_tpu_torch on the CPU, held against the JAX package.

Both packages get the same deployment (one 8-drive 6+2 erasure set on the
same format.json) and the same faults: minio_tpu_torch's ErasureObjects on
its BatchingDeviceCodec (device="cpu", the kernels' plain torch versions),
the JAX package's on its HostCodec. Each package has its own fault and
crash registries, armed with equal specs.

What is compared, and how exactly:
  * FaultRegistry: the fired/skipped pattern of a seeded schedule, exact.
  * FaultyDisk, each kind: the error type a faulted call raises, the
    outcome of a PUT, and the bytes at rest afterwards, exact.
  * CircuitBreaker: the state after every step of a seeded outcome
    schedule (an injected clock, no probe thread), exact.
  * Crash points: every KNOWN_POINTS entry armed in ``raise`` mode (the
    in-process stand-in for death) and the torn point in ``torn`` mode fire
    in both packages, with the same outcome; then recover_drive on every
    drive and recover_set hand heal the same versions, and after heal the
    two drive trees are equal. Trees are compared by path with the random
    names (data dirs, upload ids, stage ids) replaced by their order of
    appearance, part files by bytes, xl.meta by its erasure fields (mod
    times and version ids are random in each package).
  * MTPU_TSAN=1 / MTPU_BUFSAN=1: a small PUT/GET workload in a fresh
    interpreter per package reports the same findings (none); a seeded lock
    inversion and a seeded write-after-release are reported in both.

Sizes: 130 KiB objects (the streaming path starts at 128 KiB), so a shard
row is ~22 KiB and the port's plain hash takes ~0.6 s per call. The
multipart cases lower MIN_PART_SIZE in both packages to 1 byte so a part
need not be 5 MiB; the crash points do not depend on part size.

The ``cuda`` cases run the same faults on the card: a bitrot shard caught by
the hash kernel and rebuilt by the RS kernel, and a GET through two open
breakers. They skip here.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from minio_tpu.chaos import crash as jax_crash
from minio_tpu.chaos import faults as jax_faults
from minio_tpu.chaos.disk import FaultyDisk as JaxFaultyDisk
from minio_tpu.control import bufsan as jax_bufsan
from minio_tpu.control import sanitizer as jax_san
from minio_tpu.object import multipart as jax_multipart
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.storage import breaker as jax_breaker
from minio_tpu.storage import format as jax_format
from minio_tpu.storage import recovery as jax_recovery
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu.storage.xlmeta import XLMeta as JaxXLMeta
from minio_tpu.utils import errors as jax_errors
from minio_tpu.utils.bufpool import BufferPool as JaxBufferPool
from minio_tpu_torch.chaos import crash, faults
from minio_tpu_torch.chaos.disk import FaultyDisk
from minio_tpu_torch.control import bufsan, sanitizer
from minio_tpu_torch.object import multipart
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import breaker, recovery
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.storage.metered import MeteredDrive
from minio_tpu_torch.utils import errors
from minio_tpu_torch.utils.bufpool import BufferPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVES, PARITY = 8, 2
BUCKET = "bkt"
SIZE = 130 << 10
SYS = ".minio_tpu.sys"


def _payload(seed: int, n: int = SIZE) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _drives(root, fmt_mod, drive_cls, wrap=None):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drive = drive_cls(d)
        drives.append(wrap(drive) if wrap is not None else drive)
    return drives


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(autouse=True)
def _disarmed():
    for reg in (crash.REGISTRY, jax_crash.REGISTRY, faults.REGISTRY, jax_faults.REGISTRY):
        reg.disarm_all()
    yield
    for reg in (crash.REGISTRY, jax_crash.REGISTRY, faults.REGISTRY, jax_faults.REGISTRY):
        reg.disarm_all()


@pytest.fixture
def small_parts(monkeypatch):
    monkeypatch.setattr(multipart, "MIN_PART_SIZE", 1)
    monkeypatch.setattr(jax_multipart, "MIN_PART_SIZE", 1)


class Pair:
    """The same 8-drive set in both packages, optionally behind a wrapper."""

    def __init__(self, root, codec, port_wrap=None, jax_wrap=None):
        self.port_drives = _drives(os.path.join(root, "port"), port_format, LocalDrive, port_wrap)
        self.jax_drives = _drives(os.path.join(root, "jax"), jax_format, JaxLocalDrive, jax_wrap)
        self.port = ErasureObjects(self.port_drives, parity=PARITY, codec=codec)
        self.ref = JaxErasureObjects(self.jax_drives, parity=PARITY, codec=JaxHostCodec())
        self.port.make_bucket(BUCKET)
        self.ref.make_bucket(BUCKET)

    def both(self, fn):
        """fn(eo) on both sets -> ((port result, port error), (jax result, jax error))."""
        out = []
        for eo in (self.port, self.ref):
            try:
                out.append((fn(eo), None))
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                out.append((None, e))
        return out


_RANDOM_NAME = re.compile(
    r"(\d+\.)?[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"
    r"|\d+\.[0-9a-f]{8,}|[0-9a-f]{16,}"
)


def _tree(root: str) -> dict:
    """Normalized drive tree: relative path (random names replaced by their
    order of appearance) -> part bytes, xl.meta erasure fields, or None for
    other files. Bucket metadata and format.json carry timestamps and ids;
    their presence is compared, not their bytes."""
    names: dict[str, str] = {}

    def norm(rel: str) -> str:
        def sub(m):
            return names.setdefault(m.group(0), f"<{len(names)}>")

        return _RANDOM_NAME.sub(sub, rel)

    out = {}
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        rel_dir = os.path.relpath(dirpath, root)
        if not filenames and not dirnames:
            out[norm(rel_dir) + "/"] = None
        for fn in sorted(filenames):
            rel = os.path.normpath(os.path.join(rel_dir, fn))
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                raw = f.read()
            if fn == "xl.meta" and not rel.startswith(SYS):
                meta = JaxXLMeta.from_bytes(raw)
                val = [
                    (v.erasure.data_blocks, v.erasure.parity_blocks, v.erasure.index,
                     list(v.erasure.distribution), v.size, v.deleted, bool(v.data_dir),
                     bytes(v.inline_data or b""), [(p_.number, p_.size) for p_ in v.parts])
                    for v in meta.versions
                ]
            elif fn.startswith("part.") and not fn.endswith(".meta"):
                val = raw
            else:
                val = None
            out[norm(rel)] = val
    return out


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _orphan_stage_names(root: str, dead: int) -> int:
    """Rename this process's pid-scoped stage names to a dead pid's: the
    debris a process that died at the crash point leaves (raise mode runs
    in-process, and the scan keeps a live owner's stage files)."""
    me = str(os.getpid())
    n = 0
    for dirpath, dirnames, filenames in os.walk(root, topdown=False):
        for name in dirnames + filenames:
            new = None
            if name.startswith(me + "."):
                new = f"{dead}." + name[len(me) + 1:]
            elif f".tmp.{me}." in name:
                new = name.replace(f".tmp.{me}.", f".tmp.{dead}.")
            if new is not None:
                os.rename(os.path.join(dirpath, name), os.path.join(dirpath, new))
                n += 1
    return n


def _assert_trees_equal(pair):
    for i in range(DRIVES):
        port_root = pair.port_drives[i].endpoint()
        jax_root = pair.jax_drives[i].endpoint()
        assert _tree(port_root) == _tree(jax_root), f"drive {i}"


# -- FaultRegistry ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,prob", [(0, 0.5), (11, 0.37), (2024, 0.9)])
def test_fault_registry_seeded_pattern_matches(seed, prob):
    """A fixed seed replays the same fired/skipped pattern in both packages,
    with the same budget and counters."""
    regs = (faults.FaultRegistry(), jax_faults.FaultRegistry())
    specs = (faults.FaultSpec, jax_faults.FaultSpec)
    patterns = []
    for reg, spec_cls in zip(regs, specs):
        reg.arm(spec_cls(kind="drive-error", target="d3", probability=prob, count=40, seed=seed))
        pat = []
        for i in range(200):
            ep = f"/x/d{i % 8}"
            pat.append(reg.match_disk(ep, "read_file", BUCKET, "o") is not None)
        patterns.append((pat, reg.injected_counts(), [a["remaining"] for a in reg.list()]))
    assert patterns[0] == patterns[1]
    assert 0 < sum(patterns[0][0]) <= 40


# -- FaultyDisk ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,ops",
    [
        ("drive-error", ("append_iov", "rename_data")),
        ("drive-hang", ("append_iov",)),
        ("drive-latency", ("append_iov",)),
        ("bitrot", ()),
    ],
)
def test_faulty_disk_kinds_match(tmp_path, codec, kind, ops):
    """Each FaultyDisk kind on drive 3 of both stacks: the same error from a
    faulted call, the same PUT outcome, the same bytes at rest."""
    regs = (faults.FaultRegistry(), jax_faults.FaultRegistry())
    pair = Pair(
        str(tmp_path), codec,
        port_wrap=lambda d: FaultyDisk(d, regs[0]),
        jax_wrap=lambda d: JaxFaultyDisk(d, regs[1]),
    )
    target = os.sep + "d3"
    for reg, spec_cls in zip(regs, (faults.FaultSpec, jax_faults.FaultSpec)):
        reg.arm(spec_cls(kind=kind, target=target, ops=ops, delay_ms=20.0, seed=5))
    data = _payload(3)
    (p_res, p_err), (j_res, j_err) = pair.both(lambda eo: eo.put_object(BUCKET, "obj", data))
    assert (p_err is None) == (j_err is None)
    assert p_res.size == j_res.size == len(data)
    # A direct faulted call raises the same error type in both packages.
    if kind in ("drive-error", "drive-hang"):
        errs = []
        for d in (pair.port_drives[3], pair.jax_drives[3]):
            with pytest.raises(Exception) as ei:
                d.append_iov(BUCKET, "probe", [b"x"])
            errs.append(type(ei.value).__name__)
        assert errs[0] == errs[1] == "FaultyDisk"
    counts = [reg.injected_counts() for reg in regs]
    assert counts[0] == counts[1] and counts[0]
    for reg in regs:
        reg.disarm_all()
    _assert_trees_equal(pair)
    (p_res, p_err), (j_res, j_err) = pair.both(lambda eo: eo.get_object(BUCKET, "obj")[1])
    assert p_err is None and j_err is None
    assert p_res == j_res == data


# -- CircuitBreaker --------------------------------------------------------------------


def test_breaker_walks_the_same_states():
    """A seeded schedule of outcomes and latencies walks both breakers through
    the same states; time comes from an injected clock and no probe thread
    runs (probe=None), so reset() is the close path."""
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(300):
        r = rng.random()
        steps.append(("ok" if r < 0.55 else "err" if r < 0.9 else "notfound", float(rng.integers(1, 80)), r < 0.03))
    walks = []
    for mod, errs in ((breaker, errors), (jax_breaker, jax_errors)):
        now = [0.0]
        br = mod.CircuitBreaker(
            name="d0", error_threshold=5, latency_limit_ms=60.0, latency_min_samples=8,
            probe=None, clock=lambda: now[0],
        )
        walk = []
        for outcome, ms, reset in steps:
            now[0] += ms / 1e3
            if outcome == "ok":
                br.record_success(ms)
            elif outcome == "err":
                br.record_error(errs.FaultyDisk("x"), ms)
            else:
                br.record_error(errs.FileNotFound(), ms)
            if reset:
                br.reset()
            walk.append((br.snapshot(), br.allows()))
        walks.append(walk)
    assert walks[0] == walks[1]
    states = {w[0]["state"] for w in walks[0]}
    assert states >= {"closed", "open"}


# -- crash points ----------------------------------------------------------------------


def _arm_both(point, mode="raise", target="", skip=0, seed=0):
    crash.REGISTRY.arm(crash.CrashSpec(point=point, mode=mode, target=target, skip=skip, seed=seed))
    jax_crash.REGISTRY.arm(jax_crash.CrashSpec(point=point, mode=mode, target=target, skip=skip, seed=seed))


def _multipart(eo, key, parts):
    mp = eo.multipart
    uid = mp.new_multipart_upload(BUCKET, key)
    done = []
    for n, data in enumerate(parts, 1):
        done.append((n, mp.put_object_part(BUCKET, key, uid, n, data).etag))
    return mp.complete_multipart_upload(BUCKET, key, uid, done)


# (point, target drive or None, operation)
POINTS = [
    ("put.after-stage", None, "put"),
    ("put.before-commit", None, "put"),
    ("put.mid-commit", 2, "put"),
    ("put.after-commit", None, "put"),
    ("multipart.part.staged", None, "multipart"),
    ("multipart.part.published", 4, "multipart"),
    ("multipart.complete.mid-rename", 1, "multipart"),
    ("multipart.complete.partial", 6, "multipart"),
    ("storage.rename-data.pre-meta", 5, "put"),
    ("storage.xlmeta.pre-replace", 0, "put"),
    ("storage.append-iov.torn", 7, "put"),
]


def test_points_cover_known_points():
    assert sorted(p for p, _, _ in POINTS) == sorted(crash.KNOWN_POINTS)
    assert crash.KNOWN_POINTS == jax_crash.KNOWN_POINTS


@pytest.mark.parametrize("point,drive,op", POINTS, ids=[p for p, _, _ in POINTS])
def test_crash_point_fires_and_recovers_alike(tmp_path, codec, small_parts, point, drive, op):
    """The point fires in both packages with the same outcome; the restart
    scan then leaves the same debris-free trees and hands heal the same
    versions; after heal the trees are equal and the object reads back
    whole in both, or is absent in both."""
    pair = Pair(str(tmp_path), codec)
    target = "" if drive is None else os.sep + f"d{drive}"
    mode = "torn" if point in crash.TORN_POINTS else "raise"
    _arm_both(point, mode=mode, target=target, seed=17)
    key = "victim"
    if op == "put":
        data = _payload(21)
        outcomes = pair.both(lambda eo: eo.put_object(BUCKET, key, data))
    else:
        parts = [_payload(22, 140 << 10), _payload(23, 5000)]
        data = b"".join(parts)
        outcomes = pair.both(lambda eo: _multipart(eo, key, parts))
    (p_res, p_err), (j_res, j_err) = outcomes
    assert type(p_err).__name__ == type(j_err).__name__, (p_err, j_err)
    assert crash.REGISTRY.fired_counts() == jax_crash.REGISTRY.fired_counts()
    assert crash.REGISTRY.fired_counts().get(point, 0) >= 1
    crash.REGISTRY.disarm_all()
    jax_crash.REGISTRY.disarm_all()

    dead = _dead_pid()
    for d in pair.port_drives + pair.jax_drives:
        _orphan_stage_names(d.endpoint(), dead)
    deltas, healed = [], []
    for eo, drives, rec in (
        (pair.port, pair.port_drives, recovery),
        (pair.ref, pair.jax_drives, jax_recovery),
    ):
        rec.reset_counters()
        scans = [rec.recover_drive(d) for d in drives]
        got = []
        delta = rec.recover_set(eo, heal=lambda b, o, v: got.append((b, o)))
        deltas.append((scans, delta))
        healed.append(sorted(got))
        for b, o in got:
            eo.heal_object(b, o)
    assert deltas[0] == deltas[1]
    assert healed[0] == healed[1]
    if mode == "torn":
        # The torn shard is silent at rest: the GET's bitrot check drops it,
        # then heal rewrites it.
        for eo in (pair.port, pair.ref):
            assert eo.get_object(BUCKET, key)[1] == data
            eo.heal_object(BUCKET, key)
    _assert_trees_equal(pair)
    reads = pair.both(lambda eo: eo.get_object(BUCKET, key)[1])
    (p_get, p_gerr), (j_get, j_gerr) = reads
    assert type(p_gerr).__name__ == type(j_gerr).__name__
    assert p_get == j_get
    assert p_get is None or p_get == data
    # No stage debris is left on any drive.
    for d in pair.port_drives:
        tmp = os.path.join(d.endpoint(), SYS, "tmp")
        assert not (os.path.isdir(tmp) and os.listdir(tmp))
        for dirpath, _, files in os.walk(d.endpoint()):
            assert not [f for f in files if re.search(r"\.tmp[0-9a-f]{8}$|\.tmp\.\d+\.", f)]
        assert _orphan_stage_names(d.endpoint(), dead) == 0


def test_recovery_sweeps_the_staging_of_a_config_object(tmp_path, codec):
    """A process killed mid-commit of a config-store object (the scanner's
    usage, the tier journal, IAM: objects of the meta bucket) leaves that
    xl.meta's staging file on the drives whose replace it had not reached.
    The port's restart scan removes it; the JAX package's walks the user
    buckets only and leaves it (a departure: ROADMAP, Queue C item 10). The
    raise mode here stops the one drive's commit where the kill stops the
    process."""
    pair = Pair(str(tmp_path), codec)
    _arm_both("storage.xlmeta.pre-replace", mode="raise", target=os.sep + "d2", seed=5)
    outcomes = pair.both(lambda eo: eo.put_object(SYS, "scanner/data-usage.json", b'{"usage": 1}' * 40))
    assert [err for _, err in outcomes] == [None, None]  # write quorum without drive 2
    crash.REGISTRY.disarm_all()
    jax_crash.REGISTRY.disarm_all()

    def staged(drive) -> list:
        obj = os.path.join(drive.endpoint(), SYS, "scanner", "data-usage.json")
        return [f for f in os.listdir(obj) if re.search(r"\.tmp[0-9a-f]{8}$", f)]

    assert len(staged(pair.port_drives[2])) == len(staged(pair.jax_drives[2])) == 1
    recovery.reset_counters()
    jax_recovery.reset_counters()
    assert recovery.recover_drive(pair.port_drives[2])["tmp_files"] == 1
    assert jax_recovery.recover_drive(pair.jax_drives[2])["tmp_files"] == 0
    assert staged(pair.port_drives[2]) == [] and len(staged(pair.jax_drives[2])) == 1
    assert pair.port.get_object(SYS, "scanner/data-usage.json")[1] == b'{"usage": 1}' * 40


@pytest.mark.parametrize("volume", [SYS, BUCKET])
def test_recovery_leaves_a_live_writes_staging_file(tmp_path, volume):
    """A restart scan runs while siblings write (a pre-fork worker's
    respawn, a rejoining node whose storage REST already serves). A staging
    file written just before the scan belongs to a live write: the scan
    leaves it, and its writer's replace goes through, while a dead process's
    staging file beside it, unchanged for STAGING_GRACE_S, goes."""
    import threading
    import time

    formats = port_format.init_format(1, 1)
    path = str(tmp_path / "d0")
    os.makedirs(path)
    formats[0].save(path)
    drive = LocalDrive(path)
    drive.make_vol(BUCKET)
    obj = os.path.join(drive._vol_path(volume), "cfg", "doc.json")
    os.makedirs(obj)
    live = os.path.join(obj, "xl.meta.tmp0123abcd")
    dead = os.path.join(obj, "old.meta.tmpdeadbeef")
    for p in (live, dead):
        with open(p, "wb") as f:
            f.write(b"staged")
    old = time.time() - recovery.STAGING_GRACE_S - 1
    os.utime(dead, (old, old))
    replaced = []

    def writer():
        time.sleep(0.5)  # the scan is watching the live file by now
        os.replace(live, os.path.join(obj, "xl.meta"))
        replaced.append(True)

    t = threading.Thread(target=writer)
    t.start()
    recovery.reset_counters()
    t0 = time.monotonic()
    got = recovery.recover_drive(drive)
    t.join()
    assert replaced == [True]
    assert got["tmp_files"] == 1
    assert sorted(os.listdir(obj)) == ["xl.meta"]
    with open(os.path.join(obj, "xl.meta"), "rb") as f:
        assert f.read() == b"staged"
    assert time.monotonic() - t0 < recovery.STAGING_GRACE_S


def test_recovery_waits_out_a_young_dead_staging_file(tmp_path, monkeypatch):
    """A boot right after a crash finds the dead process's staging file a
    moment old: the scan watches it until it has sat unchanged for
    STAGING_GRACE_S, then removes it, and the prefix dir it leaves empty."""
    import time

    monkeypatch.setattr(recovery, "STAGING_GRACE_S", 1.0)
    formats = port_format.init_format(1, 1)
    path = str(tmp_path / "d0")
    os.makedirs(path)
    formats[0].save(path)
    drive = LocalDrive(path)
    drive.make_vol(BUCKET)
    obj = os.path.join(drive._vol_path(BUCKET), "pre", "victim")
    os.makedirs(obj)
    with open(os.path.join(obj, "xl.meta.tmp0badcafe"), "wb") as f:
        f.write(b"staged")
    recovery.reset_counters()
    t0 = time.monotonic()
    assert recovery.recover_drive(drive)["tmp_files"] == 1
    assert 0.9 <= time.monotonic() - t0 < 5
    assert os.listdir(drive._vol_path(BUCKET)) == []


def test_arm_from_env_parses_alike():
    env = {"MTPU_CRASH": "put.mid-commit:kill:8,multipart.complete.partial:raise:0:3"}
    got = []
    for mod in (crash, jax_crash):
        mod.REGISTRY.disarm_all()
        mod.arm_from_env(env)
        got.append(sorted(
            (d["point"], d["mode"], d["skip"], d["seed"]) for d in mod.REGISTRY.list()
        ))
    assert got[0] == got[1] == [
        ("multipart.complete.partial", "raise", 0, 3),
        ("put.mid-commit", "kill", 8, 0),
    ]


# -- sanitizers ------------------------------------------------------------------------


_WORKLOAD = textwrap.dedent(
    """
    import json, os, sys, tempfile
    import numpy as np
    pkg = sys.argv[1]
    if pkg == "port":
        from minio_tpu_torch.control import bufsan, sanitizer
        from minio_tpu_torch.object.erasure import ErasureObjects
        from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
        from minio_tpu_torch.storage import format as fmt
        from minio_tpu_torch.storage.local import LocalDrive
        codec = BatchingDeviceCodec(device="cpu")
    else:
        from minio_tpu.control import bufsan, sanitizer
        from minio_tpu.object.codec import HostCodec
        from minio_tpu.object.erasure import ErasureObjects
        from minio_tpu.storage import format as fmt
        from minio_tpu.storage.local import LocalDrive
        codec = HostCodec()
    root = tempfile.mkdtemp()
    drives = []
    for i, f in enumerate(fmt.init_format(1, 4)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    eo = ErasureObjects(drives, parity=2, codec=codec)
    eo.make_bucket("bkt")
    rng = np.random.default_rng(3)
    objs = {"small": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            "stream": rng.integers(0, 256, 130 << 10, dtype=np.uint8).tobytes()}
    for k, v in objs.items():
        eo.put_object("bkt", k, v)
    for k, v in objs.items():
        assert eo.get_object("bkt", k)[1] == v
    if hasattr(codec, "close"):
        codec.close()
    san = sanitizer.GLOBAL_SAN.report()
    buf = bufsan.ACTIVE.report()
    print(json.dumps({
        "tsan": sorted(f["rule"] for f in san["findings"] if "suppressed" not in f),
        "bufsan": sorted(f["rule"] for f in buf["findings"]),
        "armed": [sanitizer.armed(), bufsan.ACTIVE is not None],
    }))
    """
)


def test_sanitizers_armed_workload_reports_alike():
    """MTPU_TSAN=1 and MTPU_BUFSAN=1 armed at import in a fresh interpreter
    per package: a small PUT/GET workload reports the same findings in both,
    none. Hold times are not compared (the 200 ms rule fires on neither)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MTPU_TSAN="1", MTPU_BUFSAN="1", JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    reports = []
    for pkg in ("port", "jax"):
        res = subprocess.run(
            [sys.executable, "-c", _WORKLOAD, pkg], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr[-3000:]
        reports.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert reports[0] == reports[1]
    assert reports[0] == {"tsan": [], "bufsan": [], "armed": [True, True]}


def test_seeded_lock_inversion_reported_in_both():
    found = []
    for mod in (sanitizer, jax_san):
        san = mod.Sanitizer(hold_threshold_s=5.0)
        a = mod.SanLock(san, "Seed._a_lock")
        b = mod.SanLock(san, "Seed._b_lock")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        found.append(sorted(
            f["rule"] for f in san.report()["findings"] if "suppressed" not in f
        ))
    assert found[0] == found[1] == ["lock-order-inversion"]


def test_seeded_write_after_release_reported_in_both():
    found = []
    for mod, pool_cls in ((bufsan, BufferPool), (jax_bufsan, JaxBufferPool)):
        pool = pool_cls(buf_size=64, capacity=2)
        san = mod.BufSanitizer()
        mod.arm(san)
        try:
            pb = pool.acquire()
            storage = pb.data  # kept past the release
            pb.release()
            storage[5] = 0x7F  # a stale write into pooled memory
            pool.acquire()
        finally:
            mod.disarm()
        found.append(sorted(f["rule"] for f in san.findings))
    assert found[0] == found[1] and "write-after-release" in found[0]


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_bitrot_caught_and_rebuilt(tmp_path, cuda_device):
    """A bitrot write fault on one drive: the hash kernel catches the flipped
    shard on GET, the RS kernel rebuilds it, and heal rewrites it."""
    from minio_tpu_torch.ops import highwayhash_cuda, rs_cuda

    reg = faults.FaultRegistry()
    codec = BatchingDeviceCodec()
    try:
        drives = _drives(str(tmp_path), port_format, LocalDrive, lambda d: FaultyDisk(d, reg))
        eo = ErasureObjects(drives, parity=PARITY, codec=codec)
        eo.make_bucket(BUCKET)
        reg.arm(faults.FaultSpec(kind="bitrot", target=os.sep + "d1", seed=3))
        data = _payload(31, 4 << 20)
        eo.put_object(BUCKET, "rot", data)
        reg.disarm_all()
        rs0, hh0 = rs_cuda.KERNEL.launches, highwayhash_cuda.KERNEL.launches
        assert eo.get_object(BUCKET, "rot")[1] == data
        assert rs_cuda.KERNEL.launches > rs0 and highwayhash_cuda.KERNEL.launches > hh0
        eo.heal_object(BUCKET, "rot")
        assert eo.get_object(BUCKET, "rot")[1] == data
    finally:
        codec.close()


@pytest.mark.cuda
def test_cuda_breaker_degraded_get(tmp_path, cuda_device):
    """Two drives fail every call until their breakers open; PUT and GET go
    on through the other six, the GET rebuilding on the card."""
    from minio_tpu_torch.ops import rs_cuda

    reg = faults.FaultRegistry()
    codec = BatchingDeviceCodec()
    try:
        drives = _drives(
            str(tmp_path), port_format, LocalDrive,
            lambda d: MeteredDrive(breaker.HealthGatedDrive(FaultyDisk(d, reg))),
        )
        eo = ErasureObjects(drives, parity=PARITY, codec=codec)
        eo.make_bucket(BUCKET)
        data = _payload(41, 3 << 20)
        eo.put_object(BUCKET, "pre", data)
        for name in ("d2", "d5"):
            reg.arm(faults.FaultSpec(kind="drive-error", target=os.sep + name))
        for i in (2, 5):
            for _ in range(5):
                with pytest.raises(errors.FaultyDisk):
                    drives[i].disk_info()
            assert drives[i].breaker.state == breaker.OPEN and not drives[i].is_online()
        eo.put_object(BUCKET, "during", data)
        rs0 = rs_cuda.KERNEL.launches
        assert eo.get_object(BUCKET, "pre")[1] == data
        assert eo.get_object(BUCKET, "during")[1] == data
        assert rs_cuda.KERNEL.launches > rs0
    finally:
        reg.disarm_all()
        for d in drives:
            d.breaker.close()
        codec.close()
