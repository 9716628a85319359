"""Usage accounting, lifecycle rules and the data scanner of minio_tpu_torch
on the CPU (control/usage.py, lifecycle.py, scanner.py), held against the
JAX package's.

The rule cases of tests/test_control.py, and more, go through both
packages' `Lifecycle` and must give the same verdicts. The usage tree must
serialize to the same JSON, and each package must read the other's. Then
both packages get the same pool (the same format.json on every drive), the
same numpy-seeded objects written under a pinned clock and uuid4, the same
lifecycle and the same damage, and one `scan_cycle` each: the persisted
usage JSON, the objects the seeded RNG samples for the deep check, the
expired and the healed objects and every drive's files must be the same.
The port runs BatchingDeviceCodec(device="cpu"), the JAX package its numpy
HostCodec. Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
import uuid

import numpy as np
import pytest

from minio_tpu.control import events as jax_events
from minio_tpu.control import scanner as jax_scanner
from minio_tpu.control import usage as jax_usage
from minio_tpu.control.bucket_meta import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.control.lifecycle import Lifecycle as JaxLifecycle
from minio_tpu.object import erasure as jax_erasure
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.control import events as port_events
from minio_tpu_torch.control import scanner as port_scanner
from minio_tpu_torch.control import usage as port_usage
from minio_tpu_torch.control.bucket_meta import BucketMetadataSys
from minio_tpu_torch.control.lifecycle import Lifecycle
from minio_tpu_torch.control.scanner import DataScanner, DynamicSleeper
from minio_tpu_torch.control.usage import DataUsageCache, UsageEntry
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object import erasure as port_erasure
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage.local import LocalDrive

NS = "http://s3.amazonaws.com/doc/2006-03-01/"
DAY = 86400
MOD_TIME = 1_760_000_000.25
CLOCK = 1_760_000_500.75


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


# -- lifecycle rules ----------------------------------------------------------------------------

def _lc(*rules: str) -> str:
    return f'<LifecycleConfiguration xmlns="{NS}">{"".join(rules)}</LifecycleConfiguration>'


EXPIRE_TMP = _lc(
    "<Rule><ID>exp</ID><Status>Enabled</Status><Filter><Prefix>tmp/</Prefix></Filter>"
    "<Expiration><Days>1</Days></Expiration></Rule>",
    "<Rule><ID>keep</ID><Status>Disabled</Status><Filter><Prefix></Prefix></Filter>"
    "<Expiration><Days>1</Days></Expiration></Rule>",
)
TRANSITION = _lc("<Rule><ID>t</ID><Status>Enabled</Status><Prefix></Prefix>"
                 "<Transition><Days>1</Days><StorageClass>COLD</StorageClass></Transition></Rule>")
TRANSITION_NOW = _lc("<Rule><ID>t0</ID><Status>Enabled</Status><Filter><Prefix>cold/</Prefix></Filter>"
                     "<Transition><Days>0</Days><StorageClass>COLD</StorageClass></Transition></Rule>")
TRANSITION_DATE = _lc("<Rule><ID>td</ID><Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
                      "<Transition><Date>2020-01-01T00:00:00Z</Date><StorageClass>ARCHIVE</StorageClass>"
                      "</Transition></Rule>")
EXPIRE_DATE = _lc("<Rule><ID>ed</ID><Status>Enabled</Status><Filter><Prefix>old/</Prefix></Filter>"
                  "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>")
MARKERS = _lc("<Rule><ID>dm</ID><Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
              "<Expiration><ExpiredObjectDeleteMarker>true</ExpiredObjectDeleteMarker></Expiration></Rule>")
NONCURRENT = _lc("<Rule><ID>nc</ID><Status>Enabled</Status><Filter><Prefix>v/</Prefix></Filter>"
                 "<NoncurrentVersionExpiration><NoncurrentDays>3</NoncurrentDays></NoncurrentVersionExpiration></Rule>")
ABORT_MPU = _lc("<Rule><ID>a</ID><Status>Enabled</Status><Prefix>stale/</Prefix><AbortIncompleteMultipartUpload>"
                "<DaysAfterInitiation>1</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>")
BOTH = _lc("<Rule><ID>x</ID><Status>Enabled</Status><Filter><Prefix>a/</Prefix></Filter>"
           "<Expiration><Days>30</Days></Expiration>"
           "<Transition><Days>7</Days><StorageClass>WARM</StorageClass></Transition></Rule>")

# (xml, object name, age in days, delete marker)
LC_CASES = {
    "expire-old": (EXPIRE_TMP, "tmp/x", 2, False),
    "expire-young": (EXPIRE_TMP, "tmp/x", 0, False),
    "expire-other-prefix": (EXPIRE_TMP, "other/x", 2, False),
    "transition-days": (TRANSITION, "x", 2, False),
    "transition-young": (TRANSITION, "x", 0.5, False),
    "transition-days-0": (TRANSITION_NOW, "cold/x", 0, False),
    "transition-days-0-other": (TRANSITION_NOW, "warm/x", 0, False),
    "transition-date-past": (TRANSITION_DATE, "any", 0, False),
    "expire-date-past": (EXPIRE_DATE, "old/x", 0, False),
    "expired-delete-marker": (MARKERS, "k", 0, True),
    "marker-rule-on-object": (MARKERS, "k", 400, False),
    "noncurrent-only": (NONCURRENT, "v/k", 10, False),
    "expire-before-transition": (BOTH, "a/k", 40, False),
    "transition-before-expire": (BOTH, "a/k", 10, False),
    "neither-yet": (BOTH, "a/k", 1, False),
}


@pytest.mark.parametrize("case", sorted(LC_CASES))
def test_lifecycle_eval_against_jax(case):
    xml, name, age, marker = LC_CASES[case]
    mod_time = time.time() - age * DAY
    port, jax = Lifecycle.from_xml(xml), JaxLifecycle.from_xml(xml)
    assert [r.__dict__ for r in port.rules] == [r.__dict__ for r in jax.rules]
    assert port.eval(name, mod_time, marker) == jax.eval(name, mod_time, marker)
    assert port.eval_noncurrent(name, mod_time) == jax.eval_noncurrent(name, mod_time)
    assert port.eval_abort_mpu(name, mod_time) == jax.eval_abort_mpu(name, mod_time)


def test_lifecycle_verdicts():
    """The cases of tests/test_control.py::TestLifecycle."""
    old = time.time() - 2 * DAY
    lc = Lifecycle.from_xml(EXPIRE_TMP)
    assert len(lc.rules) == 2
    assert lc.eval("tmp/x", old) == "expire"
    assert lc.eval("tmp/x", time.time()) == ""
    assert lc.eval("other/x", old) == ""
    assert Lifecycle.from_xml(TRANSITION).eval("x", old) == "transition:COLD"
    assert Lifecycle.from_xml(TRANSITION_NOW).eval("cold/x", time.time()) == "transition:COLD"
    mpu = Lifecycle.from_xml(ABORT_MPU)
    assert mpu.eval_abort_mpu("stale/obj", time.time() - 2 * DAY)
    assert not mpu.eval_abort_mpu("stale/obj", time.time() - 3600)
    assert not mpu.eval_abort_mpu("other/obj", 0)


# -- the usage tree -----------------------------------------------------------------------------

USAGE_RECORDS = [("b1", "a/b/c/d", 10, 1), ("b1", "a/x", 5, 2), ("b1", "top", 7, 1), ("b2", "p/q", 100, 3),
                 ("b1", "a/b/e", 1, 1)]


def _usage(mod):
    c = mod.DataUsageCache()
    for rec in USAGE_RECORDS:
        c.record(*rec)
    c.last_update = CLOCK
    return c


def test_usage_json_equals_the_jax_tree():
    port, jax = _usage(port_usage), _usage(jax_usage)
    assert port.to_bytes() == jax.to_bytes()
    assert port.summary() == jax.summary()
    assert port.bucket_usage("b1").to_dict() == jax.bucket_usage("b1").to_dict()
    assert port.bucket_usage("none").to_dict() == {"o": 0, "v": 0, "s": 0}


def test_each_package_reads_the_others_usage_json():
    port, jax = _usage(port_usage), _usage(jax_usage)
    assert DataUsageCache.from_bytes(jax.to_bytes()).to_bytes() == jax.to_bytes()
    assert jax_usage.DataUsageCache.from_bytes(port.to_bytes()).to_bytes() == port.to_bytes()
    e = UsageEntry.from_dict(json.loads(port.to_bytes())["root"]["b1"])
    assert (e.objects, e.versions, e.size) == (4, 5, 23)
    assert set(e.children) == {"a/"}


def test_usage_reset_and_finish():
    c = _usage(port_usage)
    c.reset()
    assert c.summary()["bucketsCount"] == 0
    c.finish()
    assert c.last_update > 0


def test_dynamic_sleeper_caps_its_sleep(monkeypatch):
    slept = []
    monkeypatch.setattr(port_scanner.time, "sleep", slept.append)
    s = DynamicSleeper(factor=10.0, max_sleep=1.0)
    s.sleep(0.01)
    s.sleep(5.0)
    assert slept == [pytest.approx(0.1), 1.0]


# -- one scan cycle in both packages ------------------------------------------------------------

SET_DRIVES, N_SETS = 4, 2
DAMAGE_DRIVE = 1


def _objects() -> dict:
    """Objects under three prefixes: exp/ expires (a past Date), keep/ and
    big/ stay; two of big/ are past the inline limit (part files)."""
    rng = np.random.default_rng(77)
    out = {}
    for i in range(6):
        out[f"exp/o{i}"] = rng.integers(0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
    for i in range(10):
        out[f"keep/o{i:02d}"] = rng.integers(0, 256, int(rng.integers(1, 20_000)), dtype=np.uint8).tobytes()
    for i in range(2):
        out[f"big/o{i}"] = rng.integers(0, 256, 140_000 + 1000 * i, dtype=np.uint8).tobytes()
    return out


OBJECTS = _objects()
SCAN_LC = _lc("<Rule><ID>e</ID><Status>Enabled</Status><Filter><Prefix>exp/</Prefix></Filter>"
              "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>")


def _uuids(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: uuid.UUID(bytes=rng.integers(0, 256, 16, dtype=np.uint8).tobytes(), version=4)


class _Clock:
    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


class _Store:
    def __init__(self):
        self.files = {}

    def put(self, path, raw):
        self.files[path] = bytes(raw)

    def get(self, path):
        return self.files.get(path)


PKGS = {
    "jax": (JaxServerPools, JaxErasureSets, JaxLocalDrive, jax_format.DriveFormat, jax_erasure, jax_usage,
            jax_scanner.DataScanner, JaxBucketMetadataSys, jax_events.EventNotifier),
    "port": (ServerPools, ErasureSets, LocalDrive, fmt.DriveFormat, port_erasure, port_usage, DataScanner,
             BucketMetadataSys, port_events.EventNotifier),
}


@contextlib.contextmanager
def _pinned(mp, erasure_mod, seed: int, mod_time: float):
    with mp.context() as m:
        m.setattr(erasure_mod, "now", lambda: mod_time)
        m.setattr(uuid, "uuid4", _uuids(seed))
        yield


def _tree(dirs) -> dict:
    out = {}
    for i, d in enumerate(dirs):
        base = os.path.join(d, "scan")
        for dirpath, _, files in os.walk(base):
            for f in files:
                full = os.path.join(dirpath, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, base))] = fh.read()
    return out


@pytest.fixture(scope="module")
def scanned(tmp_path_factory, codec):
    """Both packages: the same pool and objects, the lifecycle, the same
    damage (every object's directory removed from one drive of its set),
    one scan_cycle with heal_sample 3. Returns what each saw and left."""
    root = str(tmp_path_factory.mktemp("scan"))
    formats = jax_format.init_format(N_SETS, SET_DRIVES)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, (SP, ES, LD, DF, erasure_mod, usage_mod, Scanner, Meta, Notifier) in PKGS.items():
            dirs = []
            for i, f in enumerate(formats):
                d = os.path.join(root, name, f"d{i}")
                os.makedirs(d)
                f.save(d)
                dirs.append(d)
            c = JaxHostCodec() if name == "jax" else codec
            layer = SP([ES.from_drives([LD(d) for d in dirs], DF.load(dirs[0]), codec=c, pool_index=0)])
            layer.make_bucket("scan")
            for i, (key, data) in enumerate(OBJECTS.items()):
                with _pinned(mp, erasure_mod, 300 + i, MOD_TIME + i):
                    layer.put_object("scan", key, data)
            meta = Meta(layer)
            meta.update("scan", lifecycle_xml=SCAN_LC)
            damaged = ["keep/o03", "keep/o07", "big/o1", "exp/o2"]
            for key in damaged:
                s = layer.pools[0].get_set_index(key)
                shutil.rmtree(os.path.join(dirs[s * SET_DRIVES + DAMAGE_DRIVE], "scan", key))
            store = _Store()
            notifier = Notifier()
            listen = notifier.listen_hub.subscribe()
            sc = Scanner(layer, bucket_meta=meta, heal_sample=3, store=store, notifier=notifier)
            sc._sleeper.sleep = lambda s: None
            sampled = []
            real_heal = layer.heal_object

            def heal(bucket, key, *a, _real=real_heal, _seen=sampled, **k):
                if k.get("dry_run"):
                    _seen.append(key)
                return _real(bucket, key, *a, **k)

            layer.heal_object = heal
            with mp.context() as m:
                m.setattr(usage_mod, "time", _Clock(CLOCK))
                m.setattr(erasure_mod, "now", lambda: MOD_TIME + 1000)
                m.setattr(uuid, "uuid4", _uuids(900))
                sc.scan_cycle()
            records = []
            while not listen.empty():
                records.append(listen.get_nowait())
            out[name] = {"layer": layer, "dirs": dirs, "scanner": sc, "store": store, "sampled": sampled,
                         "damaged": damaged, "tree": _tree(dirs), "records": records}
        yield out
    finally:
        mp.undo()


def test_scan_usage_json_equals_jax(scanned):
    port, jax = scanned["port"], scanned["jax"]
    raw = port["store"].get("scanner/data-usage.json")
    assert raw == jax["store"].get("scanner/data-usage.json")
    doc = json.loads(raw)
    assert doc["lastUpdate"] == CLOCK
    assert doc["root"]["scan"]["o"] == len(OBJECTS)  # the cycle records before it expires
    assert doc["root"]["scan"]["s"] == sum(len(v) for v in OBJECTS.values())


def test_scan_samples_the_same_objects_from_the_shared_seed(scanned):
    port, jax = scanned["port"], scanned["jax"]
    assert port["sampled"] == jax["sampled"]
    assert 0 < len(port["sampled"]) < len(OBJECTS)
    assert port["scanner"]._rng.getstate() == jax["scanner"]._rng.getstate()


def test_scan_expires_and_heals_the_same_objects(scanned):
    port, jax = scanned["port"], scanned["jax"]
    for side in (port, jax):
        sc = side["scanner"]
        assert sc.cycles_completed == 1
        assert sc.objects_expired == sum(k.startswith("exp/") for k in OBJECTS)
    assert port["scanner"].objects_healed == jax["scanner"].objects_healed
    healed = {k for k in port["damaged"] if k in port["sampled"] and not k.startswith("exp/")}
    assert port["scanner"].objects_healed == len(healed)
    names = {o.name for o in port["layer"].list_objects("scan", max_keys=1000).objects}
    assert names == {k for k in OBJECTS if not k.startswith("exp/")}
    for key in healed:
        assert port["layer"].heal_object("scan", key, dry_run=True).disks_healed == 0
    for key in names:
        assert port["layer"].get_object("scan", key)[1] == OBJECTS[key]


def test_scan_expiry_emits_the_jax_records(scanned):
    """One s3:ObjectRemoved:Expired record per expired object, as the JAX
    scanner emits them (control/scanner.py); eventTime is each emit's wall
    clock, compared by its format."""
    got = {}
    for name in ("jax", "port"):
        recs = []
        for r in scanned[name]["records"]:
            r = json.loads(json.dumps(r))
            assert len(r["Records"][0].pop("eventTime")) == len("2025-10-09T08:53:20Z")
            recs.append(r)
        got[name] = recs
    assert got["port"] == got["jax"]
    assert [(r["EventName"], r["Key"]) for r in got["port"]] == [
        ("s3:ObjectRemoved:Expired", f"scan/{k}") for k in OBJECTS if k.startswith("exp/")]


def test_scan_leaves_the_same_files_on_every_drive(scanned):
    port, jax = scanned["port"]["tree"], scanned["jax"]["tree"]
    assert sorted(port) == sorted(jax)
    for k in jax:
        assert port[k] == jax[k], k


def test_scanner_heals_damage(tmp_path, codec):
    """tests/test_control.py::test_scanner_heals_damage on the port."""
    formats = fmt.init_format(1, 8)
    dirs = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    layer = ServerPools([ErasureSets.from_drives([LocalDrive(d) for d in dirs], formats[0], codec=codec)])
    layer.make_bucket("scanb")
    layer.put_object("scanb", "obj", b"d" * 200_000)
    for i in range(5):
        layer.put_object("scanb", f"dir/obj{i}", b"x" * 1000)
    shutil.rmtree(os.path.join(dirs[0], "scanb", "obj"))
    sc = DataScanner(layer, heal_sample=1)
    sc._sleeper.sleep = lambda s: None
    sc.scan_cycle()
    assert layer.heal_object("scanb", "obj", dry_run=True).disks_healed == 0
    s = sc.usage.summary()
    assert s["objectsCount"] == 6
    assert s["objectsTotalSize"] == 205_000
    assert s["bucketsUsage"]["scanb"]["objectsCount"] == 6
    assert sc.objects_healed == 1


def test_stop_abandons_a_cycle_in_flight(tmp_path, codec):
    """A node's shutdown stops its scanner: stop() must not wait out a
    throttled cycle over the whole namespace. The cycle in flight ends at
    its next object and publishes no usage."""
    import threading

    formats = fmt.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    layer = ServerPools([ErasureSets.from_drives([LocalDrive(d) for d in dirs], formats[0], codec=codec)])
    layer.make_bucket("slow")
    for i in range(40):
        layer.put_object("slow", f"o{i:02d}", b"s" * 100)
    sc = DataScanner(layer, heal_sample=1 << 30, cycle_seconds=3600)
    walked = threading.Event()

    def slow_sleep(_work):
        walked.set()
        time.sleep(0.5)  # 40 objects: a 20 s cycle

    sc._sleeper.sleep = slow_sleep
    sc.start()
    assert walked.wait(30)
    t0 = time.monotonic()
    sc.stop()
    assert time.monotonic() - t0 < 3.0
    assert not sc._thread.is_alive()
    assert sc.cycles_completed == 0 and sc.usage.last_update == 0


def test_stop_leaves_a_thread_stuck_in_a_call(tmp_path, codec):
    """A cycle blocked inside one object's call (a peer that does not
    answer) outlives stop()'s wait: stop() returns False after its timeout,
    stack() names the blocked frame, and a second stop() (a node's close()
    after the server's own) does not wait again."""
    import threading

    formats = fmt.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    layer = ServerPools([ErasureSets.from_drives([LocalDrive(d) for d in dirs], formats[0], codec=codec)])
    layer.make_bucket("stuck")
    layer.put_object("stuck", "o", b"s" * 100)
    sc = DataScanner(layer, heal_sample=1 << 30, cycle_seconds=3600)
    inside, release = threading.Event(), threading.Event()

    def blocked_call(_work):
        inside.set()
        release.wait(30)

    sc._sleeper.sleep = blocked_call
    sc.start()
    try:
        assert inside.wait(30)
        t0 = time.monotonic()
        assert sc.stop(timeout=0.5) is False
        assert 0.5 <= time.monotonic() - t0 < 3.0
        assert "blocked_call" in sc.stack()
        t0 = time.monotonic()
        assert sc.stop(timeout=30) is False
        assert time.monotonic() - t0 < 0.5
    finally:
        release.set()
    sc._thread.join(10)
    assert sc.stop() is True and sc.stack() == ""


def test_scanner_aborts_stale_multipart_uploads(tmp_path, codec):
    """tests/test_control.py::TestAbortIncompleteMultipart on the port."""
    formats = fmt.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    layer = ServerPools([ErasureSets.from_drives([LocalDrive(d) for d in dirs], formats[0], codec=codec)])
    layer.make_bucket("mpab")
    uid = layer.new_multipart_upload("mpab", "stale/obj")
    layer.put_object_part("mpab", "stale/obj", uid, 1, b"x" * 1000)
    fresh_uid = layer.new_multipart_upload("mpab", "fresh/obj")
    meta = BucketMetadataSys(layer)
    meta.update("mpab", lifecycle_xml=ABORT_MPU)
    for d in dirs:
        for dirpath, _, files in os.walk(os.path.join(d, ".minio_tpu.sys", "multipart", "mpab")):
            if "upload.json" in files:
                p = os.path.join(dirpath, "upload.json")
                doc = json.loads(open(p, "rb").read())
                doc["created"] = time.time() - 3 * DAY
                with open(p, "w") as fh:
                    fh.write(json.dumps(doc))
    sc = DataScanner(layer, heal_sample=10**9, bucket_meta=meta)
    sc.scan_cycle()
    remaining = {u["upload_id"] for u in layer.list_multipart_uploads("mpab")}
    assert uid not in remaining
    assert fresh_uid in remaining
    assert sc.uploads_aborted >= 1


def test_scanner_raises_before_a_codec_is_installed(tmp_path, monkeypatch):
    """A layer built without codec= takes the process default, the cuda
    codec, which raises without a card: a cycle does not start."""
    monkeypatch.setattr(codec_mod, "_default", None)
    formats = fmt.init_format(1, 4)
    drives = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    layer = ServerPools([ErasureSets.from_drives(drives, formats[0])])
    with pytest.raises(RuntimeError):
        DataScanner(layer).scan_cycle()


def test_stop_is_not_held_by_a_peer_that_accepts_no_connection(tmp_path, codec, monkeypatch):
    """A stopping node's scanner sat in a peer call's connect() (ROADMAP,
    Queue C item 9): a peer whose listener accepts nothing drops the SYNs,
    and the connect waited out the call's whole timeout (30 s) past the
    server's SCANNER_GRACE_S. The transport's connect deadline ends that
    call, so the scanner stops within the grace."""
    import socket
    import threading

    from minio_tpu_torch import cli
    from minio_tpu_torch.dist import transport
    from minio_tpu_torch.dist.storage_rest import RemoteDrive

    formats = fmt.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = str(tmp_path / f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    local = ServerPools([ErasureSets.from_drives([LocalDrive(d) for d in dirs], formats[0], codec=codec)])
    local.make_bucket("peer")
    local.put_object("peer", "o", b"p" * 100)
    # A listener with a backlog of one, filled: every later SYN is dropped.
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(0)
    port = listener.getsockname()[1]
    filler = socket.create_connection(("127.0.0.1", port))
    connecting = threading.Event()
    real_connect = socket.socket.connect

    def connect(sock, address):
        if isinstance(address, tuple) and address[1] == port:
            connecting.set()
        return real_connect(sock, address)

    monkeypatch.setattr(socket.socket, "connect", connect)
    # The set's fourth drive becomes a remote drive on that peer.
    remote = RemoteDrive(f"http://127.0.0.1:{port}", dirs[3], "token")
    local.pools[0].sets[0].disks[3] = remote
    sc = DataScanner(local, heal_sample=1 << 30, cycle_seconds=3600)
    sc._sleeper.sleep = lambda _work: None
    try:
        sc.start()
        assert connecting.wait(30)
        t0 = time.monotonic()
        assert sc.stop(timeout=cli.SCANNER_GRACE_S) is True
        assert time.monotonic() - t0 < transport.CONNECT_TIMEOUT + 2.0
        assert not remote.is_online()  # the connect failed; the peer is marked offline
    finally:
        sc.stop(timeout=0)
        filler.close()
        listener.close()
