"""Remote tiers of minio_tpu_torch on the CPU (control/tiering.py's
TierConfigMgr, FSTierBackend and S3TierBackend, and control/replication.py's
BucketTarget and TargetClient), held against the JAX package's.

The cases of tests/test_tiering.py run against a port Node served over
HTTP, an S3 tier included: its remote is a second port node's S3 front on
a loopback port. Then both packages' TierConfigMgr get the same calls: the
tier config and the journal documents they persist must be the same bytes
(credentials in the clear without a KMS; sealed ones each package unseals
for the other), and transition -> read_object -> restore ->
expire_restored_copies on the same objects must leave the same objects,
the same remote bytes and the same counts. The port runs
BatchingDeviceCodec(device="cpu"), the JAX package its numpy HostCodec.
Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from minio_tpu.control import crypto as jax_crypto
from minio_tpu.control import kms as jax_kms
from minio_tpu.control import tiering as jax_tiering
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import META_BUCKET as JAX_META_BUCKET
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.control import kms as port_kms
from minio_tpu_torch.control import replication
from minio_tpu_torch.control import tiering as tiering_mod
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object.erasure import META_BUCKET
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.s3select import decode_messages
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors
from tests.s3client import S3TestClient

ROOT = "tierroot1"
SECRET = "tier-secret-key1"
ADMIN = "/mtpu/admin/v1"
BIG = np.random.default_rng(31).integers(0, 256, 140 * 1024, dtype=np.uint8).tobytes()  # past the inline limit


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Served:
    def __init__(self, dirs, codec):
        self.node = Node(dirs, root_user=ROOT, root_password=SECRET, codec=codec, device="cpu")
        self.stop_evt = threading.Event()
        port = _free_port()
        self.thread, errs = cli._run_app_until(self.node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        self.node.build()
        self.url = f"http://127.0.0.1:{port}"
        self.client = S3TestClient(self.url, ROOT, SECRET)

    def stop(self):
        self.stop_evt.set()
        self.thread.join(10)
        self.node.close()


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def srv(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("tiersrv")
    s = Served([str(tmp / f"d{i}") for i in range(4)], codec)
    tier_dir = str(tmp / "coldstore")
    r = s.client.request("POST", f"{ADMIN}/tiers",
                         body=json.dumps({"name": "COLD", "type": "fs", "dir": tier_dir, "prefix": "x/"}).encode())
    assert r.status_code == 200, r.text
    try:
        yield {"client": s.client, "node": s.node, "tier_dir": tier_dir, "tmp": tmp, "url": s.url}
    finally:
        s.stop()


def _local_part_files(node, bucket, key):
    out = []
    for path in node.local_drives:
        obj_dir = os.path.join(path, bucket, key)
        if not os.path.isdir(obj_dir):
            continue
        for sub in os.listdir(obj_dir):
            p = os.path.join(obj_dir, sub)
            if os.path.isdir(p):
                out.extend(os.path.join(p, f) for f in os.listdir(p))
    return out


# -- the cases of tests/test_tiering.py, on the port --------------------------------------------


class TestTiering:
    def test_tier_crud(self, srv):
        c = srv["client"]
        tiers = c.request("GET", f"{ADMIN}/tiers").json()
        assert [t["name"] for t in tiers] == ["COLD"]
        assert all("secret_key" not in t for t in tiers)
        r = c.request("POST", f"{ADMIN}/tiers", body=json.dumps({"name": "COLD", "type": "fs", "dir": "/x"}).encode())
        assert r.status_code == 400

    def test_transition_frees_local_data_and_reads_from_tier(self, srv):
        c, node = srv["client"], srv["node"]
        assert c.make_bucket("arch").status_code == 200
        assert c.put_object("arch", "big.bin", BIG).status_code == 200
        assert _local_part_files(node, "arch", "big.bin")
        oi = node.tiering.transition(node.pools, "arch", "big.bin", "", "COLD")
        assert tiering_mod.is_transitioned(oi.internal)
        assert not _local_part_files(node, "arch", "big.bin")
        remote = [os.path.join(dp, f) for dp, _, fs in os.walk(srv["tier_dir"]) for f in fs]
        assert len(remote) == 1 and "/x/" in remote[0]
        r = c.request("GET", "/arch/big.bin")
        assert r.status_code == 200 and r.content == BIG
        r = c.request("HEAD", "/arch/big.bin")
        assert r.headers["x-amz-storage-class"] == "COLD"

    def test_ranged_read_on_transitioned(self, srv):
        r = srv["client"].request("GET", "/arch/big.bin", headers={"Range": "bytes=100-199"})
        assert r.status_code == 206
        assert r.content == BIG[100:200]

    def test_heal_is_noop_on_transitioned(self, srv):
        assert srv["node"].pools.heal_object("arch", "big.bin").disks_healed == 0

    def test_restore_materializes_local_copy(self, srv):
        c, node = srv["client"], srv["node"]
        r = c.request("POST", "/arch/big.bin", query=[("restore", "")],
                      body=b"<RestoreRequest><Days>2</Days></RestoreRequest>")
        assert r.status_code == 202, r.text
        r = c.request("HEAD", "/arch/big.bin")
        assert 'ongoing-request="false"' in r.headers.get("x-amz-restore", "")
        backend = node.tiering.backend("COLD")
        remote_key = node.pools.get_object_info("arch", "big.bin").internal[tiering_mod.META_TRANSITION_NAME]
        blob = backend.get(remote_key)
        backend.delete(remote_key)
        r = c.request("GET", "/arch/big.bin")
        assert r.status_code == 200 and r.content == BIG
        backend.put(remote_key, blob)
        r = c.request("POST", "/arch/big.bin", query=[("restore", "")],
                      body=b"<RestoreRequest><Days>1</Days></RestoreRequest>")
        assert r.status_code == 200

    def test_delete_journals_remote_reclamation(self, srv):
        c, node = srv["client"], srv["node"]
        assert c.put_object("arch", "doomed.bin", BIG).status_code == 200
        node.tiering.transition(node.pools, "arch", "doomed.bin", "", "COLD")
        remote_key = node.pools.get_object_info("arch", "doomed.bin").internal[tiering_mod.META_TRANSITION_NAME]
        backend = node.tiering.backend("COLD")
        assert backend.get(remote_key)
        assert c.request("DELETE", "/arch/doomed.bin").status_code == 204
        assert node.tiering.drain_journal() == 1
        with pytest.raises(errors.ObjectNotFound):
            backend.get(remote_key)

    def test_lifecycle_transition_via_scanner(self, srv):
        c, node = srv["client"], srv["node"]
        assert c.make_bucket("ilmbkt").status_code == 200
        lc = ('<LifecycleConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
              "<Rule><ID>t</ID><Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
              "<Transition><Days>0</Days><StorageClass>COLD</StorageClass></Transition>"
              "</Rule></LifecycleConfiguration>")
        assert c.request("PUT", "/ilmbkt", query=[("lifecycle", "")], body=lc.encode()).status_code == 200
        assert c.put_object("ilmbkt", "aging.bin", BIG).status_code == 200
        assert c.put_object("ilmbkt", "inline.bin", b"stays local").status_code == 200
        node.scanner._sleeper.sleep = lambda s: None
        node.scanner.scan_cycle()
        assert tiering_mod.is_transitioned(node.pools.get_object_info("ilmbkt", "aging.bin").internal)
        assert not tiering_mod.is_transitioned(node.pools.get_object_info("ilmbkt", "inline.bin").internal)
        assert node.scanner.objects_transitioned >= 1
        r = c.request("GET", "/ilmbkt/aging.bin")
        assert r.status_code == 200 and r.content == BIG
        usage = c.request("GET", f"{ADMIN}/datausage").json()
        assert usage["bucketsUsage"]["ilmbkt"] == {"objectsCount": 2, "size": len(BIG) + 11, "versionsCount": 2}

    def test_s3_tier_to_second_cluster(self, srv, tmp_path_factory, codec):
        """A tier of type "s3" whose remote is a second port node's S3 front
        on a loopback port: cold data lands in its bucket."""
        tmp = tmp_path_factory.mktemp("tierdst")
        dst = Served([str(tmp / f"d{i}") for i in range(4)], codec)
        try:
            assert dst.client.make_bucket("coldbkt").status_code == 200
            c, node = srv["client"], srv["node"]
            r = c.request("POST", f"{ADMIN}/tiers", body=json.dumps({
                "name": "REMOTE", "type": "s3", "endpoint": dst.url, "bucket": "coldbkt",
                "access_key": ROOT, "secret_key": SECRET}).encode())
            assert r.status_code == 200, r.text
            assert isinstance(node.tiering.backend("REMOTE"), tiering_mod.S3TierBackend)
            assert node.tiering.backend("REMOTE").online()
            assert c.put_object("arch", "tos3.bin", BIG).status_code == 200
            node.tiering.transition(node.pools, "arch", "tos3.bin", "", "REMOTE")
            remote = node.pools.get_object_info("arch", "tos3.bin").internal[tiering_mod.META_TRANSITION_NAME]
            got = dst.client.get_object("coldbkt", remote)
            assert (got.status_code, got.content == BIG) == (200, True)
            r = c.request("GET", "/arch/tos3.bin")
            assert r.status_code == 200 and r.content == BIG
        finally:
            dst.stop()

    def test_sealed_tier_secrets_at_rest(self, srv):
        pytest.importorskip("cryptography", reason="node boots KMS-less without the crypto backend")
        raw = srv["node"].tiering.store.get(tiering_mod.CONFIG_PATH)
        doc = json.loads(raw)
        remote = [t for t in doc if t["name"] == "REMOTE"]
        assert remote and remote[0]["secret_key"].startswith("sealed:")
        assert SECRET not in json.dumps(remote)

    def test_copy_of_transitioned_object(self, srv):
        node, c = srv["node"], srv["client"]
        body = np.random.default_rng(5).integers(0, 256, 150 * 1024, dtype=np.uint8).tobytes()
        c.put_object("arch", "cp-tiered.bin", body)
        node.tiering.transition(node.pools, "arch", "cp-tiered.bin", "", "COLD")
        r = c.request("PUT", "/arch/cp-tiered-dst.bin", headers={"x-amz-copy-source": "/arch/cp-tiered.bin"})
        assert r.status_code == 200, r.text
        assert c.get_object("arch", "cp-tiered-dst.bin").content == body
        assert not tiering_mod.is_transitioned(node.pools.get_object_info("arch", "cp-tiered-dst.bin").internal)
        assert tiering_mod.is_transitioned(node.pools.get_object_info("arch", "cp-tiered.bin").internal)

    def test_select_on_transitioned_object(self, srv):
        """S3 Select over a transitioned object recalls it from the tier (the
        shared logical-read path) instead of 5xx-ing on freed shards."""
        node, c = srv["node"], srv["client"]
        assert c.make_bucket("arch").status_code in (200, 409)
        csv = b"a,b\n" + b"".join(b"%d,%d\n" % (i, i) for i in range(50000))
        c.put_object("arch", "sel.csv", csv)
        node.tiering.transition(node.pools, "arch", "sel.csv", "", "COLD")
        assert _local_part_files(node, "arch", "sel.csv") == []
        sel = c.request(
            "POST", "/arch/sel.csv", query=[("select", ""), ("select-type", "2")],
            body=b"""<?xml version="1.0"?><SelectObjectContentRequest>
              <Expression>SELECT count(*) FROM S3Object</Expression>
              <ExpressionType>SQL</ExpressionType>
              <InputSerialization><CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV></InputSerialization>
              <OutputSerialization><CSV/></OutputSerialization>
            </SelectObjectContentRequest>""",
        )
        assert sel.status_code == 200, sel.text
        recs = b"".join(
            m["payload"] for m in decode_messages(sel.content)
            if m["headers"].get(":event-type") == "Records"
        )
        assert recs.strip() == b"50000", recs

    def test_tier_stats_and_creds_routes(self, srv):
        c = srv["client"]
        r = c.request("PUT", f"{ADMIN}/tiers/REMOTE/creds",
                      body=json.dumps({"accessKey": ROOT, "secretKey": SECRET}).encode())
        assert r.status_code == 200
        stats = c.request("GET", f"{ADMIN}/tiers/stats").json()
        assert stats["transitionedObjects"] >= 4 and stats["journalBacklog"] == 0
        assert c.request("DELETE", f"{ADMIN}/tiers/REMOTE").status_code == 200
        assert [t["name"] for t in c.request("GET", f"{ADMIN}/tiers").json()] == ["COLD"]


# -- against the JAX package --------------------------------------------------------------------


class _Store:
    def __init__(self, files=None):
        self.files = dict(files or {})

    def put(self, path, raw):
        self.files[path] = bytes(raw)

    def get(self, path):
        return self.files.get(path)


PKG_TIERING = {"jax": jax_tiering, "port": tiering_mod}


def _crud(mod, tmp: str) -> dict:
    """The same TierConfigMgr calls in one package: an FS tier, an S3 tier,
    a creds edit, a tier removed, journaled remote deletes, one drained."""
    store = _Store()
    mgr = mod.TierConfigMgr(store, kms=None)
    mgr.add(mod.TierConfig(name="COLD", type="fs", dir=os.path.join(tmp, "cold"), prefix="x/"))
    mgr.add(mod.TierConfig(name="REMOTE", type="s3", endpoint="http://127.0.0.1:9", bucket="coldbkt",
                           access_key="ak", secret_key="sk", region="us-east-1"))
    mgr.add(mod.TierConfig(name="GONE", type="fs", dir=os.path.join(tmp, "gone")))
    mgr.edit_creds("REMOTE", "ak2", "sk2")
    mgr.remove("GONE")
    with pytest.raises(Exception) as dup:
        mgr.add(mod.TierConfig(name="COLD", type="fs", dir="/x"))
    mgr.backend("COLD").put("x/remote-1", b"cold bytes")
    for key in ("x/remote-1", "x/remote-2"):
        mgr.journal_delete({mod.META_TRANSITION_TIER: "COLD", mod.META_TRANSITION_NAME: key})
    mgr.journal_delete({mod.META_TRANSITION_TIER: "REMOTE"})  # no remote name: not journaled
    journal_before = store.get(mod.JOURNAL_PATH)
    drained = mgr.drain_journal()  # a missing FS file deletes cleanly too
    return {"config": store.get(mod.CONFIG_PATH), "journal": journal_before, "after": store.get(mod.JOURNAL_PATH),
            "drained": drained, "backlog": mgr.journal_backlog(), "dup": type(dup.value).__name__,
            "list": [t.to_dict() for t in mgr.list()]}


def test_tier_config_and_journal_documents_equal(tmp_path):
    out = {name: _crud(mod, str(tmp_path)) for name, mod in PKG_TIERING.items()}
    assert out["port"] == out["jax"]
    doc = json.loads(out["port"]["config"])
    assert [t["name"] for t in doc] == ["COLD", "REMOTE"]
    assert doc[1]["secret_key"] == "sk2"
    assert json.loads(out["port"]["journal"]) == [{"tier": "COLD", "key": "x/remote-1"},
                                                  {"tier": "COLD", "key": "x/remote-2"}]
    assert out["port"]["drained"] == 2 and json.loads(out["port"]["after"]) == []


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sealed_tier_config_each_package_unseals(tmp_path, writer, reader):
    pytest.importorskip("cryptography", reason="sealing needs the crypto backend")
    master = bytes(range(32))
    kms = {"jax": jax_kms.StaticKeyKMS("tier-key", master), "port": port_kms.StaticKeyKMS("tier-key", master)}
    store = _Store()
    w = PKG_TIERING[writer].TierConfigMgr(store, kms=kms[writer])
    w.add(PKG_TIERING[writer].TierConfig(name="REMOTE", type="s3", endpoint="http://127.0.0.1:9", bucket="b",
                                         access_key="ak", secret_key="the-secret"))
    raw = store.get(tiering_mod.CONFIG_PATH)
    assert b"the-secret" not in raw and json.loads(raw)[0]["secret_key"].startswith("sealed:")
    r = PKG_TIERING[reader].TierConfigMgr(_Store(store.files), kms=kms[reader])
    assert [t.secret_key for t in r.list()] == ["the-secret"]
    assert jax_crypto.unseal_secret(kms["jax"], "tier/REMOTE", json.loads(raw)[0]["secret_key"]) == "the-secret"


def _layer(pkg: str, dirs: list, codec):
    if pkg == "jax":
        drives = [JaxLocalDrive(d) for d in dirs]
        return JaxServerPools([JaxErasureSets.from_drives(drives, jax_format.DriveFormat.load(dirs[0]),
                                                          codec=JaxHostCodec())])
    drives = [LocalDrive(d) for d in dirs]
    return ServerPools([ErasureSets.from_drives(drives, fmt.DriveFormat.load(dirs[0]), codec=codec)])


OBJECTS = {"cold/a.bin": BIG, "cold/b.bin": BIG[::-1][:130 * 1024], "cold/tiny": b"inline, never tiered"}


def test_transition_read_restore_expire_against_jax(tmp_path, codec):
    formats = jax_format.init_format(1, 4)
    out = {}
    for pkg, mod in PKG_TIERING.items():
        dirs = []
        for i, f in enumerate(formats):
            d = str(tmp_path / pkg / f"d{i}")
            os.makedirs(d)
            f.save(d)
            dirs.append(d)
        layer = _layer(pkg, dirs, codec)
        layer.make_bucket("tierb")
        for k, v in OBJECTS.items():
            layer.put_object("tierb", k, v)
        mgr = mod.TierConfigMgr(_Store(), kms=None)
        tier_dir = str(tmp_path / pkg / "cold")
        mgr.add(mod.TierConfig(name="COLD", type="fs", dir=tier_dir))
        res = SimpleNamespace(internal={}, read={}, remote={}, restored=[], expired=None, left=[])
        for k in OBJECTS:
            try:
                oi = mgr.transition(layer, "tierb", k, "", "COLD")
                res.internal[k] = sorted((m, oi.internal[m]) for m in (mod.META_TRANSITION_STATUS,
                                                                     mod.META_TRANSITION_TIER))
            except Exception as e:  # noqa: BLE001 - the class name is compared
                res.internal[k] = type(e).__name__
        for k in ("cold/a.bin", "cold/b.bin"):
            oi = layer.get_object_info("tierb", k)
            res.read[k] = mgr.read_object(layer, "tierb", k, oi) == OBJECTS[k]
            with open(os.path.join(tier_dir, oi.internal[mod.META_TRANSITION_NAME]), "rb") as fh:
                res.remote[k] = fh.read() == OBJECTS[k]
        mgr.restore(layer, "tierb", "cold/a.bin", "", 1)
        oi = layer.get_object_info("tierb", "cold/a.bin")
        res.restored.append(mod.restore_expiry(oi.user_defined) > time.time())
        meta_bucket = JAX_META_BUCKET if pkg == "jax" else META_BUCKET
        _, copy = layer.pools[0].get_object(meta_bucket, "restored/tierb/cold/a.bin@null")
        res.restored.append(copy == OBJECTS["cold/a.bin"])
        res.restored.append(mgr.expire_restored_copies(layer))  # unexpired: kept
        past = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(time.time() - 86400))
        layer.put_object_metadata("tierb", "cold/a.bin", "",
                                  updates={mod.META_RESTORE: f'ongoing-request="false", expiry-date="{past}"'})
        res.expired = mgr.expire_restored_copies(layer)
        listing = layer.pools[0].list_objects(meta_bucket, prefix="restored/", max_keys=100)
        res.left = [o.name for o in listing.objects]
        res.stats = (mgr.transitioned_objects, mgr.transitioned_bytes)
        res.get = layer.get_object("tierb", "cold/tiny")[1] == OBJECTS["cold/tiny"]
        out[pkg] = res.__dict__
    assert out["port"] == out["jax"]
    assert out["port"]["internal"]["cold/tiny"] == "InvalidArgument"
    assert out["port"]["restored"] == [True, True, 0] and out["port"]["expired"] == 1
    assert out["port"]["left"] == []
    assert all(out["port"]["read"].values()) and all(out["port"]["remote"].values())


def test_fs_tier_refuses_a_key_outside_its_root(tmp_path):
    b = tiering_mod.FSTierBackend(tiering_mod.TierConfig(name="T", type="fs", dir=str(tmp_path / "cold")))
    with pytest.raises(errors.StorageError):
        b.put("../cold2/escape", b"x")
    assert b.online()


def test_bucket_target_round_trips_like_the_jax_one():
    from minio_tpu.control.replication import BucketTarget as JaxBucketTarget

    d = {"arn": "tier:T", "source_bucket": "", "endpoint": "http://h:1", "target_bucket": "b", "access_key": "a",
         "secret_key": "s", "region": "eu-west-1", "bandwidth": 7, "ignored": 1}
    assert replication.BucketTarget.from_dict(d).to_dict() == JaxBucketTarget.from_dict(d).to_dict()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()
