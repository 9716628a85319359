"""Bucket replication of minio_tpu_torch on the CPU (control/replication.py:
BucketTargetSys, the rule parse, ReplicationSys's workers, resync and the
replica write), held against the JAX package's.

The cases of tests/test_replication.py run on a pair of port nodes served
over HTTP (device="cpu": the kernels' plain versions). Then the two
packages meet: a port source and a JAX source each replicate to a JAX
target and a port target that share one format.json, so both targets get
the same replica request; their replicas must be the same part files and
xl.meta fields, and keep the source's bytes, version id, metadata and
tags, with REPLICA on the targets and COMPLETED on the source. Neither
package's front reads the x-minio-source-mtime header the source sends, so
a replica's mtime is its target's write time in both (checked as such).
The rule parse gives equal rules, a target sealed by one package unseals in the
other, and after a throttled send admin /bandwidth, the peer `bandwidth`
verb and /metrics read one monitor. Tolerance: exact.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from minio_tpu import cli as jax_cli
from minio_tpu.control import kms as jax_kms
from minio_tpu.control import replication as jax_repl
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object.types import GetObjectOptions as JaxGetObjectOptions
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.control import bandwidth as bw_mod
from minio_tpu_torch.control import kms as port_kms
from minio_tpu_torch.control import replication as port_repl
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.dist.peer import PeerClient
from minio_tpu_torch.object.types import GetObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage.local import LocalDrive
from tests.s3client import S3TestClient

ROOT = "replroot"
SECRET = "repl-secret-key"
ADMIN = "/mtpu/admin/v1"
SYS = ".minio_tpu.sys"
# Past the 128 KiB inline limit: the replica PUT streams and commits part files.
STREAMED = np.random.default_rng(15).integers(0, 256, 140 * 1024, dtype=np.uint8).tobytes()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Served:
    """One package's node over `dirs`, served on a loopback port."""

    def __init__(self, dirs, make_node, run_app_until, env=None):
        self.dirs = dirs
        self.node = make_node(dirs)
        self.stop_evt = threading.Event()
        port = _free_port()
        self.thread, errs = run_app_until(self.node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        with pytest.MonkeyPatch.context() as m:
            for k, v in (env or {}).items():
                m.setenv(k, v)
            self.node.build()
        self.url = f"http://127.0.0.1:{port}"
        self.client = S3TestClient(self.url, ROOT, SECRET)

    def stop(self):
        self.stop_evt.set()
        self.thread.join(10)
        self.node.close()


def _port(codec):
    return lambda dirs: Node(dirs, root_user=ROOT, root_password=SECRET, codec=codec, device="cpu")


def _jax(dirs):
    return JaxNode(dirs, root_user=ROOT, root_password=SECRET)


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("repl")
    src = Served([str(tmp / "src" / f"d{i}") for i in range(4)], _port(codec), cli._run_app_until)
    dst = Served([str(tmp / "dst" / f"d{i}") for i in range(4)], _port(codec), cli._run_app_until)
    try:
        yield src, dst
    finally:
        src.stop()
        dst.stop()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()


def _enable_versioning(client, bucket):
    xml = (
        '<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
        "<Status>Enabled</Status></VersioningConfiguration>"
    )
    r = client.request("PUT", f"/{bucket}", query=[("versioning", "")], body=xml.encode())
    assert r.status_code == 200, r.text


def _target(src, dst, bucket, bandwidth=0):
    r = src.client.request("POST", f"{ADMIN}/replication/target", body=json.dumps({
        "bucket": bucket, "endpoint": dst.url, "targetBucket": bucket, "accessKey": ROOT, "secretKey": SECRET,
        "bandwidth": bandwidth}).encode())
    assert r.status_code == 200, r.text
    return r.json()["arn"]


def _rule(arn, rid="r1", priority=1, extra=""):
    return (
        f"<Rule><ID>{rid}</ID><Status>Enabled</Status><Priority>{priority}</Priority>"
        "<DeleteMarkerReplication><Status>Enabled</Status></DeleteMarkerReplication>"
        f"{extra}<Filter><Prefix></Prefix></Filter>"
        f"<Destination><Bucket>{arn}</Bucket></Destination></Rule>"
    )


def _set_rules(src, bucket, rules):
    xml = ('<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><Role></Role>'
           + "".join(rules) + "</ReplicationConfiguration>")
    r = src.client.request("PUT", f"/{bucket}", query=[("replication", "")], body=xml.encode())
    assert r.status_code == 200, r.text


def _configure(src, dst, bucket, extra_rule_xml=""):
    """Register dst as a remote target and install a replication rule."""
    arn = _target(src, dst, bucket)
    _set_rules(src, bucket, [_rule(arn, extra=extra_rule_xml)])
    return arn


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return pred()


# -- the cases of tests/test_replication.py, on a port pair ----------------------------------


class TestReplication:
    def test_put_replicates(self, pair):
        src, dst = pair
        assert src.client.make_bucket("rbkt").status_code == 200
        assert dst.client.make_bucket("rbkt").status_code == 200
        _enable_versioning(src.client, "rbkt")
        _enable_versioning(dst.client, "rbkt")
        _configure(src, dst, "rbkt")
        r = src.client.put_object("rbkt", "hello.txt", b"replicate me",
                                  headers={"x-amz-meta-color": "green", "Content-Type": "text/plain"})
        assert r.status_code == 200
        src_vid = r.headers["x-amz-version-id"]
        assert src.node.replication.drain(15)
        r = dst.client.request("GET", "/rbkt/hello.txt")
        assert r.status_code == 200 and r.content == b"replicate me"
        assert r.headers["x-amz-meta-color"] == "green"
        assert r.headers["x-amz-replication-status"] == "REPLICA"
        assert r.headers["x-amz-version-id"] == src_vid
        r = src.client.request("HEAD", "/rbkt/hello.txt")
        assert r.headers["x-amz-replication-status"] == "COMPLETED"

    def test_delete_marker_replicates(self, pair):
        src, dst = pair
        src.client.put_object("rbkt", "doomed.txt", b"bye")
        assert src.node.replication.drain(15)
        assert dst.client.request("HEAD", "/rbkt/doomed.txt").status_code == 200
        r = src.client.request("DELETE", "/rbkt/doomed.txt")
        assert r.status_code == 204 and r.headers.get("x-amz-delete-marker") == "true"
        assert src.node.replication.drain(15)
        assert dst.client.request("HEAD", "/rbkt/doomed.txt").status_code == 404

    def test_status_endpoint(self, pair):
        src, _ = pair
        r = src.client.request("GET", f"{ADMIN}/replication/status")
        assert r.status_code == 200
        stats = r.json()
        assert stats["completed"] >= 2 and stats["replicatedBytes"] > 0

    def test_resync_existing_objects(self, pair):
        src, dst = pair
        assert src.client.make_bucket("oldbkt").status_code == 200
        assert dst.client.make_bucket("oldbkt").status_code == 200
        _enable_versioning(src.client, "oldbkt")
        _enable_versioning(dst.client, "oldbkt")
        for i in range(3):
            src.client.put_object("oldbkt", f"pre-{i}", f"old {i}".encode())
        _configure(src, dst, "oldbkt",
                   extra_rule_xml="<ExistingObjectReplication><Status>Enabled</Status></ExistingObjectReplication>")
        r = src.client.request("POST", f"{ADMIN}/replication/resync", body=json.dumps({"bucket": "oldbkt"}).encode())
        assert r.status_code == 200, r.text
        assert r.json()["queued"] == 3
        assert src.node.replication.drain(15)
        for i in range(3):
            r = dst.client.request("GET", f"/oldbkt/pre-{i}")
            assert r.status_code == 200 and r.content == f"old {i}".encode()

    def test_replica_not_re_replicated(self, pair):
        _, dst = pair
        r = dst.client.request("HEAD", "/rbkt/hello.txt")
        assert r.headers["x-amz-replication-status"] == "REPLICA"

    def test_rule_prefix_filter(self, pair):
        src, dst = pair
        assert src.client.make_bucket("pfx").status_code == 200
        assert dst.client.make_bucket("pfx").status_code == 200
        arn = _target(src, dst, "pfx")
        xml = ('<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
               "<Rule><ID>p</ID><Status>Enabled</Status><Priority>1</Priority>"
               "<Filter><Prefix>logs/</Prefix></Filter>"
               f"<Destination><Bucket>{arn}</Bucket></Destination></Rule></ReplicationConfiguration>")
        assert src.client.request("PUT", "/pfx", query=[("replication", "")], body=xml.encode()).status_code == 200
        src.client.put_object("pfx", "logs/a", b"in scope")
        src.client.put_object("pfx", "data/b", b"out of scope")
        assert src.node.replication.drain(15)
        assert dst.client.request("HEAD", "/pfx/logs/a").status_code == 200
        assert dst.client.request("HEAD", "/pfx/data/b").status_code == 404

    def test_forged_replica_header_denied(self, pair):
        src, _ = pair
        doc = {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject", "s3:ListBucket"],
            "Resource": ["arn:aws:s3:::*"]}]}
        assert src.client.request("PUT", f"{ADMIN}/policies/putonly", body=json.dumps(doc).encode()).status_code == 200
        r = src.client.request("POST", f"{ADMIN}/users", body=json.dumps(
            {"accessKey": "mallory", "secretKey": "mallory-secret1", "policies": ["putonly"]}).encode())
        assert r.status_code == 200, r.text
        mallory = S3TestClient(src.url, "mallory", "mallory-secret1")
        r = mallory.put_object("rbkt", "forged.txt", b"evil", headers={
            "x-minio-source-replication-request": "true",
            "x-minio-source-version-id": "00000000-0000-0000-0000-000000000001"})
        assert r.status_code == 403

    def test_version_delete_replicates_versioned(self, pair):
        src, dst = pair
        assert src.client.make_bucket("vdel").status_code == 200
        assert dst.client.make_bucket("vdel").status_code == 200
        _enable_versioning(src.client, "vdel")
        _enable_versioning(dst.client, "vdel")
        _configure(src, dst, "vdel", extra_rule_xml="<DeleteReplication><Status>Enabled</Status></DeleteReplication>")
        v1 = src.client.put_object("vdel", "k", b"one").headers["x-amz-version-id"]
        v2 = src.client.put_object("vdel", "k", b"two").headers["x-amz-version-id"]
        assert src.node.replication.drain(15)
        assert src.client.request("DELETE", "/vdel/k", query=[("versionId", v1)]).status_code == 204
        assert src.node.replication.drain(15)
        r = dst.client.request("GET", "/vdel/k")
        assert r.status_code == 200 and r.content == b"two" and r.headers["x-amz-version-id"] == v2
        assert dst.client.request("GET", "/vdel/k", query=[("versionId", v1)]).status_code == 404

    def test_tags_replicate(self, pair):
        src, dst = pair
        r = src.client.put_object("rbkt", "tagged.txt", b"tagged", headers={"x-amz-tagging": "env=prod&team=ml"})
        assert r.status_code == 200
        assert src.node.replication.drain(15)
        r = dst.client.request("GET", "/rbkt/tagged.txt", query=[("tagging", "")])
        assert r.status_code == 200 and "env" in r.text and "prod" in r.text

    def test_bulk_delete_replicates(self, pair):
        src, dst = pair
        for i in range(3):
            src.client.put_object("rbkt", f"bulk-{i}", b"x")
        assert src.node.replication.drain(15)
        for i in range(3):
            assert dst.client.request("HEAD", f"/rbkt/bulk-{i}").status_code == 200
        xml = "<Delete>" + "".join(f"<Object><Key>bulk-{i}</Key></Object>" for i in range(3)) + "</Delete>"
        r = src.client.request("POST", "/rbkt", query=[("delete", "")], body=xml.encode(), headers={
            "Content-Md5": base64.b64encode(hashlib.md5(xml.encode()).digest()).decode()})
        assert r.status_code == 200, r.text
        assert src.node.replication.drain(15)
        for i in range(3):
            assert dst.client.request("HEAD", f"/rbkt/bulk-{i}").status_code == 404

    def test_active_active_no_ping_pong(self, pair):
        src, dst = pair
        for c in (src.client, dst.client):
            assert c.make_bucket("bidir").status_code == 200
            _enable_versioning(c, "bidir")
        _configure(src, dst, "bidir")
        _configure(dst, src, "bidir")
        src.client.put_object("bidir", "ping", b"pong")
        assert src.node.replication.drain(15)
        assert dst.node.replication.drain(15)
        assert src.node.replication.drain(5)
        assert dst.client.request("HEAD", "/bidir/ping").headers["x-amz-replication-status"] == "REPLICA"
        src.client.request("DELETE", "/bidir/ping")
        assert src.node.replication.drain(15)
        assert dst.node.replication.drain(15)
        assert src.node.replication.drain(5)
        for c in (src.client, dst.client):
            r = c.request("GET", "/bidir", query=[("versions", "")])
            assert r.text.count("<DeleteMarker>") == 1, r.text

    @pytest.mark.skipif(port_kms.AESGCM is None, reason="cryptography not installed: secrets unsealed")
    def test_target_secret_sealed_at_rest(self, pair):
        src, _ = pair
        raw = src.node.s3.bucket_meta.get("rbkt").targets_json
        assert SECRET not in raw and "sealed:" in raw
        ts = src.node.replication.targets.list_targets("rbkt")
        assert ts and ts[0].secret_key == SECRET

    def test_target_listing_and_removal(self, pair):
        src, _ = pair
        targets = src.client.request("GET", f"{ADMIN}/replication/target", query=[("bucket", "pfx")]).json()
        assert len(targets) == 1 and "secret_key" not in targets[0]
        r = src.client.request("DELETE", f"{ADMIN}/replication/target",
                               body=json.dumps({"bucket": "pfx", "arn": targets[0]["arn"]}).encode())
        assert r.status_code == 200
        assert src.client.request("GET", f"{ADMIN}/replication/target", query=[("bucket", "pfx")]).json() == []


class TestBandwidth:
    def test_token_bucket_and_monitor(self):
        tb = bw_mod._TokenBucket(100_000)
        assert tb.consume(50_000) == 0.0
        t0 = time.monotonic()
        tb.consume(100_000)
        assert time.monotonic() - t0 >= 0.3
        mon = bw_mod.BandwidthMonitor()
        mon.set_limit("b", "arn:x", 1_000_000)
        mon.record("b", "arn:x", 500_000)
        rep = mon.report()
        assert rep["b"]["arn:x"]["limitInBytesPerSecond"] == 1_000_000
        assert rep["b"]["arn:x"]["currentBandwidthInBytesPerSecond"] > 0
        mon.set_limit("b", "arn:x", 0)
        assert mon.throttle("b", "arn:x", 10_000_000) == 0.0

    def test_throttled_replication_and_one_monitor(self, pair, monkeypatch):
        """After a throttled replica send, admin /bandwidth, the peer
        `bandwidth` verb and /metrics report the same limit and rate: all
        three read the node's ReplicationSys.bandwidth (the clock is frozen
        for the three reads, so the sliding-window rate is one number)."""
        src, dst = pair
        for c in (src.client, dst.client):
            assert c.make_bucket("bwbkt").status_code in (200, 409)
            _enable_versioning(c, "bwbkt")
        # An inline object (under 128 KiB: the CPU's plain hash is slow on
        # part files), 72 KB past the 48 KB burst at 48 KB/s.
        arn = _target(src, dst, "bwbkt", bandwidth=48_000)
        _set_rules(src, "bwbkt", [_rule(arn, rid="bw")])
        t0 = time.monotonic()
        assert src.client.put_object("bwbkt", "big", b"z" * 120_000).status_code == 200
        assert src.node.replication.drain(30)
        assert dst.client.get_object("bwbkt", "big").content == b"z" * 120_000
        assert time.monotonic() - t0 >= 1.0
        frozen = time.monotonic()
        monkeypatch.setattr(bw_mod, "time", SimpleNamespace(monotonic=lambda: frozen, sleep=time.sleep))
        admin_rep = src.client.request("GET", f"{ADMIN}/bandwidth", query=[("bucket", "bwbkt")]).json()["bwbkt"][arn]
        peer_rep = PeerClient(src.url, src.node.token).bandwidth("bwbkt")["bwbkt"][arn]
        metrics = src.client.request("GET", f"{ADMIN}/metrics").text
        labels = f'{{bucket="bwbkt",arn="{arn}"}}'
        scraped = {
            name: float(line.split()[-1]) for line in metrics.splitlines()
            for name in ("minio_tpu_replication_link_limit_bytes_per_second",
                         "minio_tpu_replication_link_bytes_per_second")
            if line.startswith(name + labels)
        }
        assert admin_rep == peer_rep
        assert admin_rep["limitInBytesPerSecond"] == 48_000
        assert 0 < admin_rep["currentBandwidthInBytesPerSecond"]
        assert scraped == {
            "minio_tpu_replication_link_limit_bytes_per_second": 48_000.0,
            "minio_tpu_replication_link_bytes_per_second": admin_rep["currentBandwidthInBytesPerSecond"],
        }
        assert src.node.replication.bandwidth.report("bwbkt")["bwbkt"][arn] == admin_rep
        assert not hasattr(src.node, "bandwidth")


def test_close_does_not_wait_out_a_stuck_send(monkeypatch):
    """A worker inside a replica send to a target that stopped answering
    (TargetClient's 30 s timeout) holds close() for its timeout at most,
    shared by all the threads; close() then says so, and a second close()
    (the node's, after the server's own) does not wait again."""
    inside, release = threading.Event(), threading.Event()

    def stuck(self, task):
        inside.set()
        release.wait(30)
        return True

    monkeypatch.setattr(port_repl.ReplicationSys, "_replicate", stuck)
    rs = port_repl.ReplicationSys(layer=None, bucket_meta=None, targets=None, workers=2)
    try:
        rs._enqueue(port_repl.ReplTask("bucket", "object"))
        assert inside.wait(10)
        t0 = time.monotonic()
        assert rs.close(timeout=0.5) is False
        assert 0.5 <= time.monotonic() - t0 < 2.0
        t0 = time.monotonic()
        assert rs.close() is False
        assert time.monotonic() - t0 < 0.2
    finally:
        release.set()
    for t in [*rs._threads, rs._retry_thread]:
        t.join(5)
    assert rs.close() is True


class TestReplicationReset:
    def test_reset_requeues_existing(self, pair):
        src, dst = pair
        for c in (src.client, dst.client):
            assert c.make_bucket("rstbkt").status_code in (200, 409)
            _enable_versioning(c, "rstbkt")
        assert src.client.put_object("rstbkt", "pre-existing", b"old data").status_code == 200
        _configure(src, dst, "rstbkt",
                   extra_rule_xml="<ExistingObjectReplication><Status>Enabled</Status></ExistingObjectReplication>")
        assert dst.client.get_object("rstbkt", "pre-existing").status_code == 404
        r = src.client.request("PUT", "/rstbkt", query=[("replication-reset", "")])
        assert r.status_code == 200, r.text
        assert r.json()["queued"] >= 1
        assert _wait_for(lambda: dst.client.get_object("rstbkt", "pre-existing").status_code == 200, 15)
        assert dst.client.get_object("rstbkt", "pre-existing").content == b"old data"

    def test_reset_without_config_errors(self, pair):
        src, _ = pair
        assert src.client.make_bucket("norepl").status_code in (200, 409)
        r = src.client.request("PUT", "/norepl", query=[("replication-reset", "")])
        assert r.status_code == 404 and b"ReplicationConfigurationNotFoundError" in r.content


class TestReplicationMetrics:
    def test_metrics_and_s3_endpoint(self, pair):
        src, dst = pair
        for c in (src.client, dst.client):
            assert c.make_bucket("metbkt").status_code in (200, 409)
            _enable_versioning(c, "metbkt")
        _configure(src, dst, "metbkt")
        assert src.client.put_object("metbkt", "m1", b"metrics!").status_code == 200
        assert src.node.replication.drain(15)
        body = src.client.request("GET", f"{ADMIN}/metrics").text
        assert "minio_tpu_replication_completed_total" in body
        assert "minio_tpu_replication_sent_bytes" in body
        assert 'minio_tpu_replication_link_bytes_per_second{bucket="metbkt"' in body
        r = src.client.request("GET", "/metbkt", query=[("replication-metrics", "")])
        assert r.status_code == 200, r.text
        doc = r.json()
        assert doc["completed"] >= 1 and "pending" in doc


# -- the two packages meet ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed(tmp_path_factory, pair, codec):
    """A JAX source and a JAX target, and a port target formatted with the
    JAX target's format.json (so both targets place each object alike)."""
    tmp = tmp_path_factory.mktemp("mixed")
    host = {"MINIO_TPU_CODEC": "host"}
    jsrc = Served([str(tmp / "jsrc" / f"d{i}") for i in range(4)], _jax, jax_cli._run_app_until, env=host)
    jdst = Served([str(tmp / "jdst" / f"d{i}") for i in range(4)], _jax, jax_cli._run_app_until, env=host)
    pdirs = [str(tmp / "pdst" / f"d{i}") for i in range(4)]
    for jd, pd in zip(jdst.dirs, pdirs):
        os.makedirs(os.path.join(pd, SYS))
        shutil.copy(os.path.join(jd, SYS, "format.json"), os.path.join(pd, SYS, "format.json"))
    pdst = Served(pdirs, _port(codec), cli._run_app_until)
    psrc = pair[0]
    try:
        for side in (psrc, jsrc, jdst, pdst):
            for bucket in ("xport", "xjax"):
                assert side.client.make_bucket(bucket).status_code == 200
                _enable_versioning(side.client, bucket)
        # Each source replicates its bucket to both targets.
        for src, bucket in ((psrc, "xport"), (jsrc, "xjax")):
            arns = [_target(src, dst, bucket) for dst in (jdst, pdst)]
            _set_rules(src, bucket, [_rule(arn, rid=f"to-{i}", priority=10 - i) for i, arn in enumerate(arns)])
        yield SimpleNamespace(sources={"port": (psrc, "xport"), "jax": (jsrc, "xjax")}, jdst=jdst, pdst=pdst)
    finally:
        for side in (jsrc, jdst, pdst):
            side.stop()


def _replica_tree(dirs, local_drive, bucket, key, version_id):
    """Per drive: the version's xl.meta fields and its data, through the
    package's own LocalDrive."""
    out = []
    for d in dirs:
        fi = local_drive(d).read_version(bucket, key, version_id)
        e = fi.erasure
        if fi.inline_data:
            data = b"inline:" + bytes(fi.inline_data)
        else:
            with open(os.path.join(d, bucket, key, fi.data_dir, "part.1"), "rb") as f:
                data = f.read()
        out.append((
            fi.version_id, fi.mod_time, fi.size, sorted(fi.metadata.items()), e.data_blocks, e.parity_blocks,
            e.index, list(e.distribution), [(p.number, p.size, p.actual_size) for p in fi.parts],
            [dict(c) for c in e.checksums], hashlib.sha256(data).hexdigest(),
        ))
    return out


OBJECTS = {"inline": b"replicated across packages" * 8, "streamed": STREAMED}


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_replicas_equal_across_packages(mixed, source, name):
    src, bucket = mixed.sources[source]
    data = OBJECTS[name]
    r = src.client.put_object(bucket, name, data, headers={
        "x-amz-meta-origin": source, "Content-Type": "application/x-test", "x-amz-tagging": "pkg=both&n=2"})
    assert r.status_code == 200, r.text
    vid = r.headers["x-amz-version-id"]
    assert src.node.replication.drain(30)
    opts = GetObjectOptions(vid) if source == "port" else JaxGetObjectOptions(vid)
    soi = src.node.pools.get_object_info(bucket, name, opts)
    for dst in (mixed.jdst, mixed.pdst):
        r = dst.client.request("GET", f"/{bucket}/{name}")
        assert r.status_code == 200 and r.content == data
        assert r.headers["x-amz-version-id"] == vid
        assert r.headers["x-amz-replication-status"] == "REPLICA"
        assert r.headers["x-amz-meta-origin"] == source
        assert r.headers["Content-Type"] == "application/x-test"
        tags = dst.client.request("GET", f"/{bucket}/{name}", query=[("tagging", "")])
        assert "<Key>pkg</Key><Value>both</Value>" in tags.text
    assert src.client.request("HEAD", f"/{bucket}/{name}").headers["x-amz-replication-status"] == "COMPLETED"
    jtree = _replica_tree(mixed.jdst.dirs, JaxLocalDrive, bucket, name, vid)
    ptree = _replica_tree(mixed.pdst.dirs, LocalDrive, bucket, name, vid)
    # The mtime is each target's own write time; every other field is equal.
    assert [(v, *rest) for v, _, *rest in ptree] == [(v, *rest) for v, _, *rest in jtree]
    assert {v for v, *_ in ptree} == {vid}
    for tree in (ptree, jtree):
        assert len({m for _, m, *_ in tree}) == 1 and tree[0][1] > soi.mod_time


XMLS = {
    "one": '<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><Rule><ID>a</ID>'
           "<Status>Enabled</Status><Priority>3</Priority><Filter><Prefix>logs/</Prefix></Filter>"
           "<Destination><Bucket>arn:minio:replication:us-east-1:1:b</Bucket></Destination>"
           "<DeleteMarkerReplication><Status>Enabled</Status></DeleteMarkerReplication></Rule>"
           "</ReplicationConfiguration>",
    "priorities": "<ReplicationConfiguration>" + "".join(
        f"<Rule><ID>r{i}</ID><Status>{'Disabled' if i == 1 else 'Enabled'}</Status><Priority>{p}</Priority>"
        f"<Filter><And><Prefix>p{i}/</Prefix></And></Filter><Destination><Bucket>arn{i}</Bucket></Destination>"
        "<DeleteReplication><Status>Enabled</Status></DeleteReplication>"
        "<ExistingObjectReplication><Status>Enabled</Status></ExistingObjectReplication></Rule>"
        for i, p in enumerate((1, 7, 4))) + "</ReplicationConfiguration>",
    "legacy-prefix": "<ReplicationConfiguration><Rule><Prefix>old/</Prefix><Destination><Bucket>x</Bucket>"
                     "</Destination></Rule></ReplicationConfiguration>",
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(XMLS))
def test_parse_replication_xml_equals_jax(case):
    raw = XMLS[case]
    assert [r.__dict__ for r in port_repl.parse_replication_xml(raw)] == [
        r.__dict__ for r in jax_repl.parse_replication_xml(raw)]
    assert [r.__dict__ for r in port_repl.parse_replication_xml(raw.encode())] == [
        r.__dict__ for r in jax_repl.parse_replication_xml(raw)]


class _Meta:
    """The bucket-metadata surface BucketTargetSys uses, in memory."""

    def __init__(self):
        self.docs: dict[str, SimpleNamespace] = {}

    def get(self, bucket):
        return self.docs.setdefault(bucket, SimpleNamespace(targets_json=""))

    def update(self, bucket, **fields):
        for k, v in fields.items():
            setattr(self.get(bucket), k, v)


@pytest.mark.skipif(port_kms.AESGCM is None, reason="cryptography not installed: secrets unsealed")
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sealed_target_unseals_in_the_other_package(writer):
    master = bytes(range(32))
    meta = _Meta()
    systems = {
        "port": port_repl.BucketTargetSys(meta, kms=port_kms.StaticKeyKMS("repl-key", master)),
        "jax": jax_repl.BucketTargetSys(meta, kms=jax_kms.StaticKeyKMS("repl-key", master)),
    }
    reader = "jax" if writer == "port" else "port"
    arn = systems[writer].set_target("bkt", "http://127.0.0.1:9", "tb", "ak", "sealed-secret", bandwidth=5)
    raw = meta.get("bkt").targets_json
    assert "sealed-secret" not in raw
    (t,) = systems[reader].list_targets("bkt")
    assert (t.arn, t.endpoint, t.target_bucket, t.access_key, t.secret_key, t.bandwidth) == (
        arn, "http://127.0.0.1:9", "tb", "ak", "sealed-secret", 5)
    assert systems[reader].bandwidth_of("bkt", arn) == 5
