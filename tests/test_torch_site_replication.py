"""Site replication of minio_tpu_torch on the CPU (control/site_replication.py
over control/replication.py), held against the JAX package's.

The cases of tests/test_site_replication.py run on two port sites served
over HTTP (device="cpu": the kernels' plain versions): after the join,
bucket create/delete, bucket metadata, IAM items and object data mirror
across the sites, with the data on the bucket-replication engine in both
directions. Then a mixed federation, one port site and one JAX site: the
state.json each persists is the same bytes but for its own name, and
buckets, IAM and objects mirror both ways, each key one version on each
site, REPLICA on the site that did not take the PUT. Tolerance: exact.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from minio_tpu import cli as jax_cli
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.control import site_replication as port_sr
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from tests.s3client import S3TestClient

ROOT = "siteroot"
SECRET = "site-secret-key"
ADMIN = "/mtpu/admin/v1"


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Site:
    """One package's node over 4 drives, served at its own URL."""

    def __init__(self, root, name, make_node, run_app_until, env=None):
        port = _free_port()
        self.url = f"http://127.0.0.1:{port}"
        self.name = name
        self.node = make_node([str(root / name / f"d{i}") for i in range(4)], self.url)
        self.stop_evt = threading.Event()
        self.thread, errs = run_app_until(self.node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        with pytest.MonkeyPatch.context() as m:
            for k, v in (env or {}).items():
                m.setenv(k, v)
            self.node.build()
        self.client = S3TestClient(self.url, ROOT, SECRET)

    def spec(self) -> dict:
        return {"name": self.name, "endpoint": self.url, "access_key": ROOT, "secret_key": SECRET}

    def stop(self):
        if not self.stop_evt.is_set():
            self.stop_evt.set()
            self.thread.join(10)
            self.node.close()


def _port(codec):
    return lambda dirs, url: Node(dirs, url=url, root_user=ROOT, root_password=SECRET, codec=codec, device="cpu")


def _jax(dirs, url):
    return JaxNode(dirs, url=url, root_user=ROOT, root_password=SECRET)


HOST = {"MINIO_TPU_CODEC": "host"}


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


def _join(initiator, *sites):
    r = initiator.client.request("POST", f"{ADMIN}/site-replication/add", body=json.dumps(
        {"sites": [s.spec() for s in (initiator, *sites)]}).encode())
    return r


@pytest.fixture(scope="module")
def sites(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("siterepl")
    a = Site(tmp, "site-a", _port(codec), cli._run_app_until)
    b = Site(tmp, "site-b", _port(codec), cli._run_app_until)
    try:
        # Pre-existing state on A that the join must seed to B.
        a.client.make_bucket("preexisting")
        a.client.put_object("preexisting", "seed.txt", b"seeded before join")
        r = _join(a, b)
        assert r.status_code == 200, r.text
        yield a, b
    finally:
        a.stop()
        b.stop()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()


def _drain(site):
    assert site.node.replication.drain(timeout=30.0)


def _until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return pred()


# -- the cases of tests/test_site_replication.py, on two port sites -------------------------


def test_join_status(sites):
    a, b = sites
    for side, me in ((a, "site-a"), (b, "site-b")):
        r = side.client.request("GET", f"{ADMIN}/site-replication/info")
        assert r.status_code == 200
        info = r.json()
        assert info["enabled"] is True and info["name"] == me
        assert {s["name"] for s in info["sites"]} == {"site-a", "site-b"}
        assert all(p["online"] for p in info["sites"] if not p["self"])


def test_preexisting_bucket_seeded(sites):
    a, b = sites
    assert b.client.request("HEAD", "/preexisting").status_code == 200
    _drain(a)
    r = b.client.get_object("preexisting", "seed.txt")
    assert r.status_code == 200 and r.content == b"seeded before join"


def test_new_bucket_mirrors(sites):
    a, b = sites
    a.client.make_bucket("made-on-a")
    assert b.client.request("HEAD", "/made-on-a").status_code == 200
    for side in (a, b):
        r = side.client.request("GET", "/made-on-a", query=[("versioning", "")])
        assert "<Status>Enabled</Status>" in r.text


def test_object_data_replicates_both_ways(sites):
    a, b = sites
    a.client.make_bucket("data-sync")
    a.client.put_object("data-sync", "from-a.bin", b"A" * 50_000)
    _drain(a)
    r = b.client.get_object("data-sync", "from-a.bin")
    assert r.status_code == 200 and r.content == b"A" * 50_000
    b.client.put_object("data-sync", "from-b.bin", b"B" * 30_000)
    _drain(b)
    r = a.client.get_object("data-sync", "from-b.bin")
    assert r.status_code == 200 and r.content == b"B" * 30_000


def test_bucket_policy_mirrors(sites):
    a, b = sites
    a.client.make_bucket("polbkt")
    policy = {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": {"AWS": ["*"]}, "Action": ["s3:GetObject"],
        "Resource": ["arn:aws:s3:::polbkt/*"]}]}
    r = a.client.request("PUT", "/polbkt", query=[("policy", "")], body=json.dumps(policy).encode())
    assert r.status_code == 204, r.text
    r = b.client.request("GET", "/polbkt", query=[("policy", "")])
    assert r.status_code == 200 and json.loads(r.text)["Statement"][0]["Action"] == ["s3:GetObject"]


def test_bucket_tagging_and_lifecycle_mirror(sites):
    a, b = sites
    a.client.make_bucket("metabkt")
    tag_xml = ('<Tagging xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><TagSet>'
               "<Tag><Key>team</Key><Value>storage</Value></Tag></TagSet></Tagging>")
    assert a.client.request("PUT", "/metabkt", query=[("tagging", "")], body=tag_xml.encode()).status_code == 200
    r = b.client.request("GET", "/metabkt", query=[("tagging", "")])
    assert r.status_code == 200 and "<Key>team</Key>" in r.text
    lc_xml = ("<LifecycleConfiguration><Rule><ID>exp</ID><Status>Enabled</Status>"
              "<Filter><Prefix>tmp/</Prefix></Filter><Expiration><Days>7</Days></Expiration>"
              "</Rule></LifecycleConfiguration>")
    assert a.client.request("PUT", "/metabkt", query=[("lifecycle", "")], body=lc_xml.encode()).status_code == 200
    r = b.client.request("GET", "/metabkt", query=[("lifecycle", "")])
    assert r.status_code == 200 and "<ID>exp</ID>" in r.text


def test_iam_mirrors(sites):
    a, b = sites
    doc = {"Version": "2012-10-17",
           "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::*"]}]}
    assert a.client.request("PUT", f"{ADMIN}/policies/site-shared", body=json.dumps(doc).encode()).status_code == 200
    assert "site-shared" in b.client.request("GET", f"{ADMIN}/policies").json()
    r = a.client.request("POST", f"{ADMIN}/users", body=json.dumps(
        {"accessKey": "siteuser", "secretKey": "siteuser-secret", "policies": ["site-shared"]}).encode())
    assert r.status_code == 200, r.text
    users = b.client.request("GET", f"{ADMIN}/users").json()
    assert "siteuser" in users and users["siteuser"]["policies"] == ["site-shared"]
    ub = S3TestClient(b.url, "siteuser", "siteuser-secret")
    assert ub.request("GET", "/data-sync", query=[("location", "")]).status_code in (200, 403)
    assert a.client.request("DELETE", f"{ADMIN}/users/siteuser").status_code == 200
    assert "siteuser" not in b.client.request("GET", f"{ADMIN}/users").json()


def test_delete_marker_replicates(sites):
    a, b = sites
    a.client.make_bucket("delbkt")
    a.client.put_object("delbkt", "gone.txt", b"bye")
    _drain(a)
    assert b.client.get_object("delbkt", "gone.txt").status_code == 200
    assert a.client.request("DELETE", "/delbkt/gone.txt").status_code == 204
    _drain(a)
    assert _until(lambda: b.client.get_object("delbkt", "gone.txt").status_code == 404, 10)


def test_bucket_delete_mirrors(sites):
    a, b = sites
    a.client.make_bucket("shortlived")
    assert b.client.request("HEAD", "/shortlived").status_code == 200
    assert a.client.request("DELETE", "/shortlived").status_code == 204
    assert b.client.request("HEAD", "/shortlived").status_code == 404


def test_join_rejects_nonempty_peer(tmp_path, codec):
    a = Site(tmp_path, "na", _port(codec), cli._run_app_until)
    b = Site(tmp_path, "nb", _port(codec), cli._run_app_until)
    try:
        b.client.make_bucket("already-there")
        r = _join(a, b)
        assert r.status_code == 400 and "not empty" in r.text
        for side in (a, b):
            assert side.client.request("GET", f"{ADMIN}/site-replication/info").json()["enabled"] is False
    finally:
        a.stop()
        b.stop()


def test_down_peer_does_not_fail_local_writes(tmp_path, codec):
    a = Site(tmp_path, "da", _port(codec), cli._run_app_until)
    b = Site(tmp_path, "db", _port(codec), cli._run_app_until)
    try:
        assert _join(a, b).status_code == 200
        a.client.make_bucket("survivor")
        b.stop()  # peer outage
        tag_xml = "<Tagging><TagSet><Tag><Key>k</Key><Value>v</Value></Tag></TagSet></Tagging>"
        r = a.client.request("PUT", "/survivor", query=[("tagging", "")], body=tag_xml.encode())
        assert r.status_code == 200, r.text
        sr = a.node.site_repl
        assert sr.pending_fanout() >= 1 and "db" in sr.last_errors
    finally:
        a.stop()
        b.stop()


# -- a mixed federation: one port site, one JAX site ---------------------------------------


@pytest.fixture(scope="module")
def mixed(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("mixedsites")
    port = Site(tmp, "port-site", _port(codec), cli._run_app_until)
    jax = Site(tmp, "jax-site", _jax, jax_cli._run_app_until, env=HOST)
    try:
        port.client.make_bucket("seeded")
        port.client.put_object("seeded", "before-join", b"seed from the port site")
        r = _join(port, jax)
        assert r.status_code == 200, r.text
        yield {"port": port, "jax": jax}
    finally:
        port.stop()
        jax.stop()


def test_mixed_state_json_is_the_same_bytes(mixed):
    raw = {name: site.node.site_repl.store.get(port_sr.STATE_PATH) for name, site in mixed.items()}
    assert raw["port"] and raw["jax"]
    doc = json.loads(raw["port"])
    assert doc["self_name"] == "port-site" and json.loads(raw["jax"])["self_name"] == "jax-site"
    assert raw["jax"] == raw["port"].replace(b'"self_name": "port-site"', b'"self_name": "jax-site"')


@pytest.mark.parametrize("maker", ["port", "jax"])
def test_mixed_buckets_mirror_both_ways(mixed, maker):
    other = "jax" if maker == "port" else "port"
    name = f"made-on-{maker}"
    assert mixed[maker].client.make_bucket(name).status_code == 200
    assert mixed[other].client.request("HEAD", f"/{name}").status_code == 200
    r = mixed[other].client.request("GET", f"/{name}", query=[("versioning", "")])
    assert "<Status>Enabled</Status>" in r.text
    assert mixed[maker].client.request("DELETE", f"/{name}").status_code == 204
    assert mixed[other].client.request("HEAD", f"/{name}").status_code == 404


@pytest.mark.parametrize("maker", ["port", "jax"])
def test_mixed_iam_mirrors_both_ways(mixed, maker):
    other = "jax" if maker == "port" else "port"
    c = mixed[maker].client
    pol = f"read-{maker}"
    doc = {"Version": "2012-10-17",
           "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::*"]}]}
    assert c.request("PUT", f"{ADMIN}/policies/{pol}", body=json.dumps(doc).encode()).status_code == 200
    ak = f"user-{maker}"
    assert c.request("POST", f"{ADMIN}/users", body=json.dumps(
        {"accessKey": ak, "secretKey": f"{ak}-secret", "policies": [pol]}).encode()).status_code == 200
    r = c.request("POST", f"{ADMIN}/service-accounts", body=json.dumps({"parent": ak}).encode())
    assert r.status_code == 200, r.text
    sa = r.json()["accessKey"]
    r = c.request("PUT", f"{ADMIN}/idp/ldap/policy", body=json.dumps(
        {"dn": f"uid={maker},ou=people,dc=example,dc=org", "policies": [pol]}).encode())
    assert r.status_code == 200, r.text
    theirs = mixed[other].node.iam
    assert theirs.custom_policies[pol] == doc
    assert theirs.users[ak].policies == [pol] and theirs.users[ak].credentials.secret_key == f"{ak}-secret"
    assert theirs.users[sa].parent_user == ak
    assert theirs.ldap_policies_for(f"uid={maker},ou=people,dc=example,dc=org", []) == [pol]
    mine = mixed[maker].node.iam
    assert theirs.users[sa].to_dict() == mine.users[sa].to_dict()


OBJECTS = {
    name: np.random.default_rng(1500 + i).integers(0, 256, n, dtype=np.uint8).tobytes()
    for i, (name, n) in enumerate((("a", 3_000), ("b", 70_000)))
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_objects_mirror_without_ping_pong(mixed, writer):
    other = "jax" if writer == "port" else "port"
    bucket = f"objs-{writer}"
    assert mixed[writer].client.make_bucket(bucket).status_code == 200
    vids = {}
    for key, data in OBJECTS.items():
        r = mixed[writer].client.put_object(bucket, key, data)
        assert r.status_code == 200
        vids[key] = r.headers["x-amz-version-id"]
    for site in mixed.values():
        _drain(site)
    _drain(mixed[writer])  # nothing bounced back
    for key, data in OBJECTS.items():
        r = mixed[other].client.get_object(bucket, key)
        assert r.status_code == 200 and r.content == data
        assert r.headers["x-amz-version-id"] == vids[key]
        assert r.headers["x-amz-replication-status"] == "REPLICA"
        assert mixed[writer].client.request("HEAD", f"/{bucket}/{key}").headers[
            "x-amz-replication-status"] == "COMPLETED"
    for site in mixed.values():
        listing = site.client.request("GET", f"/{bucket}", query=[("versions", "")]).text
        assert listing.count("<Version>") == len(OBJECTS), listing
    r = mixed[other].client.get_object("seeded", "before-join")
    assert r.status_code == 200 and r.content == b"seed from the port site"
