"""The port's distribution layer as a cluster, held against the JAX package's.

Two nodes of each package run in this process, each with its own HTTP server
on a localhost port and the same ordered endpoint list (2 nodes x 4 drives,
one 8-drive set), built concurrently: the leader formats, the other waits
for quorum over storage REST. The port's drives get the JAX cluster's
format.json files first, so both place every object the same way. The same
signed requests then go to both clusters: a PUT on node A read on node B, a
delete that propagates, a bucket policy set on A that applies on B, a user
added on A who signs in on B, admin /info, /toplocks and /chaos across the
peers. Mod times and uuids are pinned for each PUT as test_torch_compress.py
pins them, so every drive's part files and xl.meta are equal byte for byte,
and so are the S3 answers.

Then, on port clusters of their own: a read that survives a node's loss and
a write during the loss that heals on rejoin (3 nodes x 2 drives, a 6-drive
set, as tests/test_dist.py does it: one node's loss leaves the write
quorum), a mixed cluster of one JAX node and one port node over one 8-drive
set, the peer routes that wait for later slices, and (on the card) a
two-node cluster over the CUDA codec.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
import uuid

import numpy as np
import pytest
import requests

from minio_tpu import cli as jax_cli
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object import erasure as jax_erasure
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.dist import peer as port_peer
from minio_tpu_torch.dist.locks import NamespaceLock, RemoteLocker
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.dist.peer import NOT_PORTED_PEER_ROUTES, PEER_PREFIX, PeerClient
from minio_tpu_torch.dist.storage_rest import RemoteDrive
from minio_tpu_torch.dist.transport import TOKEN_HEADER
from minio_tpu_torch.object import erasure as port_erasure
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from tests.s3client import S3TestClient

ROOT, SECRET = "clusteradmin", "cluster-secret-key"
USER = ("distuser", "dist-user-secret")
ADMIN = "/mtpu/admin/v1"
MOD_TIME = 1_760_000_000.5
SIZES = {"tiny": 3 * 1024, "small": 40 * 1024, "mid": 150 * 1024}  # mid: past the inline limit


def _bodies() -> dict:
    rng = np.random.default_rng(12)
    return {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for k, n in SIZES.items()}


BODIES = _bodies()
POLICY = {
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
                   "Resource": ["arn:aws:s3:::dist/pub/*"]}],
}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _uuids(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: uuid.UUID(bytes=rng.integers(0, 256, 16, dtype=np.uint8).tobytes(), version=4)


class Served:
    """One node and its HTTP server."""

    def __init__(self, node, run_app_until, port: int):
        self.node, self.run_app_until, self.port = node, run_app_until, port
        self.stop_evt = threading.Event()
        self.thread, errs = run_app_until(node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs

    def stop(self) -> None:
        self.stop_evt.set()
        self.thread.join(10)
        self.node.close()


def _cluster(make_node, run_app_until, root: str, n_nodes: int, per_node: int, formats: list | None = None):
    """Nodes over one flat endpoint list, served, then built concurrently."""
    ports = [_free_port() for _ in range(n_nodes)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    endpoints = [f"{urls[n]}{root}/n{n}d{d}" for n in range(n_nodes) for d in range(per_node)]
    if formats is not None:
        for ep, f in zip(endpoints, formats):
            d = ep[len(urls[0]):]
            os.makedirs(os.path.join(d, ".minio_tpu.sys"))
            with open(os.path.join(d, ".minio_tpu.sys", "format.json"), "w") as fh:
                json.dump(f, fh)
    served = [Served(make_node(endpoints, urls[i]), run_app_until, ports[i]) for i in range(n_nodes)]
    threads = [threading.Thread(target=s.node.build) for s in served]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(s.node.pools is not None for s in served), "the cluster did not build"
    return served, endpoints, urls


def _formats(endpoints: list, url_len: int) -> list:
    out = []
    for ep in endpoints:
        with open(os.path.join(ep[url_len:], ".minio_tpu.sys", "format.json")) as fh:
            out.append(json.load(fh))
    return out


def _drive_tree(path: str, bucket: str) -> dict:
    """{relative path: bytes} of every file of one drive's bucket; the data
    dir uuids are pinned, so the paths compare too."""
    out = {}
    base = os.path.join(path, bucket)
    for dirpath, _, files in os.walk(base):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, base)] = fh.read()
    return out


def _script(ca: S3TestClient, cb: S3TestClient, erasure_mod, mp) -> dict:
    """The scripted requests; node A takes the writes, node B the reads."""
    log: dict = {}
    log["make-bucket"] = ca.make_bucket("dist").status_code
    for i, (key, body) in enumerate(BODIES.items()):
        with mp.context() as m:
            m.setattr(erasure_mod, "now", lambda: MOD_TIME + i)
            m.setattr(uuid, "uuid4", _uuids(100 + i))
            r = ca.put_object("dist", key, body)
        log[f"put-{key}"] = (r.status_code, r.headers.get("ETag"))
    for key in BODIES:
        r = cb.get_object("dist", key)
        log[f"get-on-b-{key}"] = (r.status_code, hashlib.sha256(r.content).hexdigest(), r.headers.get("ETag"))
    log["list-a"] = (lambda r: (r.status_code, r.content))(ca.list_objects("dist"))
    log["list-b"] = (lambda r: (r.status_code, r.content))(cb.list_objects("dist"))
    # A delete on B propagates: A answers 404 at once.
    with mp.context() as m:
        m.setattr(erasure_mod, "now", lambda: MOD_TIME + 10)
        m.setattr(uuid, "uuid4", _uuids(110))
        log["put-del-me"] = ca.put_object("dist", "del-me", b"short-lived").status_code
    log["delete-on-b"] = cb.delete_object("dist", "del-me").status_code
    log["get-deleted-on-a"] = ca.get_object("dist", "del-me").status_code
    # A bucket policy set on A applies on B, whose meta cache was warm.
    with mp.context() as m:
        m.setattr(erasure_mod, "now", lambda: MOD_TIME + 20)
        m.setattr(uuid, "uuid4", _uuids(120))
        log["put-pub"] = ca.put_object("dist", "pub/readme.txt", b"public-read").status_code
    log["anon-before"] = cb.request("GET", "/dist/pub/readme.txt", anonymous=True).status_code
    log["policy-put"] = ca.request("PUT", "/dist", query=[("policy", "")],
                                   body=json.dumps(POLICY).encode()).status_code
    r = cb.request("GET", "/dist/pub/readme.txt", anonymous=True)
    log["anon-after"] = (r.status_code, r.content)
    # A user added on A signs in on B.
    r = ca.request("POST", f"{ADMIN}/users",
                   body=json.dumps({"accessKey": USER[0], "secretKey": USER[1], "policies": ["readwrite"]}).encode())
    log["user-add"] = (r.status_code, r.json())
    user_b = S3TestClient(cb.endpoint, *USER)
    r = user_b.get_object("dist", "tiny")
    log["user-get-on-b"] = (r.status_code, r.content == BODIES["tiny"])
    # The admin fan-outs reach the peer.
    log["info-a"] = ca.request("GET", f"{ADMIN}/info").json()
    log["toplocks-a"] = (lambda r: (r.status_code, r.json()))(ca.request("GET", f"{ADMIN}/toplocks"))
    r = ca.request("POST", f"{ADMIN}/chaos", body=json.dumps({"kind": "slow-rpc", "target": "nowhere.invalid",
                                                            "delay_ms": 1}).encode())
    fid = r.json()["fault_id"]
    listing = ca.request("GET", f"{ADMIN}/chaos").json()
    log["chaos-list"] = {k: sorted(f["fault_id"] for f in v) for k, v in listing.items() if k != "local"}
    log["chaos-disarm"] = ca.request("DELETE", f"{ADMIN}/chaos", query=[("fault-id", fid)]).json()
    log["chaos-fid"] = fid
    return log


def _jax_node(codec):
    return lambda endpoints, url: JaxNode(endpoints, url=url, root_user=ROOT, root_password=SECRET,
                                          set_drive_count=8, codec=codec)


def _port_node(codec, **kw):
    return lambda endpoints, url: Node(endpoints, url=url, root_user=ROOT, root_password=SECRET,
                                       set_drive_count=kw.get("set_drive_count", 8), codec=codec, device="cpu")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    codec = BatchingDeviceCodec(device="cpu")
    mp = pytest.MonkeyPatch()
    out: dict = {}
    served: list = []
    try:
        jax_served, jax_eps, jax_urls = _cluster(_jax_node(JaxHostCodec()), jax_cli._run_app_until,
                                                 os.path.join(root, "jax"), 2, 4)
        served += jax_served
        formats = _formats(jax_eps, len(jax_urls[0]))
        port_served, port_eps, port_urls = _cluster(_port_node(codec), cli._run_app_until,
                                                    os.path.join(root, "port"), 2, 4, formats)
        served += port_served
        for name, srv, eps, urls, erasure_mod in (
            ("jax", jax_served, jax_eps, jax_urls, jax_erasure),
            ("port", port_served, port_eps, port_urls, port_erasure),
        ):
            clients = [S3TestClient(u, ROOT, SECRET) for u in urls]
            log = _script(clients[0], clients[1], erasure_mod, mp)
            trees = [_drive_tree(ep[len(urls[0]):], "dist") for ep in eps]
            out[name] = {"log": log, "trees": trees, "urls": urls, "served": srv,
                         "formats": _formats(eps, len(urls[0]))}
        yield out
    finally:
        for s in served:
            s.stop()
        mp.undo()
        codec.close()


STEPS = ["make-bucket"] + [f"put-{k}" for k in SIZES] + [f"get-on-b-{k}" for k in SIZES] + [
    "list-a", "list-b", "put-del-me", "delete-on-b", "get-deleted-on-a", "put-pub", "anon-before", "policy-put",
    "anon-after", "user-add", "user-get-on-b", "toplocks-a", "chaos-disarm",
]


def test_formats_agree(clusters):
    port = clusters["port"]
    assert port["formats"] == clusters["jax"]["formats"]
    assert len({f["id"] for f in port["formats"]}) == 1
    ids = [n.node.drives[i].disk_id() for n in port["served"] for i in range(8)]
    assert len(set(ids)) == 8 and ids[:8] == ids[8:]  # both nodes see the same 8 drive ids in order


@pytest.mark.parametrize("step", STEPS)
def test_s3_answers_equal(clusters, step):
    assert clusters["port"]["log"][step] == clusters["jax"]["log"][step]


def test_put_on_a_gets_on_b_byte_exact(clusters):
    log = clusters["port"]["log"]
    for key, body in BODIES.items():
        assert log[f"get-on-b-{key}"][:2] == (200, hashlib.sha256(body).hexdigest())
    assert log["get-deleted-on-a"] == 404 and log["delete-on-b"] == 204
    assert log["anon-before"] == 403 and log["anon-after"] == (200, b"public-read")
    assert log["user-get-on-b"] == (200, True)


@pytest.mark.parametrize("drive", range(8))
def test_part_files_and_xl_meta_equal(clusters, drive):
    port, jax = clusters["port"]["trees"][drive], clusters["jax"]["trees"][drive]
    assert sorted(port) == sorted(jax)
    for rel in jax:
        assert port[rel] == jax[rel], rel


def test_mid_object_is_in_part_files(clusters):
    trees = clusters["port"]["trees"]
    assert all(any(p.startswith("mid/") and p.endswith("/part.1") for p in t) for t in trees)


def test_info_lists_the_peer(clusters):
    for name in ("jax", "port"):
        info = clusters[name]["log"]["info-a"]
        peer_url = clusters[name]["urls"][1]
        assert [s["node"] for s in info["servers"]] == [peer_url]
        assert len(info["servers"][0]["drives"]) == 4 and all(d["ok"] for d in info["servers"][0]["drives"])
        assert info["drivesOnline"] == 8
    strip = lambda i: sorted((k, type(v).__name__) for k, v in i.items() if k != "usage")  # noqa: E731
    assert strip(clusters["port"]["log"]["info-a"]) == strip(clusters["jax"]["log"]["info-a"])
    assert sorted(clusters["port"]["log"]["info-a"]["servers"][0]) == \
        sorted(clusters["jax"]["log"]["info-a"]["servers"][0])


def test_chaos_fans_out_to_the_peer(clusters):
    log = clusters["port"]["log"]
    assert log["chaos-list"] == {clusters["port"]["urls"][1]: [log["chaos-fid"]]}
    assert log["chaos-disarm"] == {"removed": 1}


def test_nodes_share_one_cluster_lock(clusters):
    a, b = (s.node for s in clusters["port"]["served"])
    assert isinstance(a.ns_lock, NamespaceLock) and a.iam.ns_lock is a.ns_lock
    assert [type(lk).__name__ for lk in a.ns_lock.lockers] == ["LocalLocker", "RemoteLocker"]
    assert all(s.ns_lock is a.ns_lock for p in a.pools.pools for s in p.sets)
    held = a.ns_lock.new("dist", "locked")
    assert held.acquire(writer=True, timeout=5)
    try:
        assert not b.ns_lock.new("dist", "locked").acquire(writer=True, timeout=0.3)
        assert [e["resource"] for e in b.locker.top_locks()] == ["dist/locked"]
    finally:
        held.release()
    assert b.locker.top_locks() == []


def test_peer_ping_and_server_info(clusters):
    a = clusters["port"]["served"][0].node
    peer = PeerClient(clusters["port"]["urls"][1], a.token)
    assert peer.ping()
    info = peer.server_info()
    assert info["node"] == clusters["port"]["urls"][1] and len(info["drives"]) == 4
    assert all(d["ok"] for d in info["drives"])
    # The JAX client reads the port's peer the same way.
    from minio_tpu.dist.peer import PeerClient as JaxPeerClient

    jp = JaxPeerClient(clusters["port"]["urls"][1], a.token)
    assert jp.ping() and sorted(jp.server_info()) == sorted(info)
    assert not PeerClient(clusters["port"]["urls"][1], "bad-token").ping()


@pytest.mark.parametrize("route", [name for name, _ in NOT_PORTED_PEER_ROUTES])
def test_unported_peer_route_answers_501(clusters, route):
    a = clusters["port"]["served"][0].node
    module = dict(NOT_PORTED_PEER_ROUTES)[route]
    r = requests.post(f"{clusters['port']['urls'][1]}{PEER_PREFIX}/{route}", headers={TOKEN_HEADER: a.token},
                      timeout=30)
    assert r.status_code == 501 and module in r.text
    assert requests.post(f"{clusters['port']['urls'][1]}{PEER_PREFIX}/{route}", timeout=30).status_code == 403


def test_unported_peer_routes_are_every_other_jax_peer_route():
    import inspect
    import re

    from minio_tpu.dist import peer as jax_peer

    def routes(mod):
        src = inspect.getsource(mod.make_peer_app)
        names = set(re.findall(r'^\s+"([a-z]+)": h_', src, re.M))
        return names | set(re.findall(r'add_post\("/([a-z]+)"', src))

    unported = {name for name, _ in NOT_PORTED_PEER_ROUTES}
    assert routes(port_peer) | unported == routes(jax_peer)
    assert not routes(port_peer) & unported


def test_remote_drives_and_lockers_point_at_the_peer(clusters):
    a = clusters["port"]["served"][0].node
    remote = [d for d in a.drives if isinstance(d, RemoteDrive)]
    assert len(remote) == 4 and {d.node_url for d in remote} == {clusters["port"]["urls"][1]}
    assert a.is_leader and not clusters["port"]["served"][1].node.is_leader
    assert [lk.client.base_url for lk in a.ns_lock.lockers if isinstance(lk, RemoteLocker)] == \
        [clusters["port"]["urls"][1] + "/mtpu/lock/v1"]


# -- node loss and rejoin -----------------------------------------------------------------------


def test_node_loss_read_and_write_then_heal_on_rejoin(tmp_path):
    """3 nodes x 2 drives (a 6-drive set, parity 3): with one node down the
    4 drives left meet the write quorum, as in tests/test_dist.py."""
    codec = BatchingDeviceCodec(device="cpu")
    make = _port_node(codec, set_drive_count=6)
    served, endpoints, urls = _cluster(make, cli._run_app_until, str(tmp_path), 3, 2)
    try:
        c0 = S3TestClient(urls[0], ROOT, SECRET)
        assert c0.make_bucket("heal").status_code == 200
        before = BODIES["mid"]
        assert c0.put_object("heal", "before", before).status_code == 200
        served[2].stop()  # node 2 and its 2 drives go away
        r = c0.get_object("heal", "before")
        assert (r.status_code, r.content == before) == (200, True)  # a degraded read
        during = BODIES["small"]
        r = c0.put_object("heal", "during", during)
        assert r.status_code == 200, r.text
        # Node 2 rejoins over the same drives and the same port.
        served[2] = Served(make(endpoints, urls[2]), cli._run_app_until, served[2].port)
        served[2].node.build()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not all(d.is_online() and d.disk_id() for d in served[0].node.drives):
            time.sleep(0.25)
        healed = served[0].node.pools.heal_object("heal", "during")
        assert healed.disks_healed >= 1
        assert served[0].node.pools.heal_object("heal", "during", dry_run=True).disks_healed == 0
        c2 = S3TestClient(urls[2], ROOT, SECRET)
        for key, body in (("before", before), ("during", during)):
            r = c2.get_object("heal", key)
            assert (r.status_code, r.content == body) == (200, True), key
        # Node 2's own drives hold the object written while it was down.
        for d in range(2):
            assert os.path.exists(os.path.join(str(tmp_path), f"n2d{d}", "heal", "during", "xl.meta"))
    finally:
        for s in served:
            s.stop()
        codec.close()


# -- a mixed cluster ----------------------------------------------------------------------------


def test_mixed_jax_and_port_cluster(tmp_path):
    codec = BatchingDeviceCodec(device="cpu")
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    endpoints = [f"{urls[n]}{tmp_path}/n{n}d{d}" for n in range(2) for d in range(4)]
    jax_node = JaxNode(endpoints, url=urls[0], root_user=ROOT, root_password=SECRET, set_drive_count=8,
                       codec=JaxHostCodec())
    port_node = Node(endpoints, url=urls[1], root_user=ROOT, root_password=SECRET, set_drive_count=8, codec=codec,
                     device="cpu")
    served = [Served(jax_node, jax_cli._run_app_until, ports[0]), Served(port_node, cli._run_app_until, ports[1])]
    try:
        threads = [threading.Thread(target=s.node.build) for s in served]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert jax_node.pools is not None and port_node.pools is not None
        cj, cp = S3TestClient(urls[0], ROOT, SECRET), S3TestClient(urls[1], ROOT, SECRET)
        assert cj.make_bucket("mixed").status_code == 200
        for writer, reader, key in ((cj, cp, "from-jax"), (cp, cj, "from-port")):
            for size in ("tiny", "mid"):
                assert writer.put_object("mixed", f"{key}-{size}", BODIES[size]).status_code == 200
                r = reader.get_object("mixed", f"{key}-{size}")
                assert (r.status_code, r.content == BODIES[size]) == (200, True), (key, size)
    finally:
        for s in served:
            s.stop()
        codec.close()


def test_closed_node_does_not_leave_its_codec_as_the_default(tmp_path):
    """A Node given codec= installs it as the process default; its close()
    clears that default and leaves the caller's codec open."""
    from minio_tpu_torch.object import codec as codec_mod

    c = BatchingDeviceCodec(device="cpu")
    try:
        node = Node([str(tmp_path / f"d{i}") for i in range(4)], codec=c, device="cpu").build()
        assert codec_mod._default is c
        node.close()
        assert codec_mod._default is not c
        assert not c._stop.is_set()  # the caller's codec stays the caller's to close
    finally:
        c.close()


def test_mixed_cluster_attach_reaches_the_follower_and_a_decommission_drains(tmp_path):
    """A JAX leader and a port follower: POST /pools/attach on the leader
    (a pool of 8 drives on the leader) reaches the port node through the
    poolsreload verb, which builds the pool from the persisted config; a
    decommission of pool 0 on the leader drains it, and the port node sees
    pool 0 decommissioned and reads every object back from pool 1."""
    codec = BatchingDeviceCodec(device="cpu")
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    endpoints = [f"{urls[n]}{tmp_path}/n{n}d{d}" for n in range(2) for d in range(4)]
    jax_node = JaxNode(endpoints, url=urls[0], root_user=ROOT, root_password=SECRET, set_drive_count=8,
                       codec=JaxHostCodec())
    port_node = Node(endpoints, url=urls[1], root_user=ROOT, root_password=SECRET, set_drive_count=8, codec=codec,
                     device="cpu")
    served = [Served(jax_node, jax_cli._run_app_until, ports[0]), Served(port_node, cli._run_app_until, ports[1])]
    try:
        threads = [threading.Thread(target=s.node.build) for s in served]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert jax_node.pools is not None and port_node.pools is not None
        cj, cp = S3TestClient(urls[0], ROOT, SECRET), S3TestClient(urls[1], ROOT, SECRET)
        assert cj.make_bucket("expand").status_code == 200
        for size in SIZES:
            assert cp.put_object("expand", f"k-{size}", BODIES[size]).status_code == 200
        new_pool = [f"{urls[0]}{tmp_path}/n0p1d{d}" for d in range(8)]
        r = cj.request("POST", f"{ADMIN}/pools/attach", body=json.dumps({"endpoints": new_pool}).encode())
        assert (r.status_code, r.json()) == (200, {"pool": 1, "status": "active"})
        assert port_node.poolmgr.epoch == jax_node.poolmgr.epoch == 2
        assert port_node.pools.statuses == ["active", "active"]
        assert [len(p.disks) for p in port_node.pools.pools] == [8, 8]
        assert all(isinstance(d, RemoteDrive) for d in port_node.pools.pools[1].disks)
        r = cj.request("POST", f"{ADMIN}/pools/decommission", body=json.dumps({"pool": 0, "wait": True}).encode())
        assert r.status_code == 200 and r.json()["drain"]["finished"], r.text
        assert port_node.pools.statuses == ["decommissioned", "active"]
        st = cp.request("GET", f"{ADMIN}/pools/status").json()
        assert [p["status"] for p in st["pools"]] == ["decommissioned", "active"]
        assert st["pools"][0]["drain"]["objects_moved"] == len(SIZES)
        for size in SIZES:
            got = cp.get_object("expand", f"k-{size}")
            assert (got.status_code, got.content == BODIES[size]) == (200, True), size
        for d in range(4):
            for n in range(2):
                assert not os.path.exists(f"{tmp_path}/n{n}d{d}/expand/k-mid/xl.meta")
            assert os.path.exists(f"{tmp_path}/n0p1d{d}/expand/k-mid/xl.meta")
    finally:
        for s in served:
            s.stop()
        codec.close()


# -- on the card --------------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_two_node_cluster_round_trip(cuda_device, tmp_path):
    """Two port nodes over 2 x 8 drives (one 16-drive 12+4 set) on the
    CUDA codec: a PUT on one node reads back byte-exact from the other."""
    codec = BatchingDeviceCodec(device=cuda_device)
    make = lambda eps, url: Node(eps, url=url, root_user=ROOT, root_password=SECRET, codec=codec)  # noqa: E731
    served, _, urls = _cluster(make, cli._run_app_until, str(tmp_path), 2, 8)
    data = np.random.default_rng(4).integers(0, 256, (3 << 20) + 4099, dtype=np.uint8).tobytes()
    try:
        ca, cb = S3TestClient(urls[0], ROOT, SECRET), S3TestClient(urls[1], ROOT, SECRET)
        assert ca.make_bucket("gpu").status_code == 200
        assert ca.put_object("gpu", "obj", data).status_code == 200
        r = cb.get_object("gpu", "obj")
        assert (r.status_code, r.content == data) == (200, True)
        assert codec.stats()["batches_run"] > 0
    finally:
        for s in served:
            s.stop()
        codec.close()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()
