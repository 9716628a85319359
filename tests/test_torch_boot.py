"""The port's boot path -- dist/node.py Node, api/admin.py, control/config.py
and control/healmgr.py -- held against the JAX package's over HTTP.

A JAX ``Node`` and a port ``Node`` are built over the same layout: two pools,
2 x 4 + 4 drives, EC:1 (the JAX side with MINIO_TPU_CODEC=host, the port on
device="cpu", where the kernels' plain versions run). The port's drives get
the JAX node's format.json files before its build, so both place every
object the same way; a fresh port build on empty drives is held against the
JAX formats by shape. Each node is served by its own package's
``cli._run_app_until`` on a real socket, and the same SigV4-signed requests
go to both: S3 PUT/GET, admin /info, /perf, /chaos arm/list/disarm, /heal
start/status, /profile, /config, user add. Statuses are equal, and JSON
bodies are equal by shape (random ids, paths and timings by shape; counts
and names exactly). A PUT with one drive failing through /chaos reaches the
MRF, which heals it in both. After a close() and a new Node over the same
drives, data and IAM survive and the dead pid's stage files planted on the
drives are gone in both. Object bytes and the erasure fields of every
version are compared exactly; both packages write a compressed object as
snappy through their host libraries, so its part files compare too.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import uuid
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

from minio_tpu import cli as jax_cli
from minio_tpu.control import config as jax_config
from minio_tpu.control import healmgr as jax_healmgr
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.api import admin
from minio_tpu_torch.api.auth import Credentials, sign_request
from minio_tpu_torch.control import config as port_config
from minio_tpu_torch.control import healmgr as port_healmgr
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.ops import goldens
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

ROOT = ("bootadmin", "boot-root-secret")
USER = ("bootuser", "boot-user-secret")
POOLS = ([f"p0d{i}" for i in range(8)], [f"p1d{i}" for i in range(4)])
SET_DRIVES, PARITY = 4, 1
SIZES = {"tiny": 3 * 1024, "small": 40 * 1024, "mid": 150 * 1024, "max": 300 * 1024}
ADMIN = admin.ADMIN_PREFIX
TEXT = b"boot logs compress well\n" * 400


def _bodies() -> dict:
    rng = np.random.default_rng(10)
    return {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for name, n in SIZES.items()}


BODIES = _bodies()
# Above the 128 KiB inline limit: the streaming PUT commits through rename_data.
VICTIM = np.random.default_rng(11).integers(0, 256, 132 * 1024, dtype=np.uint8).tobytes()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Client:
    """SigV4-signed requests over http.client (no SDK)."""

    def __init__(self, endpoint: str, creds=ROOT):
        self.host, port = endpoint.split(":")
        self.port = int(port)
        self.creds = Credentials(*creds)

    def send(self, method: str, path: str, body=b"", query=(), sign=True):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        headers = {"host": f"{self.host}:{self.port}"}
        if sign:
            headers = sign_request(self.creds, method, path, list(query), headers, body)
        headers.pop("host", None)
        qs = "&".join(f"{k}={v}" if v != "" else k for k, v in query)
        conn = http.client.HTTPConnection(self.host, self.port, timeout=120)
        try:
            conn.request(method, path + (f"?{qs}" if qs else ""), body=body, headers=headers)
            r = conn.getresponse()
            data = r.read()
            return SimpleNamespace(status=r.status, body=data, ctype=r.getheader("Content-Type", ""))
        finally:
            conn.close()

    def json(self, method: str, path: str, body=b"", query=()):
        r = self.send(method, path, body, query)
        return r.status, (json.loads(r.body) if r.body and r.ctype.startswith("application/json") else r.body)


_HEX = re.compile(r"[0-9a-f]")


def shape(value, root: str = ""):
    """A JSON value with its random parts replaced: strings by their hex
    shape (ids, hashes) with the tree's root path removed, floats by their
    type, and the drives' byte counts (free/total space) by their type."""
    if isinstance(value, dict):
        return {k: ("int" if k in ("totalspace", "availspace") else shape(v, root)) for k, v in value.items()}
    if isinstance(value, list):
        return [shape(v, root) for v in value]
    if isinstance(value, str):
        return _HEX.sub("x", value.replace(root, "<root>") if root else value)
    if isinstance(value, float):
        return "float"
    return value


class Side:
    """One package's node, its server and its client."""

    def __init__(self, name: str, make_node, run_app_until, root: str):
        self.name, self.make_node, self.run_app_until, self.root = name, make_node, run_app_until, root
        self.node = self.thread = self.stop_evt = self.client = None

    def paths(self) -> list[list[str]]:
        return [[os.path.join(self.root, d) for d in pool] for pool in POOLS]

    def start(self) -> None:
        self.node = self.make_node(self.paths())
        app = self.node.make_app()
        self.node.build()
        self.stop_evt = threading.Event()
        port = _free_port()
        self.thread, errs = self.run_app_until(app, "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        self.client = Client(f"127.0.0.1:{port}")

    def stop(self) -> None:
        if self.stop_evt is not None:
            self.stop_evt.set()
            self.thread.join(10)
        if self.node is not None:
            self.node.close()
            self.node = None


def _jax_node(paths):
    return JaxNode(paths, root_user=ROOT[0], root_password=ROOT[1], set_drive_count=SET_DRIVES, parity=PARITY)


def _port_node(paths):
    return Node(paths, root_user=ROOT[0], root_password=ROOT[1], set_drive_count=SET_DRIVES, parity=PARITY,
                device="cpu")


def _wait(pred, timeout: float = 60.0, what: str = "") -> None:
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out waiting for {what}"
        time.sleep(0.05)


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _plant_stage_files(root: str, pid: int) -> list[str]:
    planted = []
    for pool in POOLS:
        for d in pool:
            stage = os.path.join(root, d, ".minio_tpu.sys", "tmp", f"{pid}.{uuid.uuid4()}")
            os.makedirs(stage)
            with open(os.path.join(stage, "part.1"), "wb") as f:
                f.write(b"debris")
            planted.append(stage)
    return planted


def _versions_on_disk(side: Side, local_drive, bucket: str) -> dict:
    """{key: [(drive, erasure fields, sha256 of the data)]} over every drive
    of pool 0, read through the package's own LocalDrive."""
    out: dict = {}
    for d in POOLS[0]:
        drive = local_drive(os.path.join(side.root, d))
        bdir = os.path.join(side.root, d, bucket)
        if not os.path.isdir(bdir):
            continue
        for dirpath, _, files in os.walk(bdir):
            if "xl.meta" not in files:
                continue
            key = os.path.relpath(dirpath, bdir)
            fi = drive.read_version(bucket, key, "")
            e = fi.erasure
            if fi.inline_data:
                data = b"inline:" + bytes(fi.inline_data)
            else:
                with open(os.path.join(dirpath, fi.data_dir, "part.1"), "rb") as f:
                    data = f.read()
            meta = {k: v for k, v in fi.metadata.items() if "compress" in k.lower() or k == "etag"}
            out.setdefault(key, []).append((
                d, fi.size, e.data_blocks, e.parity_blocks, e.index, list(e.distribution),
                [(p.number, p.size, p.actual_size) for p in fi.parts], sorted(meta.items()),
                [dict(c) for c in e.checksums], hashlib.sha256(data).hexdigest(),
            ))
    return out


def _script(c: Client, heal_seq: dict, log: dict, side: Side) -> None:
    """The scripted requests, in order; `log` gets each response."""
    log["make-bucket"] = c.json("PUT", "/bkt")
    for name, body in BODIES.items():
        log[f"put-{name}"] = c.send("PUT", f"/bkt/{name}", body).status
    for name in BODIES:
        r = c.send("GET", f"/bkt/{name}")
        log[f"get-{name}"] = (r.status, hashlib.sha256(r.body).hexdigest())
    log["info"] = c.json("GET", f"{ADMIN}/info")
    log["perf"] = c.json("GET", f"{ADMIN}/perf")
    log["perf-slow"] = c.json("GET", f"{ADMIN}/perf/slow")
    # One drive fails its next commit rename: the PUT meets write quorum
    # without it and queues the object on the MRF, which heals it.
    status, doc = c.json("POST", f"{ADMIN}/chaos",
                         {"kind": "drive-error", "target": "p0d", "ops": ["rename_data"], "count": 1})
    log["chaos-arm"] = (status, sorted(doc))
    log["chaos-list"] = c.json("GET", f"{ADMIN}/chaos")
    log["put-mrf"] = c.send("PUT", "/bkt/mrf-victim", VICTIM).status
    log["chaos-disarm"] = c.json("DELETE", f"{ADMIN}/chaos", query=[("fault-id", doc["fault_id"])])
    _wait(lambda: side.node.mrf.healed >= 1, what=f"{side.name} MRF heal")
    log["mrf"] = (side.node.mrf.healed, side.node.mrf.failed)
    log["get-mrf"] = hashlib.sha256(c.send("GET", "/bkt/mrf-victim").body).hexdigest()
    status, doc = c.json("POST", f"{ADMIN}/heal", {"bucket": "bkt", "prefix": "tiny"})
    log["heal-start"] = (status, sorted(doc))
    seq = doc["healSequence"]
    heal_seq[side.name] = seq

    def heal_done():
        st, d = c.json("GET", f"{ADMIN}/heal/{seq}")
        log["heal-status"] = (st, d)
        return not d["running"]

    _wait(heal_done, what=f"{side.name} heal sequence")
    log["profile-summary"] = c.json("GET", f"{ADMIN}/profile", query=[("summary", "1")])
    log["profile-start"] = c.json("POST", f"{ADMIN}/profile/start")
    r = c.send("POST", f"{ADMIN}/profile/stop")
    log["profile-stop"] = (r.status, r.ctype.split(";")[0])
    log["config-set"] = c.json("PUT", f"{ADMIN}/config", {"subsys": "compression", "key": "enable", "value": "on"})
    log["config-get"] = c.json("GET", f"{ADMIN}/config")
    log["put-compressed"] = c.send("PUT", "/bkt/notes.txt", TEXT).status
    r = c.send("GET", "/bkt/notes.txt")
    log["get-compressed"] = (r.status, r.body == TEXT)
    log["user-add"] = c.json("POST", f"{ADMIN}/users",
                             {"accessKey": USER[0], "secretKey": USER[1], "policies": ["readwrite"]})
    log["users"] = c.json("GET", f"{ADMIN}/users")
    log["service"] = c.json("POST", f"{ADMIN}/service", {"action": "restart"})
    log["config-bad-key"] = c.json("PUT", f"{ADMIN}/config", {"subsys": "compression", "key": "nope", "value": "x"})
    log["unsigned-admin"] = c.send("GET", f"{ADMIN}/info", sign=False).status
    log["toplocks"] = c.json("GET", f"{ADMIN}/toplocks")
    log["force-unlock"] = c.json("POST", f"{ADMIN}/force-unlock", {"resource": "bkt/tiny"})
    r = c.send("GET", f"{ADMIN}/inspect", query=[("volume", "bkt"), ("file", "tiny/xl.meta")])
    log["inspect"] = (r.status, r.ctype, sorted(zipfile.ZipFile(io.BytesIO(r.body)).namelist()))
    log["inspect-missing"] = c.json("GET", f"{ADMIN}/inspect", query=[("volume", "bkt"), ("file", "nope")])


# The admin routes this slice ported from the JAX package (pool lifecycle,
# the scanner's usage and quota, remote tiers), in the order _ported_routes
# calls them.
PORTED_ROUTES = (
    "GET /datausage", "GET /quota", "PUT /quota", "GET /pools/status", "POST /pools/attach",
    "POST /pools/decommission", "POST /pools/rebalance", "POST /tiers", "GET /tiers",
    "PUT /tiers/{name}/creds", "GET /tiers/stats", "DELETE /tiers/{name}",
)
ATTACHED = [f"p2d{i}" for i in range(SET_DRIVES)]


def _ported_routes(c: Client, side: Side) -> dict:
    """One call of each ported route, with the body the JAX handler takes."""
    attach = [os.path.join(side.root, d) for d in ATTACHED]
    calls = {
        "GET /datausage": ("GET", "/datausage", b"", ()),
        "GET /quota": ("GET", "/quota", b"", [("bucket", "bkt")]),
        "PUT /quota": ("PUT", "/quota", {"quota": 1 << 30, "quotatype": "hard"}, [("bucket", "bkt")]),
        "GET /pools/status": ("GET", "/pools/status", b"", ()),
        "POST /pools/attach": ("POST", "/pools/attach", {"endpoints": attach}, ()),
        "POST /pools/decommission": ("POST", "/pools/decommission", {"pool": 2, "wait": True}, ()),
        "POST /pools/rebalance": ("POST", "/pools/rebalance", {"start": False}, ()),
        "POST /tiers": ("POST", "/tiers", {"name": "COLD", "type": "fs", "dir": os.path.join(side.root, "tier")}, ()),
        "GET /tiers": ("GET", "/tiers", b"", ()),
        "PUT /tiers/{name}/creds": ("PUT", "/tiers/COLD/creds", {"accessKey": "tierak", "secretKey": "tiersk"}, ()),
        "GET /tiers/stats": ("GET", "/tiers/stats", b"", ()),
        "DELETE /tiers/{name}": ("DELETE", "/tiers/COLD", b"", ()),
    }
    out = {}
    for route in PORTED_ROUTES:
        method, path, body, query = calls[route]
        out[route] = c.json(method, ADMIN + path, body, query)
    out["GET /quota after"] = c.json("GET", f"{ADMIN}/quota", query=[("bucket", "bkt")])
    out["GET /pools/status after"] = c.json("GET", f"{ADMIN}/pools/status")
    # Leave the quota off: the restart's PUTs below are not about quotas.
    c.json("PUT", f"{ADMIN}/quota", {"quota": 0}, [("bucket", "bkt")])
    return out


def json_kind(value, root: str = ""):
    """A JSON value's shape: dict keys and list lengths kept, strings by their
    hex shape with the tree's root removed, numbers by their type."""
    if isinstance(value, dict):
        return {k: json_kind(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [json_kind(v, root) for v in value]
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float)):
        return type(value).__name__
    if isinstance(value, str):
        return shape(value, root)
    return repr(type(value))


RESTART_GETS = ("tiny", "small", "max")


def _after_restart(c: Client, log: dict, endpoint_port: int) -> None:
    for name in RESTART_GETS:
        r = c.send("GET", f"/bkt/{name}")
        log[f"restart-get-{name}"] = (r.status, hashlib.sha256(r.body).hexdigest())
    r = c.send("GET", "/bkt/notes.txt")
    log["restart-get-compressed"] = (r.status, r.body == TEXT)
    log["restart-users"] = c.json("GET", f"{ADMIN}/users")
    log["restart-config-get"] = c.json("GET", f"{ADMIN}/config")
    user = Client(f"{c.host}:{c.port}", USER)
    r = user.send("GET", "/bkt/tiny")
    log["restart-user-get"] = (r.status, r.body == BODIES["tiny"])
    log["restart-user-put"] = user.send("PUT", "/bkt/by-user", b"written by the user").status


@pytest.fixture(scope="module")
def boot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("boot"))
    mp = pytest.MonkeyPatch()
    mp.delenv("MINIO_TPU_CODEC", raising=False)
    out = SimpleNamespace(log={"jax": {}, "port": {}}, restart={"jax": {}, "port": {}}, heal_seq={})
    sides = {
        "jax": Side("jax", _jax_node, jax_cli._run_app_until, os.path.join(root, "jax")),
        "port": Side("port", _port_node, cli._run_app_until, os.path.join(root, "port")),
    }
    try:
        # A fresh port build on empty drives, for the format shapes.
        fresh = Side("port", _port_node, cli._run_app_until, os.path.join(root, "fresh"))
        node = _port_node(fresh.paths())
        node.build()
        node.close()
        out.fresh_formats = [[json.load(open(os.path.join(p, ".minio_tpu.sys", "format.json"))) for p in pool]
                             for pool in fresh.paths()]

        with mp.context() as m:
            m.setenv("MINIO_TPU_CODEC", "host")  # the JAX side: its numpy host codec
            sides["jax"].start()
        out.jax_formats = [[json.load(open(os.path.join(p, ".minio_tpu.sys", "format.json"))) for p in pool]
                           for pool in sides["jax"].paths()]
        for pool_j, pool_p in zip(sides["jax"].paths(), sides["port"].paths()):
            for pj, pp in zip(pool_j, pool_p):
                os.makedirs(os.path.join(pp, ".minio_tpu.sys"))
                shutil.copy(os.path.join(pj, ".minio_tpu.sys", "format.json"),
                            os.path.join(pp, ".minio_tpu.sys", "format.json"))
        sides["port"].start()
        out.codec = sides["port"].node.codec
        for name, side in sides.items():
            _script(side.client, out.heal_seq, out.log[name], side)
        out.ported = {name: _ported_routes(side.client, side) for name, side in sides.items()}
        out.roots = {name: side.root for name, side in sides.items()}
        out.unported = {
            (method, path): sides["port"].client.json(method, ADMIN + path.replace("{id}", "x").replace(
                "{name}", "x"))
            for method, path, _ in admin.NOT_PORTED_ROUTES
        }
        out.trees = {
            "jax": _versions_on_disk(sides["jax"], JaxLocalDrive, "bkt"),
            "port": _versions_on_disk(sides["port"], LocalDrive, "bkt"),
        }
        # Restart: close, plant a dead pid's stage files, build anew.
        dead = _dead_pid()
        out.planted = {}
        for name, side in sides.items():
            side.stop()
            out.planted[name] = _plant_stage_files(side.root, dead)
        with mp.context() as m:
            m.setenv("MINIO_TPU_CODEC", "host")
            sides["jax"].start()
        sides["port"].start()
        out.restart_codec = sides["port"].node.codec
        for name, side in sides.items():
            _after_restart(side.client, out.restart[name], side.client.port)
        out.swept = {name: [p for p in planted if os.path.exists(p)] for name, planted in out.planted.items()}
        yield out
    finally:
        for side in sides.values():
            side.stop()
        Node.close_all()
        runtime.shutdown_data_plane()
        mp.undo()


def test_fresh_format_json_shapes_equal(boot):
    assert [[shape(f) for f in pool] for pool in boot.fresh_formats] == \
        [[shape(f) for f in pool] for pool in boot.jax_formats]
    for formats in (boot.fresh_formats, boot.jax_formats):
        ids = {f["id"] for pool in formats for f in pool}
        assert len(ids) == 1  # pool 1 inherits pool 0's deployment id
        assert [len(f["erasure"]["sets"]) for f in (formats[0][0], formats[1][0])] == [2, 1]


def test_port_node_serves_the_batching_codec_on_cpu(boot):
    for codec in (boot.codec, boot.restart_codec):
        assert isinstance(codec, BatchingDeviceCodec) and codec.device.type == "cpu"
    assert boot.codec is not boot.restart_codec
    assert boot.codec._stop.is_set()  # close() closed the codec its build installed


def _same_json(name: str, j, p, root_j: str = "", root_p: str = "") -> None:
    assert p[0] == j[0], (name, p, j)
    assert shape(p[1], root_p) == shape(j[1], root_j), name


EXACT_STEPS = ["make-bucket"] + [f"put-{n}" for n in SIZES] + [f"get-{n}" for n in SIZES] + [
    "put-mrf", "chaos-disarm", "mrf", "get-mrf", "heal-start", "profile-start", "profile-stop", "config-set",
    "config-get", "put-compressed", "get-compressed", "user-add", "users", "service", "config-bad-key",
    "unsigned-admin", "chaos-arm", "toplocks", "force-unlock", "inspect", "inspect-missing",
]


@pytest.mark.parametrize("name", EXACT_STEPS)
def test_response_equal(boot, name):
    j, p = boot.log["jax"][name], boot.log["port"][name]
    if name == "config-bad-key":
        assert p[0] == j[0] == 400
        assert p[1]["Code"] == j[1]["Code"]
        return
    assert p == j


def test_object_bodies_are_the_seeded_bytes(boot):
    for name, body in BODIES.items():
        assert boot.log["port"][f"get-{name}"] == (200, hashlib.sha256(body).hexdigest())
    assert boot.log["port"]["get-mrf"] == hashlib.sha256(VICTIM).hexdigest()
    assert boot.log["port"]["mrf"] == (1, 0)


def test_info_equal_by_shape(boot, tmp_path_factory):
    j, p = boot.log["jax"]["info"], boot.log["port"]["info"]
    assert p[0] == j[0] == 200
    # "usage" is the scanner's summary (no cycle has run: zero counts);
    # "servers" is the peer fan-out, empty on one node in both packages.
    assert p[1]["servers"] == j[1]["servers"] == []
    assert p[1]["usage"]["objectsCount"] == j[1]["usage"]["objectsCount"] == 0
    roots = [os.path.dirname(d["endpoint"]) for d in (j[1]["drives"][0], p[1]["drives"][0])]
    assert shape(p[1], roots[1]) == shape(j[1], roots[0])
    assert p[1]["drivesOnline"] == 12 and p[1]["drivesOffline"] == 0
    assert p[1]["buckets"] == {"count": 1}


def test_perf_has_the_jax_keys_and_the_probe(boot):
    j, p = boot.log["jax"]["perf"][1], boot.log["port"]["perf"][1]
    assert set(p) == set(j)
    assert set(p["probe"]) == set(j["probe"])
    assert set(p["node"]) == set(j["node"])
    assert set(p["degrade"]) == set(j["degrade"])
    # Every drive of both pools reports its metered API latencies and breaker.
    assert len(p["drives"]) == len(j["drives"]) == 12
    assert {k for row in p["drives"].values() for k in row} == {k for row in j["drives"].values() for k in row}
    # The port's codec serves on the CPU because the caller asked: no probe ran.
    assert p["probe"]["done"] is False and p["probe"]["ok"] is False
    assert "codec" in p["node"]["stages"] and "api" in p["node"]["stages"]
    j, p = boot.log["jax"]["perf-slow"], boot.log["port"]["perf-slow"]
    assert p[0] == j[0] == 200 and set(p[1]) == set(j[1])


def test_chaos_list_equal_by_shape(boot):
    _same_json("chaos-list", boot.log["jax"]["chaos-list"], boot.log["port"]["chaos-list"])
    assert len(boot.log["port"]["chaos-list"][1]["local"]) == 1


def test_heal_sequence_status_equal(boot):
    j, p = boot.log["jax"]["heal-status"], boot.log["port"]["heal-status"]
    assert p[0] == j[0] == 200
    assert {k: v for k, v in p[1].items() if k != "id"} == {k: v for k, v in j[1].items() if k != "id"}
    assert p[1]["id"] == boot.heal_seq["port"] and p[1]["failed"] == 0


def test_profile_summary_keys_equal(boot):
    j, p = boot.log["jax"]["profile-summary"], boot.log["port"]["profile-summary"]
    assert p[0] == j[0] == 200
    assert set(p[1]) == set(j[1])


def test_drive_trees_equal(boot):
    j, p = boot.trees["jax"], boot.trees["port"]
    assert sorted(p) == sorted(j) == sorted(list(BODIES) + ["mrf-victim", "notes.txt"])
    for key in j:
        assert sorted(p[key]) == sorted(j[key]), key
        assert len(p[key]) == SET_DRIVES  # every drive of the set holds the version (the MRF healed one)


def test_compressed_object_on_disk(boot):
    rows = boot.trees["port"]["notes.txt"]
    assert all(any("compress" in k.lower() for k, _ in row[7]) for row in rows)
    assert all(("x-internal-compression", "snappy") in row[7] for row in rows)
    assert all(row[1] < len(TEXT) for row in rows)


@pytest.mark.parametrize("name", [f"get-{n}" for n in RESTART_GETS] + ["get-compressed", "users", "config-get",
                                                                 "user-get", "user-put"])
def test_restart_keeps_data_and_iam(boot, name):
    j, p = boot.restart["jax"][f"restart-{name}"], boot.restart["port"][f"restart-{name}"]
    assert p == j
    if name == "users":
        assert p[1][USER[0]]["policies"] == ["readwrite"]
    if name.startswith("user-"):
        assert p in ((200, True), 200)


def test_restart_sweeps_a_dead_pids_stage_files(boot):
    assert len(boot.planted["port"]) == len(boot.planted["jax"]) == 12
    assert boot.swept == {"jax": [], "port": []}


@pytest.mark.parametrize("route", [f"{m} {p}" for m, p, _ in admin.NOT_PORTED_ROUTES])
def test_unported_admin_route_answers_501(boot, route):
    method, path = route.split(" ")
    module = dict(((m, p), mod) for m, p, mod in admin.NOT_PORTED_ROUTES)[(method, path)]
    status, doc = boot.unported[(method, path)]
    assert status == 501
    assert doc["Code"] == "NotImplemented" and module in doc["Message"]


@pytest.mark.parametrize("route", PORTED_ROUTES)
def test_ported_admin_route_answers_as_the_jax_handler(boot, route):
    """The 12 routes that left NOT_PORTED_ROUTES with the pool lifecycle,
    scanner and tiering slice: the port's status and JSON shape are the JAX
    handler's."""
    (sj, dj), (sp, dp) = boot.ported["jax"][route], boot.ported["port"][route]
    assert sp == sj == 200, (route, sj, dj, sp, dp)
    assert json_kind(dp, boot.roots["port"]) == json_kind(dj, boot.roots["jax"])
    method, path = route.split(" ")
    assert (method, path) not in {(m, p) for m, p, _ in admin.NOT_PORTED_ROUTES}
    if route == "POST /pools/attach":
        assert dp == dj == {"pool": 2, "status": "active"}
    if route == "POST /pools/decommission":
        assert dp["drain"]["pool_index"] == 2
        after = boot.ported["port"]["GET /pools/status after"][1]
        assert [p["status"] for p in after["pools"]] == ["active", "active", "decommissioned"]
        jax_after = boot.ported["jax"]["GET /pools/status after"][1]
        assert json_kind(after, boot.roots["port"]) == json_kind(jax_after, boot.roots["jax"])
    if route == "PUT /quota":
        assert boot.ported["port"]["GET /quota after"] == boot.ported["jax"]["GET /quota after"] == (
            200, {"quota": 1 << 30, "quotatype": "hard"})
    if route == "GET /tiers":
        assert [t["dir"] for t in dp] == [os.path.join(boot.roots["port"], "tier")]
        assert "secret_key" not in dp[0]


def test_unported_routes_are_every_other_jax_admin_route():
    """The port registers every route of the JAX admin API: the ported ones
    and NOT_PORTED_ROUTES."""
    import inspect

    from minio_tpu.api import admin as jax_admin

    pat = re.compile(r'app\.router\.add_(get|post|put|delete)\("([^"]+)"')
    jax_routes = {(m.upper(), p) for m, p in pat.findall(inspect.getsource(jax_admin))}
    port_routes = {(m.upper(), p) for m, p in pat.findall(inspect.getsource(admin))}
    unported = {(m, p) for m, p, _ in admin.NOT_PORTED_ROUTES}
    assert port_routes | unported == jax_routes
    assert not port_routes & unported


# -- control/config.py, control/healmgr.py and cli.expand_ellipses unit cases ------------


class _DictStore:
    def __init__(self):
        self.blobs = {}

    def put(self, path, data):
        self.blobs[path] = data

    def get(self, path):
        return self.blobs.get(path)


CONFIG_OPS = {
    "dump": [],
    "set-dynamic": [("set", "compression", "enable", "on")],
    "set-static": [("set", "identity_ldap", "server_addr", "ldap:389")],
    "set-unset": [("set", "scanner", "delay", "3"), ("unset", "scanner", "delay")],
    "unknown-key": [("set", "compression", "nope", "x")],
    "unknown-subsys": [("set", "nope", "enable", "on")],
    "env-override": [("env", "MINIO_TPU_COMPRESSION_ENABLE", "on")],
    "persist-load": [("set", "heal", "max_io", "7"), ("reload",)],
}


@pytest.mark.parametrize("case", sorted(CONFIG_OPS))
def test_config_sys_against_jax(case, monkeypatch):
    results = {}
    for name, mod in (("jax", jax_config), ("port", port_config)):
        store = _DictStore()
        cfg = mod.ConfigSys(store)
        trace = []
        for op in CONFIG_OPS[case]:
            try:
                if op[0] == "set":
                    trace.append(cfg.set(*op[1:]))
                elif op[0] == "unset":
                    trace.append(cfg.unset(*op[1:]))
                elif op[0] == "env":
                    monkeypatch.setenv(op[1], op[2])
                elif op[0] == "reload":
                    cfg = mod.ConfigSys(store)
                    cfg.load()
            except Exception as e:  # noqa: BLE001 - the error is part of the result
                trace.append((type(e).__name__, str(e)))
        trace.append(cfg.get_bool("compression", "enable"))
        trace.append(cfg.get("heal", "max_io"))
        results[name] = (trace, cfg.dump(), store.blobs)
    assert results["port"] == results["jax"]


def _small_layers(root: str):
    """One 4-drive set in each package, formatted alike; the JAX side on
    its numpy host codec, the port on the plain versions."""
    formats = jax_format.init_format(1, 4)
    out = {}
    for name, local, sets_cls, pools_cls, fmt_mod, codec in (
        ("jax", JaxLocalDrive, JaxErasureSets, JaxServerPools, jax_format, JaxHostCodec()),
        ("port", LocalDrive, ErasureSets, ServerPools, port_format, BatchingDeviceCodec(device="cpu")),
    ):
        dirs = []
        for i, f in enumerate(formats):
            d = os.path.join(root, name, f"d{i}")
            os.makedirs(d)
            f.save(d)
            dirs.append(d)
        drives = [local(d) for d in dirs]
        sets = sets_cls.from_drives(drives, fmt_mod.DriveFormat.load(dirs[0]), parity=2, codec=codec)
        out[name] = SimpleNamespace(layer=pools_cls([sets]), drives=drives, dirs=dirs, codec=codec)
    return out


def _lose(dirs, idx, bucket, key):
    shutil.rmtree(os.path.join(dirs[idx], bucket, key))


HEAL_CASES = ["mrf", "sequence", "disk-monitor"]


@pytest.mark.parametrize("case", HEAL_CASES)
def test_heal_manager_against_jax(tmp_path, case):
    sides = _small_layers(str(tmp_path))
    data = {f"o{i}": np.random.default_rng(i).integers(0, 256, 2000 + 700 * i, dtype=np.uint8).tobytes()
            for i in range(3)}
    results = {}
    try:
        for name, mod in (("jax", jax_healmgr), ("port", port_healmgr)):
            s = sides[name]
            s.layer.make_bucket("hbk")
            for k, v in data.items():
                s.layer.put_object("hbk", k, v)
            if case == "mrf":
                _lose(s.dirs, 1, "hbk", "o1")
                q = mod.MRFQueue(s.layer, start=False)
                q.add("hbk", "o1")
                results[name] = (q.drain(), q.healed, q.failed, q.dropped)
            elif case == "sequence":
                for k in data:
                    _lose(s.dirs, 2, "hbk", k)
                hm = mod.HealManager(s.layer)
                seq = hm.start_sequence("hbk")
                hm.join(seq)
                st = hm.get_status(seq)
                results[name] = (st.path, st.running, st.scanned, st.healed, st.failed, hm.check_drives())
                hm.stop()
            else:
                shutil.rmtree(os.path.join(s.dirs[3], "hbk"))
                tracker = mod.mark_drive_for_healing(s.drives[3])
                mon = mod.DiskHealMonitor(s.layer, interval=999, start=False)
                done = mon.tick()
                t = mon.completed[0]
                results[name] = (done, t.objects_scanned, t.objects_healed, t.objects_failed, t.finished,
                                 bool(tracker.endpoint), mod.HealingTracker.load(s.drives[3]))
                mon.stop()
            for k, v in data.items():
                assert s.layer.get_object("hbk", k)[1] == v
            results[name + "-files"] = sorted(
                os.path.relpath(os.path.join(dp, f), s.dirs[0])
                for dp, _, fs in os.walk(s.dirs[0]) for f in fs if "hbk" in dp and f == "xl.meta")
    finally:
        sides["port"].codec.close()
    assert results["port"] == results["jax"]
    assert results["port-files"] == results["jax-files"]


ELLIPSES = [
    "/data/disk{1...4}",
    "/data/disk{01...16}",
    "/mnt/d{1...2}/e{3...4}",
    "http://10.0.0.{1...2}:9000/mnt/disk{1...2}",
    "/plain/path",
    "/data/disk{0...0}",
    "/data/{098...101}",
    "/data/disk{4...1}",
    "/data/disk{1..4}",
    "/data/disk{a...d}",
    "/data/disk{1...4",
    "/data/disk}",
]


@pytest.mark.parametrize("pattern", ELLIPSES)
def test_expand_ellipses_against_jax(pattern):
    def run(fn):
        try:
            return fn(pattern)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(cli.expand_ellipses) == run(jax_cli.expand_ellipses)


@pytest.mark.parametrize("args", [["/a{1...2}", "/b{1...2}"], ["/a{1...2}", "/a{2...3}"], ["/x", "/x"]])
def test_expand_endpoints_against_jax(args):
    def run(fn):
        try:
            return fn(args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(cli.expand_endpoints) == run(jax_cli.expand_endpoints)


def test_boot_self_test_passes_with_the_jax_goldens():
    assert (goldens.HH_GOLDEN, goldens.RS_GOLDEN) == (jax_cli._HH_GOLDEN, jax_cli._RS_GOLDEN)
    cli.boot_self_test()


def test_remote_endpoint_becomes_a_remote_drive(tmp_path):
    from minio_tpu_torch.dist.storage_rest import RemoteDrive

    local = [str(tmp_path / f"d{i}") for i in range(2)]
    node = Node([f"http://10.0.0.1:9000{local[0]}", f"http://10.0.0.1:9000{local[1]}",
                 "http://10.0.0.2:9000/d1", "http://10.0.0.2:9000/d2"], url="http://10.0.0.1:9000", device="cpu")
    try:
        remote = [d for d in node.drives if isinstance(d, RemoteDrive)]
        assert [d.endpoint() for d in remote] == ["http://10.0.0.2:9000/d1", "http://10.0.0.2:9000/d2"]
        assert sorted(node.local_drives) == local
        assert node.peer_urls == ["http://10.0.0.2:9000"] and node.is_leader
    finally:
        node.close()
