"""The embedded web console of minio_tpu_torch on the CPU (api/console.py,
mounted by dist/node.py Node.make_app()), held against the JAX package's.

The cases of tests/test_console.py run on a port Node (device="cpu": the
kernels' plain versions): the page, login with a Bearer JWT, info, bucket
and object browsing, refusals, the management loop (buckets, users,
policies, service accounts, groups) and the 503 before build(). Then a JAX
node and a port node get the same console calls, and every answer must be
the same status and the same JSON shape (keys and list lengths kept;
strings by their hex shape, numbers by their type). Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import re
import threading

import pytest
import requests

from minio_tpu import cli as jax_cli
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.api.console import CONSOLE_PREFIX
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from tests.s3client import S3TestClient

ROOT, SECRET = "consoleadmin", "consolesecret"


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Served:
    def __init__(self, node, run_app_until, build=True):
        self.node = node
        self.stop_evt = threading.Event()
        port = _free_port()
        self.thread, errs = run_app_until(node.make_app(), "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        if build:
            node.build()
        self.base = f"http://127.0.0.1:{port}"

    def stop(self):
        self.stop_evt.set()
        self.thread.join(10)
        self.node.close()


def _dirs(root, name):
    out = []
    for i in range(4):
        d = str(root / name / f"d{i}")
        os.makedirs(d)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def srv(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("console")
    s = Served(Node(_dirs(tmp, "p"), root_user=ROOT, root_password=SECRET, codec=codec, device="cpu"),
               cli._run_app_until)
    try:
        yield {"node": s.node, "base": s.base}
    finally:
        s.stop()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()


def _login(base, ak=ROOT, sk=SECRET):
    return requests.post(f"{base}{CONSOLE_PREFIX}/api/login",
                         data=json.dumps({"accessKey": ak, "secretKey": sk}), timeout=10)


def _caller(base):
    hdrs = {"Authorization": "Bearer " + _login(base).json()["token"]}

    def call(method, path, body=None, **kw):
        return requests.request(method, f"{base}{CONSOLE_PREFIX}/api{path}", headers=hdrs,
                                data=json.dumps(body) if body is not None else None, timeout=10, **kw)

    return call


# -- the cases of tests/test_console.py, on a port node ------------------------------------


def test_page_served(srv):
    r = requests.get(f"{srv['base']}{CONSOLE_PREFIX}/", timeout=10)
    assert r.status_code == 200 and "console" in r.text


def test_login_info_and_browse(srv):
    base, node = srv["base"], srv["node"]
    r = _login(base)
    assert r.status_code == 200, r.text
    hdrs = {"Authorization": f"Bearer {r.json()['token']}"}
    info = requests.get(f"{base}{CONSOLE_PREFIX}/api/info", headers=hdrs, timeout=10).json()
    assert info["drivesTotal"] == 4 and info["drivesOnline"] == 4
    node.pools.make_bucket("conb")
    node.pools.put_object("conb", "dir/x", b"hello world")
    r = requests.get(f"{base}{CONSOLE_PREFIX}/api/buckets", headers=hdrs, timeout=10)
    assert any(b["name"] == "conb" for b in r.json()["buckets"])
    r = requests.get(f"{base}{CONSOLE_PREFIX}/api/objects", params={"bucket": "conb"}, headers=hdrs, timeout=10)
    assert r.json()["prefixes"] == ["dir/"]
    r = requests.get(f"{base}{CONSOLE_PREFIX}/api/objects", params={"bucket": "conb", "prefix": "dir/"},
                     headers=hdrs, timeout=10)
    assert [o["name"] for o in r.json()["objects"]] == ["dir/x"]
    assert requests.get(f"{base}{CONSOLE_PREFIX}/api/metrics", headers=hdrs, timeout=10).status_code == 200


def test_bad_credentials_rejected(srv):
    base = srv["base"]
    assert _login(base, sk="wrong").status_code == 401
    assert requests.get(f"{base}{CONSOLE_PREFIX}/api/info", timeout=10).status_code == 401
    r = requests.get(f"{base}{CONSOLE_PREFIX}/api/info", headers={"Authorization": "Bearer junk.junk.junk"},
                     timeout=10)
    assert r.status_code == 401


def test_non_admin_user_rejected(srv):
    srv["node"].iam.add_user("plainuser", "plainsecret1234")
    assert _login(srv["base"], ak="plainuser", sk="plainsecret1234").status_code == 403


def test_management_loop(srv):
    base = srv["base"]
    call = _caller(base)
    assert call("POST", "/buckets", {"name": "mgmtb"}).status_code == 200
    assert call("POST", "/buckets", {"name": "mgmtb"}).status_code == 409
    assert "mgmtb" in [b["name"] for b in call("GET", "/buckets").json()["buckets"]]
    r = call("POST", "/users", {"accessKey": "conuser", "secretKey": "consecret123", "policies": ["readonly"]})
    assert r.status_code == 200, r.text
    users = {u["accessKey"]: u for u in call("GET", "/users").json()["users"]}
    assert users["conuser"]["policies"] == ["readonly"] and users["conuser"]["secretKey"] == ""
    assert call("POST", "/users", {"accessKey": ROOT, "secretKey": "x" * 12}).status_code == 403
    cu = S3TestClient(base, "conuser", "consecret123")
    assert cu.request("GET", "/mgmtb", query=[("list-type", "2")]).status_code == 200
    assert cu.request("PUT", "/mgmtb/denied.txt", body=b"x").status_code == 403
    assert call("PUT", "/users/policy", {"accessKey": "conuser", "policies": ["readwrite"]}).status_code == 200
    assert cu.request("PUT", "/mgmtb/ok.txt", body=b"x").status_code == 200
    sa = call("POST", "/service-accounts", {"parent": "conuser"}).json()
    sc = S3TestClient(base, sa["accessKey"], sa["secretKey"])
    assert sc.request("GET", "/mgmtb", query=[("list-type", "2")]).status_code == 200
    assert "readonly" in call("GET", "/policies").json()["policies"]
    assert call("POST", "/users", {"accessKey": "frag", "secretKey": "fragsecret12",
                                   "policies": "readonly"}).status_code == 400
    assert call("DELETE", "/users", params={"accessKey": "conuser"}).status_code == 200
    assert _login(base, ak="conuser", sk="consecret123").status_code == 401
    assert sa["accessKey"] not in {u["accessKey"] for u in call("GET", "/users").json()["users"]}
    assert sc.request("GET", "/mgmtb", query=[("list-type", "2")]).status_code == 403
    assert S3TestClient(base, "conuser", "consecret123").request(
        "GET", "/mgmtb", query=[("list-type", "2")]).status_code == 403
    assert call("DELETE", "/buckets", params={"name": "mgmtb"}).status_code == 409
    srv["node"].pools.delete_object("mgmtb", "ok.txt")
    assert call("DELETE", "/buckets", params={"name": "mgmtb"}).status_code == 200
    assert call("DELETE", "/buckets", params={"name": "mgmtb"}).status_code == 404


def test_group_management(srv):
    base = srv["base"]
    call = _caller(base)
    assert call("POST", "/users", {"accessKey": "gcuser", "secretKey": "gcsecret12345"}).status_code == 200
    assert call("POST", "/groups", {"name": "cg", "members": ["gcuser"]}).status_code == 200
    assert call("POST", "/groups", {"name": "cg", "policies": ["readwrite"]}).status_code == 200
    groups = call("GET", "/groups").json()["groups"]
    assert groups[0]["members"] == ["gcuser"] and groups[0]["policies"] == ["readwrite"]
    gu = S3TestClient(base, "gcuser", "gcsecret12345")
    assert gu.make_bucket("cgbkt").status_code == 200
    assert call("POST", "/groups", {"name": "cg", "status": "disabled"}).status_code == 200
    assert gu.request("PUT", "/cgbkt/x", body=b"x").status_code == 403
    assert call("POST", "/groups", {"name": "cg", "isRemove": True, "members": ["gcuser"]}).status_code == 200
    assert call("DELETE", "/groups", params={"name": "cg"}).status_code == 200
    assert call("GET", "/groups").json()["groups"] == []
    assert call("POST", "/groups", {"name": "x", "members": "notalist"}).status_code == 400
    call("DELETE", "/users", params={"accessKey": "gcuser"})
    srv["node"].pools.delete_bucket("cgbkt", force=True)


def test_503_before_build(tmp_path, codec):
    s = Served(Node(_dirs(tmp_path, "u"), root_user=ROOT, root_password=SECRET, codec=codec, device="cpu"),
               cli._run_app_until, build=False)
    try:
        assert _login(s.base).status_code == 503
        assert requests.get(f"{s.base}{CONSOLE_PREFIX}/api/info", timeout=10).status_code == 503
    finally:
        s.stop()


# -- the JAX console and the port's, call for call -----------------------------------------

_HEX = re.compile(r"[0-9a-f]")


def json_kind(value):
    if isinstance(value, dict):
        return {k: json_kind(v) for k, v in value.items()}
    if isinstance(value, list):
        return [json_kind(v) for v in value]
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float)):
        return type(value).__name__
    return _HEX.sub("x", value)


def _script(base, node) -> dict:
    """The same console calls, in order; each answer's status and body."""
    out = {}
    r = _login(base)
    out["login"] = (r.status_code, sorted(r.json()))
    call = _caller(base)

    def rec(name, method, path, body=None, **kw):
        r = call(method, path, body, **kw)
        ctype = r.headers.get("Content-Type", "")
        out[name] = (r.status_code, r.json() if ctype.startswith("application/json") else ctype.split(";")[0])

    rec("create", "POST", "/buckets", {"name": "shape"})
    node.pools.put_object("shape", "a/one", b"1" * 10)
    node.pools.put_object("shape", "two", b"2" * 20)
    rec("create-again", "POST", "/buckets", {"name": "shape"})
    rec("info", "GET", "/info")
    rec("buckets", "GET", "/buckets")
    rec("objects", "GET", "/objects", params={"bucket": "shape"})
    rec("objects-prefix", "GET", "/objects", params={"bucket": "shape", "prefix": "a/"})
    rec("objects-missing", "GET", "/objects", params={"bucket": "nope-bucket"})
    rec("objects-no-bucket", "GET", "/objects")
    rec("metrics", "GET", "/metrics")
    rec("user-add", "POST", "/users", {"accessKey": "shapeuser", "secretKey": "shapesecret1", "policies": ["readonly"]})
    rec("users", "GET", "/users")
    rec("user-policy", "PUT", "/users/policy", {"accessKey": "shapeuser", "policies": ["readwrite"]})
    r = call("POST", "/service-accounts", {"parent": "shapeuser"})
    out["service-account"] = (r.status_code, {k: len(v) for k, v in r.json().items()})  # random keys
    rec("policies", "GET", "/policies")
    rec("group-add", "POST", "/groups", {"name": "sg", "members": ["shapeuser"], "policies": ["readonly"]})
    rec("groups", "GET", "/groups")
    rec("group-delete-non-empty", "DELETE", "/groups", params={"name": "sg"})
    rec("bucket-delete-non-empty", "DELETE", "/buckets", params={"name": "shape"})
    rec("user-delete", "DELETE", "/users", params={"accessKey": "shapeuser"})
    rec("users-after", "GET", "/users")
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("consoleboth")
    sides = {
        "jax": Served(JaxNode(_dirs(tmp, "j"), root_user=ROOT, root_password=SECRET, codec=JaxHostCodec()),
                      jax_cli._run_app_until),
        "port": Served(Node(_dirs(tmp, "p"), root_user=ROOT, root_password=SECRET, codec=codec, device="cpu"),
                       cli._run_app_until),
    }
    try:
        yield {name: _script(s.base, s.node) for name, s in sides.items()}
    finally:
        for s in sides.values():
            s.stop()


STEPS = ["login", "create", "create-again", "info", "buckets", "objects", "objects-prefix", "objects-missing",
         "objects-no-bucket", "metrics", "user-add", "users", "user-policy", "service-account", "policies",
         "group-add", "groups", "group-delete-non-empty", "bucket-delete-non-empty", "user-delete", "users-after"]


@pytest.mark.parametrize("step", STEPS)
def test_console_answers_equal_jax_by_shape(both, step):
    (sj, dj), (sp, dp) = both["jax"][step], both["port"][step]
    assert sp == sj, (step, dj, dp)
    assert json_kind(dp) == json_kind(dj), step
