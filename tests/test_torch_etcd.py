"""The etcd IAM store of minio_tpu_torch on the CPU (control/etcd.py, picked
by dist/node.py Node.build from MINIO_TPU_ETCD_ENDPOINT), held against the
JAX package's.

The cases of tests/test_etcd.py run against this file's own in-process
stub of etcd's v3 JSON gateway: the kv round trip, an unreachable etcd
raising, IAM sealed at rest in etcd, two writers converging, the env
wiring and a port node booting with its IAM in etcd. Then the packages
share one etcd: what one package's EtcdStore writes (the sealed IAM
documents, the raw blobs, the keys) the other's reads, byte for byte, and a
JAX node and a port node over one etcd see each other's users.
Tolerance: exact.
"""

from __future__ import annotations

import base64
import json
import os
import threading

import pytest

from minio_tpu.control import etcd as jax_etcd
from minio_tpu.control.iam import IAMSys as JaxIAMSys
from minio_tpu.dist.node import Node as JaxNode
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch import runtime
from minio_tpu_torch.control.etcd import EtcdClient, EtcdStore, etcd_store_from_env
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.utils import errors


class StubEtcd:
    """v3 JSON gateway subset: /v3/kv/put, /v3/kv/range, /v3/kv/deleterange
    and /v3/maintenance/status over an in-memory dict."""

    def __init__(self):
        import http.server

        self.kv: dict[bytes, bytes] = {}
        self.requests: list[str] = []
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                stub.requests.append(self.path)
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                key = base64.b64decode(req.get("key", ""))
                if self.path.endswith("/kv/put"):
                    stub.kv[key] = base64.b64decode(req.get("value", ""))
                    out = {}
                elif self.path.endswith("/kv/range"):
                    v = stub.kv.get(key)
                    out = {"kvs": [] if v is None else [
                        {"key": base64.b64encode(key).decode(), "value": base64.b64encode(v).decode()}
                    ], "count": "0" if v is None else "1"}
                elif self.path.endswith("/kv/deleterange"):
                    out = {"deleted": str(int(stub.kv.pop(key, None) is not None))}
                elif self.path.endswith("/maintenance/status"):
                    out = {"version": "3.5-stub"}
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def etcd():
    stub = StubEtcd()
    yield stub
    stub.close()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()


def _dirs(root, name):
    out = []
    for i in range(4):
        d = str(root / f"{name}{i}")
        os.makedirs(d)
        out.append(d)
    return out


# -- the cases of tests/test_etcd.py, on the port --------------------------------------------


class TestEtcd:
    def test_kv_roundtrip(self, etcd):
        c = EtcdClient(etcd.endpoint)
        c.put(b"k1", b"v1")
        assert c.get(b"k1") == b"v1"
        assert c.get(b"absent") is None
        c.delete(b"k1")
        assert c.get(b"k1") is None
        assert c.status()["online"] is True

    def test_unreachable_raises_not_none(self):
        c = EtcdClient("http://127.0.0.1:9")  # discard port: refused
        with pytest.raises(errors.StorageError):
            c.get(b"k")
        assert c.status()["online"] is False

    def test_iam_persists_in_etcd_sealed(self, etcd):
        store = EtcdStore(EtcdClient(etcd.endpoint))
        iam = IAMSys("rootak", "root-secret-key", store=store)
        iam.add_user("etcduser", "etcdsecret123", ["readonly"])
        blob = etcd.kv[b"minio_tpu/config/iam/users.json"]
        assert b"etcdsecret123" not in blob and blob.startswith(b"MTPUIAM1")
        other = IAMSys("rootak", "root-secret-key", store=store)
        other.load()
        assert other.lookup("etcduser").secret_key == "etcdsecret123"
        assert other.users["etcduser"].policies == ["readonly"]

    def test_two_gateways_no_lock_still_converge(self, etcd):
        store = EtcdStore(EtcdClient(etcd.endpoint))
        a = IAMSys("rootak", "root-secret-key", store=store)
        b = IAMSys("rootak", "root-secret-key", store=store)
        a.add_user("gw-a", "secretaaaa123")
        b.add_user("gw-b", "secretbbbb123")
        a.attach_policy("gw-b", ["readonly"])
        fresh = IAMSys("rootak", "root-secret-key", store=store)
        fresh.load()
        assert fresh.lookup("gw-a") is not None and fresh.lookup("gw-b") is not None
        assert fresh.users["gw-b"].policies == ["readonly"]

    def test_env_wiring(self, etcd, monkeypatch):
        monkeypatch.setenv("MINIO_TPU_ETCD_ENDPOINT", etcd.endpoint)
        store = etcd_store_from_env()
        assert store is not None
        store.put("x", b"y")
        assert etcd.kv[b"minio_tpu/x"] == b"y"
        monkeypatch.delenv("MINIO_TPU_ETCD_ENDPOINT")
        assert etcd_store_from_env() is None

    def test_node_boot_uses_etcd_for_iam(self, etcd, tmp_path, monkeypatch):
        monkeypatch.setenv("MINIO_TPU_ETCD_ENDPOINT", etcd.endpoint)
        codec = BatchingDeviceCodec(device="cpu")
        nodes = []
        try:
            node = Node(_dirs(tmp_path, "e"), root_user="edroot", root_password="edsecret1234", codec=codec,
                        device="cpu")
            nodes.append(node)
            node.build()
            assert isinstance(node.iam.store, EtcdStore)
            node.iam.add_user("shared", "sharedsecret1")
            assert any(k.endswith(b"users.json") for k in etcd.kv)
            node2 = Node(_dirs(tmp_path, "f"), root_user="edroot", root_password="edsecret1234", codec=codec,
                         device="cpu")
            nodes.append(node2)
            node2.build()
            assert node2.iam.lookup("shared").secret_key == "sharedsecret1"
        finally:
            for n in nodes:
                n.close()
            codec.close()


# -- the two packages over one etcd -----------------------------------------------------------


PACKAGES = {
    "port": (EtcdClient, EtcdStore, IAMSys),
    "jax": (jax_etcd.EtcdClient, jax_etcd.EtcdStore, JaxIAMSys),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_iam_items_cross_packages(etcd, writer):
    reader = "jax" if writer == "port" else "port"
    wc, ws, wiam = PACKAGES[writer]
    rc, rs, riam = PACKAGES[reader]
    w = wiam("rootak", "root-secret-key", store=ws(wc(etcd.endpoint)))
    w.set_policy("shared-read", {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::*"]}]})
    w.add_user("crossuser", "crosssecret12", ["shared-read"])
    w.set_ldap_policy("uid=x,dc=example,dc=org", ["shared-read"])
    written = dict(etcd.kv)
    r = riam("rootak", "root-secret-key", store=rs(rc(etcd.endpoint)))
    r.load()
    assert r.lookup("crossuser").secret_key == "crosssecret12"
    assert r.users["crossuser"].to_dict() == w.users["crossuser"].to_dict()
    assert r.custom_policies == w.custom_policies
    assert r.ldap_policies_for("uid=x,dc=example,dc=org", []) == ["shared-read"]
    # The reader's own write of the same state lands under the same keys.
    r._persist()
    assert sorted(etcd.kv) == sorted(written)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_raw_blobs_and_keys_are_the_same_bytes(etcd, writer):
    reader = "jax" if writer == "port" else "port"
    wc, ws, _ = PACKAGES[writer]
    rc, rs, _ = PACKAGES[reader]
    blob = bytes(range(256)) * 3
    ws(wc(etcd.endpoint), prefix="tenant-a/").put("config/x.bin", blob)
    assert etcd.kv == {b"tenant-a/config/x.bin": blob}
    store = rs(rc(etcd.endpoint), prefix="tenant-a/")
    assert store.get("config/x.bin") == blob
    store.delete("config/x.bin")
    assert etcd.kv == {}
    assert ws(wc(etcd.endpoint), prefix="tenant-a/").get("config/x.bin") is None


def test_jax_and_port_nodes_share_iam_through_etcd(etcd, tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_ETCD_ENDPOINT", etcd.endpoint)
    codec = BatchingDeviceCodec(device="cpu")
    port = jax = None
    try:
        jax = JaxNode(_dirs(tmp_path, "j"), root_user="edroot", root_password="edsecret1234", codec=JaxHostCodec())
        jax.build()
        jax.iam.add_user("from-jax", "fromjaxsecret1", ["readonly"])
        port = Node(_dirs(tmp_path, "p"), root_user="edroot", root_password="edsecret1234", codec=codec,
                    device="cpu")
        port.build()
        assert port.iam.lookup("from-jax").secret_key == "fromjaxsecret1"
        port.iam.add_user("from-port", "fromportsecret1", ["readwrite"])
        jax.iam.load()
        assert jax.iam.lookup("from-port").secret_key == "fromportsecret1"
        assert jax.iam.users["from-port"].policies == ["readwrite"]
    finally:
        for n in (port, jax):
            if n is not None:
                n.close()
        codec.close()
