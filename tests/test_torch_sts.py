"""STS and identity of minio_tpu_torch on the CPU (api/sts.py, api/jwt.py,
control/ldap.py), held against the JAX package's.

The STS cases of tests/test_admin_sts.py run on a port Node over HTTP
(device="cpu": the kernels' plain versions), with the IAM admin cases they
stand on; the cases of tests/test_sts_federation.py run on a port S3Server:
OIDC tokens signed with RS256 keys from `cryptography` and HS256, LDAP
through tests/ldapstub.py (an in-process server speaking the JAX module's
BER), mTLS at the handler level. Then the packages are held byte for byte:
the same claims and key give the same HS256 token from both jwt modules,
both verify the same tokens alike, and both LDAP clients send the same BER
bytes for the same bind, search and unbind. Tolerance: exact.
"""

from __future__ import annotations

import base64
import json
import os
import re
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest
import requests

from minio_tpu.api import jwt as jax_jwt
from minio_tpu.control import ldap as jax_ldap
from minio_tpu_torch import cli, runtime
from minio_tpu_torch.api import jwt as port_jwt
from minio_tpu_torch.api import sts as port_sts
from minio_tpu_torch.api.errors import S3Error
from minio_tpu_torch.api.server import S3Server, ThreadedServer
from minio_tpu_torch.control import ldap as port_ldap
from minio_tpu_torch.control.config import ConfigSys
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage.local import LocalDrive
from tests.s3client import S3TestClient

ROOT = "adminroot"
SECRET = "admin-secret-key"
ADMIN = "/mtpu/admin/v1"
NS = "{https://sts.amazonaws.com/doc/2011-06-15/}"
HMAC_SECRET = "oidc-shared-secret"
READ_POLICY = {
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject", "s3:ListBucket"], "Resource": ["arn:aws:s3:::*"]}],
}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def srv(tmp_path_factory, codec):
    tmp = tmp_path_factory.mktemp("adminsrv")
    node = Node([str(tmp / f"d{i}") for i in range(4)], root_user=ROOT, root_password=SECRET, codec=codec,
                device="cpu")
    stop = threading.Event()
    port = _free_port()
    thread, errs = cli._run_app_until(node.make_app(), "127.0.0.1", port, stop)
    assert not errs, errs
    node.build()
    url = f"http://127.0.0.1:{port}"
    try:
        yield {"client": S3TestClient(url, ROOT, SECRET), "node": node, "url": url}
    finally:
        stop.set()
        thread.join(10)
        node.close()


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()


def _creds(content: bytes) -> tuple[str, str]:
    root = ET.fromstring(content)
    return root.find(f".//{NS}AccessKeyId").text, root.find(f".//{NS}SecretAccessKey").text


# -- the identity cases of tests/test_admin_sts.py, on a port node ------------------------


class TestAdmin:
    def test_group_management_loop(self, srv):
        c = srv["client"]
        assert c.request("POST", f"{ADMIN}/users",
                         body=json.dumps({"accessKey": "grpuser", "secretKey": "grpsecret1234"}).encode()
                         ).status_code == 200
        r = c.request("PUT", f"{ADMIN}/groups/team", body=json.dumps({"members": ["grpuser"]}).encode())
        assert r.status_code == 200, r.text
        r = c.request("PUT", f"{ADMIN}/groups/team/policy", body=json.dumps({"policies": ["readwrite"]}).encode())
        assert r.status_code == 200, r.text
        info = c.request("GET", f"{ADMIN}/groups/team").json()
        assert info["members"] == ["grpuser"] and info["policies"] == ["readwrite"]
        assert "team" in c.request("GET", f"{ADMIN}/groups").json()["groups"]
        gu = S3TestClient(srv["url"], "grpuser", "grpsecret1234")
        assert gu.make_bucket("grpbkt").status_code == 200
        c.request("PUT", f"{ADMIN}/groups/team/status", body=json.dumps({"status": "disabled"}).encode())
        assert gu.request("PUT", "/grpbkt/x.txt", body=b"x").status_code == 403
        c.request("PUT", f"{ADMIN}/groups/team/status", body=json.dumps({"status": "enabled"}).encode())
        assert gu.request("PUT", "/grpbkt/x.txt", body=b"x").status_code == 200
        assert c.request("DELETE", f"{ADMIN}/groups/team").status_code == 400
        c.request("PUT", f"{ADMIN}/groups/team", body=json.dumps({"members": ["grpuser"], "isRemove": True}).encode())
        assert gu.request("PUT", "/grpbkt/y.txt", body=b"y").status_code == 403
        assert c.request("DELETE", f"{ADMIN}/groups/team").status_code == 200
        srv["node"].pools.delete_object("grpbkt", "x.txt")
        c.request("DELETE", f"{ADMIN}/users/grpuser")

    def test_info(self, srv):
        r = srv["client"].request("GET", f"{ADMIN}/info")
        assert r.status_code == 200, r.text
        info = r.json()
        assert info["drivesOnline"] == 4 and info["mode"] == "online"

    def test_user_management(self, srv):
        c = srv["client"]
        r = c.request("POST", f"{ADMIN}/users", body=json.dumps(
            {"accessKey": "alice", "secretKey": "alice-secret-12", "policies": ["readwrite"]}).encode())
        assert r.status_code == 200, r.text
        assert c.request("GET", f"{ADMIN}/users").json()["alice"]["policies"] == ["readwrite"]
        alice = S3TestClient(srv["url"], "alice", "alice-secret-12")
        assert alice.make_bucket("alicebkt").status_code == 200
        assert alice.request("GET", f"{ADMIN}/info").status_code == 403
        c.request("PUT", f"{ADMIN}/users/alice/status", body=b'{"status": "disabled"}')
        assert alice.request("GET", "/").status_code == 403
        assert c.request("DELETE", f"{ADMIN}/users/alice").status_code == 200

    def test_policies_crud(self, srv):
        c = srv["client"]
        doc = {"Version": "2012-10-17",
               "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::pub/*"]}]}
        assert c.request("PUT", f"{ADMIN}/policies/getonly", body=json.dumps(doc).encode()).status_code == 200
        pols = c.request("GET", f"{ADMIN}/policies").json()
        assert "getonly" in pols and "readonly" in pols
        assert c.request("DELETE", f"{ADMIN}/policies/getonly").status_code == 200

    def test_service_account(self, srv):
        sa = srv["client"].request("POST", f"{ADMIN}/service-accounts", body=b"{}").json()
        assert S3TestClient(srv["url"], sa["accessKey"], sa["secretKey"]).request("GET", "/").status_code == 200


class TestSTS:
    def test_assume_role(self, srv):
        c = srv["client"]
        c.request("POST", f"{ADMIN}/users", body=json.dumps(
            {"accessKey": "bob", "secretKey": "bob-secret-123", "policies": ["readonly"]}).encode())
        bob = S3TestClient(srv["url"], "bob", "bob-secret-123")
        r = bob.request("POST", "/", body=b"Action=AssumeRole&Version=2011-06-15&DurationSeconds=900")
        assert r.status_code == 200, r.text
        temp = S3TestClient(srv["url"], *_creds(r.content))
        c.make_bucket("stsread")
        c.put_object("stsread", "k", b"readonly-data")
        assert temp.get_object("stsread", "k").content == b"readonly-data"
        assert temp.make_bucket("stsbkt").status_code == 403

    def test_assume_role_with_session_policy(self, srv):
        c = srv["client"]
        c.make_bucket("stsdata")
        c.put_object("stsdata", "k", b"v")
        policy = json.dumps({"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::stsdata/*"]}]})
        r = c.request("POST", "/",
                      body=f"Action=AssumeRole&Version=2011-06-15&Policy={urllib.parse.quote(policy)}".encode())
        assert r.status_code == 200, r.text
        temp = S3TestClient(srv["url"], *_creds(r.content))
        assert temp.get_object("stsdata", "k").content == b"v"
        assert temp.make_bucket("other-bkt").status_code == 403

    def test_unsigned_assume_role_is_refused(self, srv):
        r = requests.post(srv["url"] + "/", data={"Action": "AssumeRole", "Version": "2011-06-15"}, timeout=10)
        assert r.status_code == 403


# -- the cases of tests/test_sts_federation.py, on a port S3Server -------------------------


def _rsa_keypair():
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_numbers()

    def b64url_uint(v: int) -> str:
        return base64.urlsafe_b64encode(v.to_bytes((v.bit_length() + 7) // 8, "big")).rstrip(b"=").decode()

    return key, {"keys": [{"kty": "RSA", "kid": "k1", "n": b64url_uint(pub.n), "e": b64url_uint(pub.e)}]}


def _sign_rs256(key, payload: dict, kid: str = "k1") -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    def enc(obj) -> str:
        return base64.urlsafe_b64encode(json.dumps(obj).encode()).rstrip(b"=").decode()

    signing_input = f"{enc({'alg': 'RS256', 'typ': 'JWT', 'kid': kid})}.{enc(payload)}"
    sig = key.sign(signing_input.encode(), padding.PKCS1v15(), hashes.SHA256())
    return signing_input + "." + base64.urlsafe_b64encode(sig).rstrip(b"=").decode()


@pytest.fixture(scope="module")
def rsa_key():
    return _rsa_keypair()


@pytest.fixture(scope="module")
def fed(tmp_path_factory, codec, rsa_key):
    tmp = tmp_path_factory.mktemp("stsfed")
    formats = fmt.init_format(1, 4)
    drives = []
    for i, f in enumerate(formats):
        d = str(tmp / f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    layer = ServerPools([ErasureSets.from_drives(drives, formats[0], codec=codec)])
    iam = IAMSys("fedroot", "fedroot-secret")
    iam.set_policy("token-readers", READ_POLICY)
    config = ConfigSys()
    key, jwks = rsa_key
    config.set("identity_openid", "jwks", json.dumps(jwks))
    config.set("identity_openid", "hmac_secret", HMAC_SECRET)
    config.set("identity_openid", "client_id", "mtpu-app")
    ts = ThreadedServer(S3Server(layer, iam, check_skew=False, config=config))
    endpoint = ts.start()
    root = S3TestClient(endpoint, "fedroot", "fedroot-secret")
    root.make_bucket("fedbkt")
    root.put_object("fedbkt", "data.txt", b"federated read")
    try:
        yield {"endpoint": endpoint, "key": key, "root": root, "iam": iam, "config": config}
    finally:
        ts.stop()


def _sts_post(endpoint, form: dict):
    return requests.post(endpoint + "/", data=form, timeout=10)


def _extract_creds(xml_text: str) -> tuple[str, str]:
    ak = re.search(r"<AccessKeyId>([^<]+)</AccessKeyId>", xml_text).group(1)
    sk = re.search(r"<SecretAccessKey>([^<]+)</SecretAccessKey>", xml_text).group(1)
    return ak, sk


def test_web_identity_rs256(fed):
    token = _sign_rs256(fed["key"], {"sub": "alice@idp", "aud": "mtpu-app", "exp": time.time() + 3600,
                                     "policy": "token-readers"})
    r = _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": token,
                                    "Version": "2011-06-15"})
    assert r.status_code == 200, r.text
    assert "<SubjectFromWebIdentityToken>alice@idp</SubjectFromWebIdentityToken>" in r.text
    c = S3TestClient(fed["endpoint"], *_extract_creds(r.text))
    assert c.get_object("fedbkt", "data.txt").content == b"federated read"
    assert c.put_object("fedbkt", "write.txt", b"nope").status_code == 403


def test_client_grants_hs256(fed):
    token = port_jwt.sign_hs256({"sub": "svc-1", "aud": "mtpu-app", "exp": time.time() + 600,
                                 "policy": "token-readers"}, HMAC_SECRET)
    r = _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithClientGrants", "Token": token, "Version": "2011-06-15"})
    assert r.status_code == 200, r.text
    c = S3TestClient(fed["endpoint"], *_extract_creds(r.text))
    assert c.get_object("fedbkt", "data.txt").status_code == 200


REJECTED = {
    "bad-signature": ({"sub": "eve", "aud": "mtpu-app", "exp": 600, "policy": "token-readers"}, "wrong-secret"),
    "expired": ({"sub": "late", "aud": "mtpu-app", "exp": -10, "policy": "token-readers"}, HMAC_SECRET),
    "audience-mismatch": ({"sub": "other", "aud": "other-app", "exp": 600, "policy": "token-readers"}, HMAC_SECRET),
    "missing-policy-claim": ({"sub": "nopol", "aud": "mtpu-app", "exp": 600}, HMAC_SECRET),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_bad_tokens_rejected(fed, case):
    claims, secret = REJECTED[case]
    token = port_jwt.sign_hs256({**claims, "exp": time.time() + claims["exp"]}, secret)
    r = _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": token})
    assert r.status_code == 403


def test_cred_lifetime_capped_by_token_exp(fed):
    token = port_jwt.sign_hs256({"sub": "short", "aud": "mtpu-app", "exp": time.time() + 1000,
                                 "policy": "token-readers"}, HMAC_SECRET)
    r = _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": token,
                                    "DurationSeconds": "86400"})
    assert r.status_code == 200
    ak, _ = _extract_creds(r.text)
    assert fed["iam"].users[ak].expiration <= time.time() + 1001


def test_ldap_gated(fed):
    assert _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithLDAPIdentity"}).status_code == 501


ALICE_DN = "uid=alice,ou=people,dc=example,dc=org"
DEVS_DN = "cn=devs,ou=groups,dc=example,dc=org"


@pytest.fixture()
def ldap(fed):
    from tests.ldapstub import StubLDAP

    stub = StubLDAP(
        directory={
            ALICE_DN: {"uid": ["alice"], "objectclass": ["person"]},
            "uid=bob,ou=people,dc=example,dc=org": {"uid": ["bob"], "objectclass": ["person"]},
            DEVS_DN: {"objectclass": ["groupOfNames"], "member": [ALICE_DN]},
        },
        passwords={ALICE_DN: "alice-pw", "uid=bob,ou=people,dc=example,dc=org": "bob-pw",
                   "cn=lookup,dc=example,dc=org": "lookup-pw"},
    )
    cfg_keys = {
        "server_addr": stub.addr,
        "lookup_bind_dn": "cn=lookup,dc=example,dc=org",
        "lookup_bind_password": "lookup-pw",
        "user_dn_search_base_dn": "ou=people,dc=example,dc=org",
        "user_dn_search_filter": "(uid=%s)",
        "group_search_base_dn": "ou=groups,dc=example,dc=org",
        "group_search_filter": "(&(objectclass=groupOfNames)(member=%d))",
    }
    for k, v in cfg_keys.items():
        fed["config"].set("identity_ldap", k, v)
    yield stub
    for k in cfg_keys:
        fed["config"].unset("identity_ldap", k)
    fed["iam"].ldap_policy_map.clear()
    stub.close()


def _ldap_sts(fed, user, pw):
    return _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithLDAPIdentity", "LDAPUsername": user,
                                       "LDAPPassword": pw, "Version": "2011-06-15"})


def test_ldap_sts_flow_end_to_end(fed, ldap):
    fed["iam"].set_ldap_policy(ALICE_DN, ["token-readers"])
    r = _ldap_sts(fed, "alice", "alice-pw")
    assert r.status_code == 200, r.text
    c = S3TestClient(fed["endpoint"], *_extract_creds(r.text))
    assert c.get_object("fedbkt", "data.txt").content == b"federated read"
    assert c.request("PUT", "/fedbkt/new.txt", body=b"x").status_code == 403


def test_ldap_group_policy_mapping(fed, ldap):
    fed["iam"].set_ldap_policy(DEVS_DN, ["token-readers"])
    r = _ldap_sts(fed, "alice", "alice-pw")
    assert r.status_code == 200, r.text
    c = S3TestClient(fed["endpoint"], *_extract_creds(r.text))
    assert c.get_object("fedbkt", "data.txt").status_code == 200
    assert _ldap_sts(fed, "bob", "bob-pw").status_code == 403


def test_ldap_wrong_password_rejected(fed, ldap):
    fed["iam"].set_ldap_policy(ALICE_DN, ["token-readers"])
    r = _ldap_sts(fed, "alice", "wrong")
    assert r.status_code == 403 and "<AccessKeyId>" not in r.text


def test_ldap_empty_password_rejected(fed, ldap):
    fed["iam"].set_ldap_policy(ALICE_DN, ["token-readers"])
    before = list(ldap.binds)
    assert _ldap_sts(fed, "alice", "").status_code == 400
    assert ldap.binds == before


def test_ldap_unknown_user(fed, ldap):
    assert _ldap_sts(fed, "mallory", "x").status_code == 403


def test_ldap_filter_injection_escaped(fed, ldap):
    fed["iam"].set_ldap_policy(ALICE_DN, ["token-readers"])
    assert _ldap_sts(fed, "*", "alice-pw").status_code == 403


def test_ldap_filter_compile_unit():
    f = port_ldap.compile_filter("(&(objectclass=person)(uid=al\\2aice))")
    assert f[0] == port_ldap.FILTER_AND
    assert port_ldap.compile_filter("(uid=*)")[0] == port_ldap.FILTER_PRESENT
    with pytest.raises(port_ldap.LDAPError):
        port_ldap.compile_filter("(uid=par*tial)")
    assert port_ldap.escape_filter_value("a*(b)\\c") == "a\\2a\\28b\\29\\5cc"


def test_certificate_flow_unit():
    iam = IAMSys("r", "rsecretsecret")
    iam.set_policy("edge-device", READ_POLICY)
    config = ConfigSys()

    class FakeTransport:
        def __init__(self, cert):
            self._cert = cert

        def get_extra_info(self, name):
            return self._cert if name == "peercert" else None

    class FakeRequest:
        def __init__(self, cert):
            self.transport = FakeTransport(cert)

    cert = {"subject": ((("commonName", "edge-device"),),)}
    with pytest.raises(S3Error) as ei:
        port_sts.handle_sts(iam, "", {"Action": "AssumeRoleWithCertificate"}, config, FakeRequest(cert))
    assert ei.value.code == "NotImplemented"
    config.set("identity_tls", "enable", "on")
    resp = port_sts.handle_sts(iam, "", {"Action": "AssumeRoleWithCertificate"}, config, FakeRequest(cert))
    assert resp.status == 200
    ak, _ = _extract_creds(resp.body.decode())
    assert iam.users[ak].policies == ["edge-device"]
    with pytest.raises(S3Error) as ei:
        port_sts.handle_sts(iam, "", {"Action": "AssumeRoleWithCertificate"}, config, FakeRequest(None))
    assert ei.value.code == "InvalidRequest"


def test_session_policy_narrows_federated_creds(fed):
    narrow = {"Version": "2012-10-17",
              "Statement": [{"Effect": "Allow", "Action": ["s3:ListBucket"], "Resource": ["arn:aws:s3:::fedbkt"]}]}
    token = port_jwt.sign_hs256({"sub": "narrowed", "aud": "mtpu-app", "exp": time.time() + 600,
                                 "policy": "token-readers"}, HMAC_SECRET)
    r = _sts_post(fed["endpoint"], {"Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": token,
                                    "Policy": json.dumps(narrow)})
    assert r.status_code == 200, r.text
    c = S3TestClient(fed["endpoint"], *_extract_creds(r.text))
    assert c.request("GET", "/fedbkt", query=[("list-type", "2")]).status_code == 200
    assert c.get_object("fedbkt", "data.txt").status_code == 403


# -- the two packages byte for byte --------------------------------------------------------

CLAIMS = {
    "plain": ({"sub": "a", "exp": 1_900_000_000}, "k", None),
    "nested": ({"sub": "svc", "aud": ["x", "y"], "policy": "p1,p2", "n": 3.25, "ok": True, "u": "é"}, "s3cr3t",
               None),
    "header-extra": ({"sub": "b", "nbf": 1_700_000_000}, "other-key", {"kid": "k9"}),
}


@pytest.mark.parametrize("case", sorted(CLAIMS))
def test_hs256_tokens_are_the_same_bytes(case):
    claims, secret, extra = CLAIMS[case]
    tok = port_jwt.sign_hs256(claims, secret, extra)
    assert tok == jax_jwt.sign_hs256(claims, secret, extra)
    now = {"exp": time.time() + 60}
    assert port_jwt.verify(port_jwt.sign_hs256({**claims, **now}, secret), hmac_secret=secret) == \
        jax_jwt.verify(jax_jwt.sign_hs256({**claims, **now}, secret), hmac_secret=secret)


def _verdict(mod, token, **kw):
    try:
        return ("ok", mod.verify(token, **kw))
    except mod.JWTError as e:
        return ("error", str(e))


def test_both_jwt_modules_judge_tokens_alike(rsa_key):
    key, jwks = rsa_key
    now = time.time()
    tokens = {
        "rs256": _sign_rs256(key, {"sub": "r", "aud": "app", "exp": now + 60}),
        "rs256-unknown-kid": _sign_rs256(key, {"sub": "r", "exp": now + 60}, kid="nope"),
        "rs256-expired": _sign_rs256(key, {"sub": "r", "exp": now - 60}),
        "rs256-tampered": _sign_rs256(key, {"sub": "r", "exp": now + 60})[:-4] + "AAAA",
        "hs256": port_jwt.sign_hs256({"sub": "h", "aud": "app", "exp": now + 60}, HMAC_SECRET),
        "hs256-wrong-aud": port_jwt.sign_hs256({"sub": "h", "aud": "x", "exp": now + 60}, HMAC_SECRET),
        "hs256-not-yet": port_jwt.sign_hs256({"sub": "h", "nbf": now + 600}, HMAC_SECRET),
        "garbage": "not.a.token",
    }
    for name, tok in tokens.items():
        kw = {"jwks": jwks, "hmac_secret": HMAC_SECRET, "audience": "app"}
        assert _verdict(port_jwt, tok, **kw) == _verdict(jax_jwt, tok, **kw), name


class _Recorder:
    """A socket that records what an LDAP client sends and answers each
    request with a success (a BindResponse, or one entry and SearchDone)."""

    def __init__(self, ldap_mod):
        self.m = ldap_mod
        self.sent = []
        self._out = b""

    def sendall(self, data):
        m = self.m
        self.sent.append(bytes(data))
        _, content, _ = m.ber_read(data)
        _, mid_raw, pos = m.ber_read(content)
        op_tag, _, _ = m.ber_read(content, pos)
        mid = m.ber_int(m.ber_read_int(mid_raw))
        ok = m.ber_int(0, m.TAG_ENUM) + m.tlv(m.TAG_OCTET, b"") + m.tlv(m.TAG_OCTET, b"")
        if op_tag == m.APP_BIND_REQ:
            self._out += m.tlv(m.TAG_SEQ, mid + m.tlv(m.APP_BIND_RESP, ok))
        elif op_tag == m.APP_SEARCH_REQ:
            attr = m.tlv(m.TAG_SEQ, m.tlv(m.TAG_OCTET, b"uid") + m.tlv(m.TAG_SET, m.tlv(m.TAG_OCTET, b"alice")))
            entry = m.tlv(m.APP_SEARCH_ENTRY, m.tlv(m.TAG_OCTET, ALICE_DN.encode()) + m.tlv(m.TAG_SEQ, attr))
            self._out += m.tlv(m.TAG_SEQ, mid + entry) + m.tlv(m.TAG_SEQ, mid + m.tlv(m.APP_SEARCH_DONE, ok))

    def recv(self, n):
        out, self._out = self._out[:n], self._out[n:]
        return out

    def close(self):
        pass


def _ldap_session(mod, monkeypatch):
    rec = _Recorder(mod)
    monkeypatch.setattr(mod.socket, "create_connection", lambda addr, timeout=None: rec)
    client = mod.LDAPClient("127.0.0.1:389")
    client.bind("cn=lookup,dc=example,dc=org", "lookup-pw")
    found = client.search("ou=people,dc=example,dc=org", "(&(objectclass=person)(uid=al\\2aice))", ["uid", "cn"])
    client.search("ou=groups,dc=example,dc=org", f"(|(member={mod.escape_filter_value(ALICE_DN)})(!(cn=x)))",
                  scope=1)
    client.close()
    return rec.sent, found


def test_ldap_clients_send_the_same_ber_bytes(monkeypatch):
    port_sent, port_found = _ldap_session(port_ldap, monkeypatch)
    jax_sent, jax_found = _ldap_session(jax_ldap, monkeypatch)
    assert len(port_sent) == 4 and port_sent == jax_sent
    assert port_found == jax_found == [(ALICE_DN, {"uid": [b"alice"]})]


BER_FILTERS = ["(uid=alice)", "(uid=*)", "(&(a=1)(|(b=2)(!(c=3))))", "(cn=a\\28b\\29)", "(x=" + "y" * 300 + ")"]


@pytest.mark.parametrize("flt", BER_FILTERS, ids=["eq", "present", "nested", "escaped", "long"])
def test_ber_encodings_are_the_same_bytes(flt):
    assert port_ldap.compile_filter(flt) == jax_ldap.compile_filter(flt)
    for n in (0, 1, 127, 128, 255, 256, 65_535, 1 << 20):
        assert port_ldap.ber_len(n) == jax_ldap.ber_len(n)
        assert port_ldap.tlv(port_ldap.TAG_OCTET, b"z" * (n % 1000)) == jax_ldap.tlv(jax_ldap.TAG_OCTET, b"z" * (n % 1000))
    for v in (0, 1, 127, 128, 255, 256, 2**31 - 1):
        assert port_ldap.ber_int(v) == jax_ldap.ber_int(v)
