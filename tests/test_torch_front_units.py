"""The pure functions of minio_tpu_torch's S3 front held against the JAX
package's on the same seeded inputs: SigV4 (canonical request, signing,
the verifier's accept and each reject, presign), aws-chunked encode, decode
and the incremental SignedChunkReader, SigV2, POST policy, bucket-policy
evaluation, object-lock XML, decompression, SSE in both directions and IAM
sealing in both directions. Tolerance: exact (these are wire formats,
signatures, ciphertext formats and access decisions). Plus the card-only
round trip of the port's S3Server over a cuda codec.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import io
import itertools
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.api import auth as j_auth
from minio_tpu.api import postpolicy as j_pp
from minio_tpu.api import sigv2 as j_v2
from minio_tpu.api import streaming as j_stream
from minio_tpu.api.errors import S3Error as JS3Error
from minio_tpu.control import compress as j_compress
from minio_tpu.control import crypto as j_crypto
from minio_tpu.control import kms as j_kms
from minio_tpu.control import objectlock as j_ol
from minio_tpu.control import policy as j_policy
from minio_tpu.control.iam import IAMSys as JIAMSys
from minio_tpu_torch.api import auth as p_auth
from minio_tpu_torch.api import postpolicy as p_pp
from minio_tpu_torch.api import sigv2 as p_v2
from minio_tpu_torch.api import streaming as p_stream
from minio_tpu_torch.api.errors import S3Error as PS3Error
from minio_tpu_torch.control import compress as p_compress
from minio_tpu_torch.control import crypto as p_crypto
from minio_tpu_torch.control import kms as p_kms
from minio_tpu_torch.control import objectlock as p_ol
from minio_tpu_torch.control import policy as p_policy
from minio_tpu_torch.control.iam import IAMSys as PIAMSys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "unitak", "unit-secret-key"
T = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)


def _outcome(fn):
    """A call's value, or the S3 error code it raised (either package's)."""
    try:
        return fn()
    except (JS3Error, PS3Error) as e:
        return f"S3Error {e.code}"


def _request(seed: int):
    """A seeded request: method, path, query and headers."""
    rng = np.random.default_rng(seed)
    method = ["GET", "PUT", "POST", "DELETE", "HEAD"][seed % 5]
    path = "/bkt-" + str(seed) + "/" + "/".join(
        "".join(rng.choice(list("abcXYZ09 -_.~+=%é"), int(rng.integers(1, 9)))) for _ in range(int(rng.integers(1, 4)))
    )
    query = [(k, "".join(rng.choice(list("xy z/=&1"), int(rng.integers(0, 5))))) for k in
             rng.choice(["prefix", "max-keys", "uploadId", "versionId", "delimiter", "marker"],
                        int(rng.integers(0, 4)), replace=False)]
    headers = {"host": "127.0.0.1:9000", "Content-Type": "application/octet-stream",
               "X-Amz-Meta-Color": "  blue   green ", "x-amz-storage-class": "STANDARD"}
    body = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
    return method, path, query, headers, body


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_request_equal(seed):
    method, path, query, headers, body = _request(seed)
    h = {k.lower(): v for k, v in headers.items()}
    signed = sorted(h)
    ph = hashlib.sha256(body).hexdigest()
    assert p_auth.canonical_request(method, path, query, h, signed, ph) == j_auth.canonical_request(
        method, path, query, h, signed, ph)
    assert p_auth.canonical_query(query) == j_auth.canonical_query(query)


@pytest.mark.parametrize("seed", SEEDS)
def test_sign_request_equal(seed):
    method, path, query, headers, body = _request(seed)
    for kw in ({}, {"unsigned_payload": True}, {"payload_hash": p_auth.STREAMING_PAYLOAD}):
        got = p_auth.sign_request(p_auth.Credentials(AK, SK), method, path, query, headers, body, timestamp=T, **kw)
        want = j_auth.sign_request(j_auth.Credentials(AK, SK), method, path, query, headers, body, timestamp=T, **kw)
        assert got == want


def _lookup(creds_cls):
    return lambda ak: creds_cls(AK, SK) if ak == AK else None


def _verify_cases(seed: int) -> dict:
    """Header-signed requests the verifier must accept or refuse, signed now."""
    method, path, query, headers, body = _request(seed)
    now = datetime.datetime.now(datetime.timezone.utc)
    creds = p_auth.Credentials(AK, SK)
    good = p_auth.sign_request(creds, method, path, query, headers, body, timestamp=now)
    bad_sig = dict(good, authorization=good["authorization"][:-4] + "ffff")
    unknown = p_auth.sign_request(p_auth.Credentials("nobody", SK), method, path, query, headers, body, timestamp=now)
    skewed = p_auth.sign_request(creds, method, path, query, headers, body,
                                 timestamp=now - datetime.timedelta(hours=2))
    return {
        "accept": (good, body),
        "signature": (bad_sig, body),
        "unknown-key": (unknown, body),
        "skew": (skewed, body),
        "payload-hash": (good, body + b"x"),
        "malformed": (dict(good, authorization="AWS4-HMAC-SHA256 Credential=x"), body),
        "bad-date": (dict(good, **{"x-amz-date": "yesterday"}), body),
        "streaming-declared": (p_auth.sign_request(creds, method, path, query, headers, None, timestamp=now,
                                                   payload_hash=p_auth.STREAMING_PAYLOAD), None),
    }


@pytest.mark.parametrize("case", ["accept", "signature", "unknown-key", "skew", "payload-hash", "malformed",
                                  "bad-date", "streaming-declared"])
@pytest.mark.parametrize("seed", [0, 3, 6])
def test_sigv4_verifier_equal(seed, case):
    method, path, query, _, _ = _request(seed)
    headers, body = _verify_cases(seed)[case]
    got = _outcome(lambda: p_auth.SigV4Verifier(_lookup(p_auth.Credentials)).verify_signed(
        method, path, query, headers, body))
    want = _outcome(lambda: j_auth.SigV4Verifier(_lookup(j_auth.Credentials)).verify_signed(
        method, path, query, headers, body))
    assert got == want
    assert (got == AK) == (case in ("accept", "streaming-declared"))


def _split(url: str):
    from urllib.parse import parse_qsl, urlsplit

    u = urlsplit(url)
    return u.path, parse_qsl(u.query, keep_blank_values=True)


@pytest.mark.parametrize("case", ["accept", "expired", "tampered", "future"])
def test_presign_equal(case):
    now = datetime.datetime.now(datetime.timezone.utc)
    ts = {"accept": now, "tampered": now, "expired": now - datetime.timedelta(hours=2),
          "future": now + datetime.timedelta(hours=2)}[case]
    args = (p_auth.Credentials(AK, SK), "GET", "/bkt/k ey", [("versionId", "v1")], "h:1", 600, ts)
    url = p_auth.SigV4Verifier(_lookup(p_auth.Credentials)).presign_url(*args)
    assert url == j_auth.SigV4Verifier(_lookup(j_auth.Credentials)).presign_url(
        j_auth.Credentials(AK, SK), *args[1:])
    if case == "tampered":
        url = url[:-4] + "0000"
    path, query = _split(url)
    headers = {"host": "h:1"}
    got = _outcome(lambda: p_auth.SigV4Verifier(_lookup(p_auth.Credentials)).verify_presigned(
        "GET", path, query, headers))
    want = _outcome(lambda: j_auth.SigV4Verifier(_lookup(j_auth.Credentials)).verify_presigned(
        "GET", path, query, headers))
    assert got == want
    assert (got == AK) == (case == "accept")


# -- aws-chunked ----------------------------------------------------------------------


class _Src:
    """A body source that hands out at most `step` bytes a read."""

    def __init__(self, data: bytes, step: int):
        self._b, self._step = io.BytesIO(data), step

    def readinto(self, dest) -> int:
        return self._b.readinto(memoryview(dest)[: self._step])

    def read(self, n: int) -> bytes:
        return self._b.read(min(n, self._step))


@settings(max_examples=25, deadline=None, database=None)
@given(size=st.integers(0, 70_000), chunk=st.sampled_from([1024, 4096, 8192, 65536]),
       step=st.integers(1, 9000), seed=st.integers(0, 2**16))
def test_chunked_encode_decode_and_reader_equal(size, chunk, step, seed):
    payload = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    amz_date, region, sig = "20260304T050607Z", "us-east-1", hashlib.sha256(str(seed).encode()).hexdigest()
    body = p_stream.encode_chunked(payload, sig, p_auth.Credentials(AK, SK), amz_date, region, chunk_size=chunk)
    assert body == j_stream.encode_chunked(payload, sig, j_auth.Credentials(AK, SK), amz_date, region,
                                           chunk_size=chunk)
    assert p_stream.decode_chunked(body, sig, SK, amz_date, region) == payload
    rdr = p_stream.SignedChunkReader(_Src(body, step), sig, SK, amz_date, region)
    out = bytearray()
    buf = bytearray(max(1, step // 2 + 1))
    while True:
        n = rdr.readinto(buf)
        if not n:
            break
        out += buf[:n]
    assert bytes(out) == payload


@pytest.mark.parametrize("where", ["header", "data", "signature"])
def test_chunked_tamper_refused_alike(where):
    payload = bytes(range(256)) * 40
    amz_date, region, sig = "20260304T050607Z", "us-east-1", "ab" * 32
    body = bytearray(p_stream.encode_chunked(payload, sig, p_auth.Credentials(AK, SK), amz_date, region,
                                             chunk_size=4096))
    at = {"header": 1, "data": body.find(b"\r\n") + 10, "signature": body.find(b"signature=") + 12}[where]
    body[at] ^= 0x01
    outcomes = []
    for mod in (p_stream, j_stream):
        def read_all(mod=mod):
            rdr = mod.SignedChunkReader(_Src(bytes(body), 1000), sig, SK, amz_date, region)
            buf = bytearray(3000)
            while rdr.readinto(buf):
                pass
        outcomes.append((_outcome(lambda mod=mod: mod.decode_chunked(bytes(body), sig, SK, amz_date, region)),
                         _outcome(read_all)))
    assert outcomes[0] == outcomes[1]
    assert all(str(o).startswith("S3Error") for o in outcomes[0])


# -- SigV2 and POST policy --------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_sigv2_sign_and_verify_equal(seed):
    method, path, query, headers, _ = _request(seed)
    headers = dict(headers, date="Wed, 04 Mar 2026 05:06:07 GMT", **{"x-amz-meta-a": "1", "Content-MD5": "abc"})
    query = query + [("acl", "")] if seed % 2 else query
    assert p_v2.string_to_sign_v2(method, path, query, headers, headers["date"]) == j_v2.string_to_sign_v2(
        method, path, query, headers, headers["date"])
    signed = p_v2.sign_request_v2(AK, SK, method, path, query, headers)
    assert signed == j_v2.sign_request_v2(AK, SK, method, path, query, headers)
    for h in (signed, dict(signed, authorization=signed["authorization"][:-2] + "xx")):
        got = _outcome(lambda: p_v2.SigV2Verifier(_lookup(p_auth.Credentials)).verify_signed(method, path, query, h))
        want = _outcome(lambda: j_v2.SigV2Verifier(_lookup(j_auth.Credentials)).verify_signed(method, path, query, h))
        assert got == want


@pytest.mark.parametrize("signer", ["port", "jax"])
def test_sigv2_presign_crosses(signer):
    mod = p_v2 if signer == "port" else j_v2
    url = mod.presign_url_v2(AK, SK, "GET", "/bkt/obj", "h:1", expires_in=600, query=[("versionId", "v")])
    path, query = _split(url)
    got = p_v2.SigV2Verifier(_lookup(p_auth.Credentials)).verify_presigned("GET", path, query)
    want = j_v2.SigV2Verifier(_lookup(j_auth.Credentials)).verify_presigned("GET", path, query)
    assert got == want == AK


@pytest.mark.parametrize("case", ["accept", "wrong-key-field", "too-large", "bad-signature", "extra-field"])
@pytest.mark.parametrize("signer", ["port", "jax"])
def test_post_policy_equal(signer, case):
    data = np.random.default_rng(7).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    mod = p_pp if signer == "port" else j_pp
    creds = (p_auth if signer == "port" else j_auth).Credentials(AK, SK)
    cond = [["content-length-range", 0, 100]] if case == "too-large" else None
    extra = {"x-amz-meta-tag": "v"} if case != "extra-field" else None
    body, ctype = mod.build_post_form(creds, "bkt", "up/obj", data, extra_conditions=cond, extra_fields=extra)
    if case == "wrong-key-field":
        body = body.replace(b"\r\n\r\nup/obj\r\n", b"\r\n\r\nup/evil\r\n", 1)
    if case == "bad-signature":
        i = body.find(b'name="x-amz-signature"\r\n\r\n') + len(b'name="x-amz-signature"\r\n\r\n')
        body = body[:i] + (b"0" if body[i:i + 1] != b"0" else b"1") + body[i + 1:]
    if case == "extra-field":
        b = ctype.split("boundary=")[1]
        body = body.replace(f"--{b}\r\n".encode(),
                            f'--{b}\r\nContent-Disposition: form-data; name="x-amz-meta-smuggled"\r\n\r\nz\r\n--{b}\r\n'.encode(), 1)

    def run(m, lookup):
        form = m.parse_multipart_form(body, ctype)
        ak = m.verify_post_signature(form, lookup)
        pol = m.PostPolicy.parse(base64.b64decode(form["policy"]))
        pol.check(form, len(form["file"]), bucket="bkt")
        return ak, sorted((k, v) for k, v in form.items())

    got = _outcome(lambda: run(p_pp, _lookup(p_auth.Credentials)))
    want = _outcome(lambda: run(j_pp, _lookup(j_auth.Credentials)))
    assert got == want
    assert (not isinstance(got, str)) == (case == "accept")


# -- bucket policy ------------------------------------------------------------------------

ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:ListBucket", "s3:DeleteObject", "s3:GetBucketPolicy",
           "s3:BypassGovernanceRetention", "s3:ReplicateObject"]
RESOURCES = ["arn:aws:s3:::bkt", "arn:aws:s3:::bkt/a/b.txt", "arn:aws:s3:::bkt/logs/x", "arn:aws:s3:::other/k"]
CONTEXTS = [{}, {"aws:SourceIp": "10.1.2.3", "s3:prefix": "logs/"}, {"aws:SourceIp": "192.168.0.9",
            "aws:Referer": "http://example.com/x", "s3:prefix": "a/", "aws:SecureTransport": "false"}]


def _policy_doc(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    conds = [
        {}, {"IpAddress": {"aws:SourceIp": ["10.0.0.0/8"]}}, {"NotIpAddress": {"aws:SourceIp": "10.0.0.0/8"}},
        {"StringLike": {"s3:prefix": ["logs/*", "a/"]}}, {"StringEquals": {"aws:Referer": "http://example.com/x"}},
        {"Bool": {"aws:SecureTransport": "true"}}, {"StringNotEquals": {"s3:prefix": "a/"}},
    ]
    stmts = []
    for _ in range(int(rng.integers(1, 4))):
        stmt = {
            "Effect": str(rng.choice(["Allow", "Deny"])),
            "Principal": {"AWS": ["*"]},
            "Action": [str(a) for a in rng.choice(ACTIONS + ["s3:*", "s3:Get*"], int(rng.integers(1, 3)),
                                                    replace=False)],
            "Resource": [str(r) for r in rng.choice(["arn:aws:s3:::bkt", "arn:aws:s3:::bkt/*",
                                                     "arn:aws:s3:::bkt/a/*", "arn:aws:s3:::*"],
                                                    int(rng.integers(1, 3)), replace=False)],
        }
        c = conds[int(rng.integers(0, len(conds)))]
        if c:
            stmt["Condition"] = c
        stmts.append(stmt)
    return {"Version": "2012-10-17", "Statement": stmts}


@pytest.mark.parametrize("seed", range(12))
def test_policy_evaluation_grid_equal(seed):
    doc = _policy_doc(seed)
    pp, jp = p_policy.Policy.from_dict(doc), j_policy.Policy.from_dict(doc)
    assert _outcome(pp.validate) == _outcome(jp.validate)
    for action, resource, ctx in itertools.product(ACTIONS, RESOURCES, CONTEXTS):
        assert pp.is_allowed(action, resource, ctx) == jp.is_allowed(action, resource, ctx), (action, resource, ctx)


def test_s3_action_and_canned_policies_equal():
    cases = itertools.product(["GET", "PUT", "POST", "DELETE", "HEAD"], ["", "bkt"], ["", "k"],
                              [{}, {"uploads": ""}, {"uploadId": "u"}, {"tagging": ""}, {"versioning": ""},
                               {"policy": ""}, {"delete": ""}, {"retention": ""}, {"legal-hold": ""},
                               {"object-lock": ""}, {"acl": ""}, {"location": ""}, {"versions": ""}])
    for method, bucket, key, q in cases:
        assert _outcome(lambda: p_policy.s3_action(method, bucket, key, q)) == _outcome(
            lambda: j_policy.s3_action(method, bucket, key, q)), (method, bucket, key, q)
    assert p_policy.CANNED == j_policy.CANNED
    assert p_policy.resource_arn("b", "k/x") == j_policy.resource_arn("b", "k/x")


# -- object lock ----------------------------------------------------------------------


LOCK_XML = [
    "",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled></ObjectLockConfiguration>",
    "<ObjectLockConfiguration xmlns=\"http://s3.amazonaws.com/doc/2006-03-01/\"><ObjectLockEnabled>Enabled"
    "</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE</Mode><Days>3</Days></DefaultRetention>"
    "</Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled><Rule><DefaultRetention>"
    "<Mode>COMPLIANCE</Mode><Years>1</Years></DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled><Rule><DefaultRetention>"
    "<Mode>BOGUS</Mode><Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled",
]


def _lock_cfg(mod, xml):
    cfg = mod.LockConfig.from_xml(xml)
    return cfg.enabled, cfg.default_retention_meta(1_700_000_000.0)


@pytest.mark.parametrize("i", range(len(LOCK_XML)))
def test_lock_config_parse_equal(i):
    assert _outcome(lambda: _lock_cfg(p_ol, LOCK_XML[i])) == _outcome(lambda: _lock_cfg(j_ol, LOCK_XML[i]))


RETENTION = [
    b"<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>2099-01-01T00:00:00Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>COMPLIANCE</Mode><RetainUntilDate>2030-05-06T07:08:09.123Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>NONE</Mode><RetainUntilDate>2099-01-01T00:00:00Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>GOVERNANCE</Mode></Retention>",
    b"<Retention",
]


@pytest.mark.parametrize("i", range(len(RETENTION)))
def test_retention_and_legal_hold_xml_equal(i):
    assert _outcome(lambda: p_ol.parse_retention_xml(RETENTION[i])) == _outcome(
        lambda: j_ol.parse_retention_xml(RETENTION[i]))
    hold = [b"<LegalHold><Status>ON</Status></LegalHold>", b"<LegalHold><Status>OFF</Status></LegalHold>",
            b"<LegalHold><Status>MAYBE</Status></LegalHold>", b"<LegalHold>", b""][i]
    assert _outcome(lambda: p_ol.parse_legal_hold_xml(hold)) == _outcome(lambda: j_ol.parse_legal_hold_xml(hold))
    assert p_ol.retention_xml("GOVERNANCE", "2099-01-01T00:00:00Z") == j_ol.retention_xml(
        "GOVERNANCE", "2099-01-01T00:00:00Z")
    assert p_ol.legal_hold_xml("ON") == j_ol.legal_hold_xml("ON")


@pytest.mark.parametrize("mode", ["", "GOVERNANCE", "COMPLIANCE"])
@pytest.mark.parametrize("until", ["2000-01-01T00:00:00Z", "2099-01-01T00:00:00Z"])
@pytest.mark.parametrize("hold", ["", "ON", "OFF"])
def test_lock_checks_equal(mode, until, hold):
    meta = {k: v for k, v in ((p_ol.META_MODE, mode), (p_ol.META_RETAIN_UNTIL, until if mode else ""),
                              (p_ol.META_LEGAL_HOLD, hold)) if v}
    for bypass, may in ((False, False), (True, False), (True, True)):
        assert _outcome(lambda: p_ol.check_delete_allowed(meta, bypass, may)) == _outcome(
            lambda: j_ol.check_delete_allowed(meta, bypass, may))
        for new_mode, new_until in (("GOVERNANCE", "2050-01-01T00:00:00Z"), ("COMPLIANCE", "2199-01-01T00:00:00Z")):
            got = _outcome(lambda: p_ol.check_retention_tighten(
                p_ol.LockState.from_meta(meta), new_mode, new_until, bypass, may))
            want = _outcome(lambda: j_ol.check_retention_tighten(
                j_ol.LockState.from_meta(meta), new_mode, new_until, bypass, may))
            assert got == want


# -- compression, SSE, IAM sealing --------------------------------------------------------

# "hello hello hello hello!" in the snappy block format: the length 24, a
# 6-byte literal, a 17-byte copy at offset 6 (2-byte offset form), a
# 1-byte literal.
SNAPPY_VECTOR = bytes([24, 5 << 2]) + b"hello " + bytes([(16 << 2) | 2, 6, 0, 0]) + b"!"


@pytest.mark.parametrize("seed", range(4))
def test_decompress_jax_zlib_output(seed):
    data = np.random.default_rng(seed).integers(0, 4, 50_000 + seed, dtype=np.uint8).tobytes()
    blob = zlib.compress(data, level=1)
    meta = {j_compress.META_COMPRESSION: j_compress.ALGO_ZLIB, j_compress.META_ACTUAL_SIZE: str(len(data))}
    assert p_compress.decompress(blob, meta) == j_compress.decompress(blob, meta) == data
    out, pmeta = p_compress.compress(data)
    assert j_compress.decompress(out, pmeta) == data and pmeta == meta


def test_decompress_snappy():
    from minio_tpu.ops import native

    meta = {j_compress.META_COMPRESSION: j_compress.ALGO_SNAPPY}
    if native.snappy_available():
        data = np.random.default_rng(9).integers(0, 3, 200_000, dtype=np.uint8).tobytes() + b"tail" * 999
        blob = native.snappy_compress(data)
    else:
        data, blob = b"hello hello hello hello!", SNAPPY_VECTOR
    assert p_compress.decompress(blob, meta) == j_compress.decompress(blob, meta) == data
    assert p_compress.snappy_decompress(SNAPPY_VECTOR) == b"hello hello hello hello!"
    with pytest.raises(ValueError):
        p_compress.snappy_decompress(bytes([50, 0x0D]) + b"ab" + bytes([0x0D]))


KMS_MASTER = bytes(range(7, 39))


@pytest.mark.parametrize("size", [0, 1, 65536, 65537, 200_000])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_sse_crosses(direction, size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    client_key = hashlib.sha256(b"client").digest()
    enc, dec = (j_crypto, p_crypto) if direction == "jax-to-port" else (p_crypto, j_crypto)
    kms_e = (j_kms if enc is j_crypto else p_kms).StaticKeyKMS("k1", KMS_MASTER)
    kms_d = (j_kms if dec is j_crypto else p_kms).StaticKeyKMS("k1", KMS_MASTER)
    ssec = enc.sse_c_encrypt(data, client_key, "bkt", "obj")
    assert dec.is_encrypted(ssec.metadata) == dec.ALGO_SSE_C
    assert dec.sse_c_decrypt(ssec.data, ssec.metadata, client_key, "bkt", "obj") == data
    with pytest.raises(Exception):
        dec.sse_c_decrypt(ssec.data, ssec.metadata, hashlib.sha256(b"other").digest(), "bkt", "obj")
    res = enc.sse_s3_encrypt(data, kms_e, "bkt", "obj")
    assert dec.is_encrypted(res.metadata) == dec.ALGO_SSE_S3
    assert dec.sse_s3_decrypt(res.data, res.metadata, kms_d, "bkt", "obj") == data
    sealed = enc.seal_secret(kms_e, "ctx", "tier-secret")
    assert dec.unseal_secret(kms_d, "ctx", sealed) == "tier-secret"


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_iam_sealing_crosses(direction):
    blob = json.dumps({"users": {"u1": {"secret": "s" * 40, "policies": ["readwrite"]}}}).encode()
    j_iam, p_iam = JIAMSys("root", "root-secret-1"), PIAMSys("root", "root-secret-1")
    seal, unseal = (j_iam, p_iam) if direction == "jax-to-port" else (p_iam, j_iam)
    sealed = seal._seal(blob)
    assert sealed.startswith(b"MTPUIAM1") and blob not in sealed
    assert unseal._unseal(sealed) == blob
    assert unseal._unseal(blob) == blob  # a plaintext blob of an older store reads as is
    other = (PIAMSys if unseal is p_iam else JIAMSys)("root", "another-secret")
    with pytest.raises(Exception, match="IAM store unseal failed"):
        other._unseal(sealed)


def test_iam_decisions_equal():
    p_iam, j_iam = PIAMSys("root", "root-secret-1"), JIAMSys("root", "root-secret-1")
    for iam in (p_iam, j_iam):
        iam.add_user("reader", "reader-secret", ["readonly"])
        iam.add_user("writer", "writer-secret", ["writeonly"])
        iam.set_policy("logs-only", {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::bkt/logs/*"]}]})
        iam.add_user("logger", "logger-secret", ["logs-only"])
        iam.set_user_status("writer", "disabled")
    for ak in ("root", "reader", "writer", "logger", "nobody"):
        assert (p_iam.lookup(ak) is None) == (j_iam.lookup(ak) is None)
        for action, resource in itertools.product(ACTIONS, RESOURCES):
            assert p_iam.is_allowed(ak, action, resource, {}) == j_iam.is_allowed(ak, action, resource, {}), (
                ak, action, resource)


# -- the package boundary, and the card --------------------------------------------------------


def test_import_minio_tpu_torch_does_not_import_aiohttp():
    code = "import sys, minio_tpu_torch; print('aiohttp' in sys.modules)"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_s3_round_trip(cuda_device, tmp_path):
    """The port's S3Server over a BatchingDeviceCodec on the card: a signed
    PUT of a full block plus a tail and its GET, byte-exact."""
    import http.client

    from minio_tpu_torch import ErasureSets, ServerPools
    from minio_tpu_torch.api.server import S3Server, ThreadedServer
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    formats = fmt.init_format(1, 16)
    drives = []
    for i, f in enumerate(formats):
        d = tmp_path / f"d{i}"
        d.mkdir()
        f.save(str(d))
        drives.append(LocalDrive(str(d)))
    codec = BatchingDeviceCodec(device=cuda_device)
    ts = ThreadedServer(S3Server(ServerPools([ErasureSets.from_drives(drives, formats[0], codec=codec)]),
                                 PIAMSys(AK, SK)))
    host = ts.start().split("//")[1]
    data = np.random.default_rng(1).integers(0, 256, (1 << 20) + 4099, dtype=np.uint8).tobytes()
    try:
        def send(method, path, body=b""):
            h = p_auth.sign_request(p_auth.Credentials(AK, SK), method, path, [], {"host": host}, body)
            h.pop("host")
            c = http.client.HTTPConnection(host, timeout=120)
            c.request(method, path, body=body, headers=h)
            r = c.getresponse()
            return r.status, r.read()

        assert send("PUT", "/bkt")[0] == 200
        assert send("PUT", "/bkt/obj", data)[0] == 200
        assert send("GET", "/bkt/obj") == (200, data)
        assert codec.stats()["batches_run"] > 0
    finally:
        ts.stop()
        codec.close()
