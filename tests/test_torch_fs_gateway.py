"""The FS backend and the NAS and S3 gateways of minio_tpu_torch on the CPU
(object/fs.py, object/gateway.py), held against the JAX package's.

The cases of tests/test_fs_gateway.py run on the port: the file is executed
with its `minio_tpu.` imports pointed at `minio_tpu_torch.` and the erasure
harness of tests/harness.py built from the port's modules; every other line
is the JAX file's. The backing erasure stack it builds without codec=
serves this file's default codec, the batching codec on the CPU (the
kernels' plain versions). Then the two packages meet:

- the same calls on two FS roots, with the clock and the uuids of both
  modules fixed, leave the same files byte for byte: format-fs.json, the
  objects, the fs-meta documents and the fs-multipart staging;
- a root written by either package is served by the other: objects and
  their metadata, listings, and a multipart upload staged by one and
  completed by the other;
- the port's S3 gateway in front of a JAX erasure server, and the JAX
  gateway in front of a port server, both behind an S3 front: objects
  round-trip through either and land in the backing server.

One difference is held on purpose: the S3 front streams every part PUT to
the layer, and the port's FS layer and S3 gateway take that stream, so a
multipart upload through the front completes; the JAX package's take bytes
only and answer each part 500 (recorded as a test property).

Tolerance: exact.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import uuid as uuid_mod
from types import SimpleNamespace

import numpy as np
import pytest

from minio_tpu.api.server import S3Server as JaxS3Server
from minio_tpu.api.server import ThreadedServer as JaxThreadedServer
from minio_tpu.control.iam import IAMSys as JaxIAMSys
from minio_tpu.object import fs as jax_fs
from minio_tpu.object import gateway as jax_gateway
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import PutObjectOptions as JaxPutObjectOptions
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.api.server import S3Server, ThreadedServer
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object import fs as port_fs
from minio_tpu_torch.object import gateway as port_gateway
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import PutObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from tests.s3client import S3TestClient
from tests.test_torch_loadgen import rerun_on_port

_HARNESS = rerun_on_port("harness", [("from minio_tpu.", "from minio_tpu_torch.", 4)], {})
_PORT_CASES = rerun_on_port(
    "test_fs_gateway",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 8),
        ("from tests.harness import ErasureHarness\n", "", 1),
    ],
    globals(),
    preset={"ErasureHarness": _HARNESS.ErasureHarness},
)

PKGS = {
    "jax": SimpleNamespace(fs=jax_fs, gateway=jax_gateway, Opts=JaxPutObjectOptions),
    "port": SimpleNamespace(fs=port_fs, gateway=port_gateway, Opts=PutObjectOptions),
}
BODIES = {name: np.random.default_rng(seed).bytes(size)
          for name, seed, size in (("a.bin", 1, 10_000), ("dir/b.bin", 2, 70_000), ("dir/sub/c.txt", 3, 123))}
PARTS = [np.random.default_rng(10 + n).bytes(size) for n, size in enumerate((40_000, 40_000, 777))]


@pytest.fixture(scope="module", autouse=True)
def cpu_default_codec():
    """The process default codec of the backing stack test_fs_gateway.py
    builds without codec=: the batching codec on the CPU."""
    codec = BatchingDeviceCodec(device="cpu")
    codec_mod.set_default_codec(codec)
    try:
        yield codec
    finally:
        Node.close_all()
        with codec_mod._default_lock:
            if codec_mod._default is codec:
                codec_mod._default = None
        codec.close()


def test_the_jax_cases_run_on_the_port():
    """All 10 functions of tests/test_fs_gateway.py were collected here,
    against the port's modules."""
    cases = [k for k, v in vars(_PORT_CASES).items() if k.startswith("test_") and callable(v)]
    assert len(cases) == 10
    assert _PORT_CASES.FSObjectLayer is port_fs.FSObjectLayer
    assert _PORT_CASES.S3Gateway is port_gateway.S3Gateway
    assert issubclass(port_gateway.NASGateway, port_fs.FSObjectLayer)
    assert (port_fs.SYS_PREFIX, port_fs.META_DIR, port_fs.MULTIPART_DIR, port_fs.FORMAT_FILE) == (
        jax_fs.SYS_PREFIX, jax_fs.META_DIR, jax_fs.MULTIPART_DIR, jax_fs.FORMAT_FILE)


# -- the same calls, the same files --------------------------------------------------------------


def _fixed(monkeypatch, mod) -> None:
    """The module's clock and uuids from fixed sequences."""
    ticks = itertools.count(1_700_000_000)
    ids = itertools.count(1)
    monkeypatch.setattr(mod, "time", SimpleNamespace(time=lambda: float(next(ticks)) + 0.25))
    monkeypatch.setattr(mod, "uuid", SimpleNamespace(uuid4=lambda: uuid_mod.UUID(int=next(ids))))


def _script(pkg: SimpleNamespace, root: str, pending: bool = False) -> dict:
    """Buckets, objects with metadata, an overwrite, a delete, a completed
    multipart upload and one left staged (with `pending`, its parts only)."""
    layer = pkg.fs.FSObjectLayer(root)
    layer.make_bucket("docs")
    layer.make_bucket("empty")
    for name, body in BODIES.items():
        layer.put_object("docs", name, body, pkg.Opts(user_defined={"x-amz-meta-name": name},
                                                      content_type="application/x-test"))
    layer.put_object("docs", "a.bin", BODIES["a.bin"][::-1])
    layer.put_object("docs", "gone.bin", b"x")
    layer.delete_object("docs", "gone.bin")
    uid = layer.new_multipart_upload("docs", "mp.bin", pkg.Opts(user_defined={"x-amz-meta-mp": "1"}))
    etags = [layer.put_object_part("docs", "mp.bin", uid, n, part).etag for n, part in enumerate(PARTS, 1)]
    if not pending:
        layer.complete_multipart_upload("docs", "mp.bin", uid, list(enumerate(etags, 1)))
    staged = layer.new_multipart_upload("docs", "staged.bin")
    layer.put_object_part("docs", "staged.bin", staged, 1, PARTS[2])
    return {"upload": uid, "etags": etags, "staged": staged}


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    for d, dirs, _ in os.walk(root):
        for sub in dirs:
            out.setdefault(os.path.relpath(os.path.join(d, sub), root) + "/", None)
    return out


def test_the_same_calls_leave_the_same_files(tmp_path, monkeypatch):
    trees = {}
    for name, pkg in PKGS.items():
        _fixed(monkeypatch, pkg.fs)
        _script(pkg, str(tmp_path / name))
        trees[name] = _tree(str(tmp_path / name))
    assert sorted(trees["port"]) == sorted(trees["jax"])
    for rel in trees["jax"]:
        assert trees["port"][rel] == trees["jax"][rel], rel
    assert os.path.join(".minio_tpu.sys", "format-fs.json") in trees["port"]
    assert any(rel.startswith(os.path.join(".minio_tpu.sys", "fs-multipart")) for rel in trees["port"])
    assert os.path.join(".minio_tpu.sys", "fs-meta", "docs", "mp.bin.json") in trees["port"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_root_written_by_one_is_served_by_the_other(tmp_path, writer, reader):
    root = str(tmp_path / "fsroot")
    ids = _script(PKGS[writer], root, pending=True)
    w = PKGS[writer].fs.FSObjectLayer(root)
    r = PKGS[reader].fs.FSObjectLayer(root)
    fmt = os.path.join(root, ".minio_tpu.sys", "format-fs.json")
    before = open(fmt, "rb").read()
    # The staged upload, completed by the reader from the writer's parts.
    assert [p.etag for p in r.list_parts("docs", "mp.bin", ids["upload"])] == ids["etags"]
    oi = r.complete_multipart_upload("docs", "mp.bin", ids["upload"], list(enumerate(ids["etags"], 1)))
    assert oi.etag.endswith("-3") and oi.size == sum(map(len, PARTS))
    assert open(fmt, "rb").read() == before
    assert [b.name for b in r.list_buckets()] == [b.name for b in w.list_buckets()] == ["docs", "empty"]
    for layer in (r, w):
        assert [o.name for o in layer.list_objects("docs").objects] == [
            "a.bin", "dir/b.bin", "dir/sub/c.txt", "mp.bin"]
        listing = layer.list_objects("docs", delimiter="/")
        assert [o.name for o in listing.objects] == ["a.bin", "mp.bin"] and listing.prefixes == ["dir/"]
        assert layer.get_object("docs", "a.bin")[1] == BODIES["a.bin"][::-1]
        assert layer.get_object("docs", "dir/b.bin", offset=100, length=50)[1] == BODIES["dir/b.bin"][100:150]
        assert layer.get_object("docs", "mp.bin")[1] == b"".join(PARTS)
        info = layer.get_object_info("docs", "dir/sub/c.txt")
        assert (info.size, info.etag, info.content_type, info.user_defined.get("x-amz-meta-name")) == (
            123, hashlib.md5(BODIES["dir/sub/c.txt"]).hexdigest(), "application/x-test", "dir/sub/c.txt")
        assert layer.get_object_info("docs", "mp.bin").user_defined.get("x-amz-meta-mp") == "1"
        assert [u["upload_id"] for u in layer.list_multipart_uploads("docs")] == [ids["staged"]]
    w.abort_multipart_upload("docs", "staged.bin", ids["staged"])
    assert r.list_multipart_uploads("docs") == []


# -- each package's S3 gateway in front of the other package's erasure server ----------------------

BACK = ("backroot", "back-root-secret")
FRONT = ("gwroot", "gw-root-secret")


def _erasure_server(root: str, pkg: str, codec):
    formats = port_format.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    if pkg == "jax":
        sets = JaxErasureSets.from_drives([JaxLocalDrive(d) for d in dirs], jax_format.DriveFormat.load(dirs[0]),
                                          codec=codec, pool_index=0)
        return JaxThreadedServer(JaxS3Server(JaxServerPools([sets]), JaxIAMSys(*BACK), check_skew=False))
    sets = ErasureSets.from_drives([LocalDrive(d) for d in dirs], port_format.DriveFormat.load(dirs[0]),
                                   codec=codec, pool_index=0)
    return ThreadedServer(S3Server(ServerPools([sets]), IAMSys(*BACK), check_skew=False))


@pytest.mark.parametrize("gateway_pkg,backing_pkg", [("port", "jax"), ("jax", "port")])
def test_gateway_in_front_of_the_other_package(tmp_path, cpu_default_codec, gateway_pkg, backing_pkg):
    codec = JaxHostCodec() if backing_pkg == "jax" else cpu_default_codec
    back = _erasure_server(str(tmp_path / "back"), backing_pkg, codec)
    endpoint = back.start()
    front = None
    try:
        gw = PKGS[gateway_pkg].gateway.S3Gateway(endpoint, *BACK)
        server_cls, threaded_cls, iam_cls = (
            (S3Server, ThreadedServer, IAMSys) if gateway_pkg == "port" else (JaxS3Server, JaxThreadedServer, JaxIAMSys))
        front = threaded_cls(server_cls(gw, iam_cls(*FRONT), check_skew=False))
        c = S3TestClient(front.start(), *FRONT)
        direct = S3TestClient(endpoint, *BACK)
        assert c.make_bucket("gwb").status_code == 200
        for name, body in BODIES.items():
            assert c.put_object("gwb", name, body).status_code == 200, name
        for name, body in BODIES.items():
            assert c.get_object("gwb", name).content == body
            assert direct.get_object("gwb", name).content == body
        r = c.request("GET", "/gwb", query=[("list-type", "2")])
        assert r.status_code == 200
        assert sorted(BODIES) == sorted(
            k.split("</Key>")[0] for k in r.text.split("<Key>")[1:])
        # A Select through the gateway reads the backing object.
        csv = b"a,b\n" + b"".join(b"%d,%d\n" % (i, i * i) for i in range(300))
        assert c.put_object("gwb", "t.csv", csv).status_code == 200
        sel = c.request(
            "POST", "/gwb/t.csv", query=[("select", ""), ("select-type", "2")],
            body=b"<SelectObjectContentRequest><Expression>SELECT sum(cast(b as int)) FROM S3Object</Expression>"
                 b"<ExpressionType>SQL</ExpressionType><InputSerialization><CSV><FileHeaderInfo>USE"
                 b"</FileHeaderInfo></CSV></InputSerialization><OutputSerialization><CSV/>"
                 b"</OutputSerialization></SelectObjectContentRequest>")
        assert sel.status_code == 200 and b"%d\n" % sum(i * i for i in range(300)) in sel.content
        assert c.request("DELETE", "/gwb/a.bin").status_code == 204
        assert direct.request("HEAD", "/gwb/a.bin").status_code == 404
    finally:
        if front is not None:
            front.stop()
        back.stop()


# -- a multipart upload through the S3 front ------------------------------------------------------

MP_PARTS = [np.random.default_rng(40 + n).bytes(size) for n, size in enumerate((5 * 1024 * 1024, 1234))]


def _multipart_through(client: S3TestClient) -> tuple[list[int], bytes | None]:
    """Initiate, two parts, complete, GET: the statuses and the body read."""
    import xml.etree.ElementTree as ET

    statuses = [client.make_bucket("mpb").status_code]
    r = client.request("POST", "/mpb/big.bin", query=[("uploads", "")])
    statuses.append(r.status_code)
    uid = ET.fromstring(r.content).findtext("{*}UploadId")
    etags = []
    for n, part in enumerate(MP_PARTS, 1):
        r = client.request("PUT", "/mpb/big.bin", query=[("partNumber", str(n)), ("uploadId", uid)], body=part)
        statuses.append(r.status_code)
        etags.append(r.headers.get("ETag", ""))
    xml = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>" for n, e in enumerate(etags, 1))
    r = client.request("POST", "/mpb/big.bin", query=[("uploadId", uid)],
                       body=f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>".encode())
    statuses.append(r.status_code)
    got = client.get_object("mpb", "big.bin")
    statuses.append(got.status_code)
    return statuses, got.content if got.status_code == 200 else None


@pytest.mark.parametrize("kind", ["fs", "s3-gateway"])
def test_multipart_upload_through_the_front(tmp_path, kind, record_property):
    """The S3 front streams every part PUT to the layer: the port's FS layer
    and S3 gateway take the stream (the gateway in front of a JAX erasure
    server here). The JAX package's take bytes only and answer its parts
    500; their statuses are recorded as a test property."""
    back = None
    if kind == "s3-gateway":
        back = _erasure_server(str(tmp_path / "back"), "jax", JaxHostCodec())
        endpoint = back.start()
    answers = {}
    try:
        for pkg, (server_cls, threaded_cls, iam_cls) in (
            ("jax", (JaxS3Server, JaxThreadedServer, JaxIAMSys)), ("port", (S3Server, ThreadedServer, IAMSys)),
        ):
            if kind == "fs":
                layer = PKGS[pkg].fs.FSObjectLayer(str(tmp_path / pkg))
            else:
                layer = PKGS[pkg].gateway.S3Gateway(endpoint, *BACK)
                if pkg == "port":
                    S3TestClient(endpoint, *BACK).delete_bucket("mpb")
            ts = threaded_cls(server_cls(layer, iam_cls(*FRONT), check_skew=False))
            try:
                answers[pkg] = _multipart_through(S3TestClient(ts.start(), *FRONT))
            finally:
                ts.stop()
    finally:
        if back is not None:
            back.stop()
    record_property("jax_statuses", answers["jax"][0])
    assert answers["port"] == ([200, 200, 200, 200, 200, 200], b"".join(MP_PARTS))
