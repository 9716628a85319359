"""Multipart uploads on the CPU, port against the JAX package.

Two 16-drive 12+4 stacks run the same upload: minio_tpu_torch's
MultipartManager over ErasureObjects on its BatchingDeviceCodec
(device="cpu"), so each part encodes through the kernels' plain versions,
and the JAX package's over its HostCodec. Parts of 5 MiB and 1,000 B. The
part infos, part listings, the completed ETag, the final part.N files on
every drive and the xl.meta parts and erasure fields must be equal; the
refusals (a wrong part ETag, a too-small middle part, a bad part number, an
aborted upload) must raise the same error classes. Upload ids, version ids
and mod times are random and are not compared.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.object import multipart
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

DRIVES, PARITY = 16, 4
BUCKET = "bkt"
KEY = "videos/clip.bin"
PART_SIZES = (5 << 20, 1000)


def _drives(root, fmt_mod, drive_cls):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(drive_cls(d))
    return drives


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is what is compared
        return type(e).__name__
    return "no error"


@pytest.fixture(scope="module")
def upload(tmp_path_factory):
    """Both stacks with one upload of two parts in flight (not completed)."""
    root = tmp_path_factory.mktemp("mp")
    codec = BatchingDeviceCodec(device="cpu")
    port_drives = _drives(str(root / "port"), port_format, LocalDrive)
    jax_drives = _drives(str(root / "jax"), jax_format, JaxLocalDrive)
    port = ErasureObjects(port_drives, parity=PARITY, codec=codec)
    ref = JaxErasureObjects(jax_drives, parity=PARITY, codec=JaxHostCodec())
    port.make_bucket(BUCKET)
    ref.make_bucket(BUCKET)
    rng = np.random.default_rng(55)
    parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in PART_SIZES]
    ids = {
        "port": port.multipart.new_multipart_upload(BUCKET, KEY),
        "jax": ref.multipart.new_multipart_upload(BUCKET, KEY),
    }
    infos = {"port": [], "jax": []}
    for num, data in enumerate(parts, start=1):
        infos["port"].append(port.multipart.put_object_part(BUCKET, KEY, ids["port"], num, data))
        infos["jax"].append(ref.multipart.put_object_part(BUCKET, KEY, ids["jax"], num, data))
    yield {
        "port": port, "ref": ref, "port_drives": port_drives, "jax_drives": jax_drives,
        "parts": parts, "ids": ids, "infos": infos, "codec": codec,
    }
    codec.close()


def _fields(p) -> tuple:
    return (p.number, p.size, p.actual_size, p.etag)


def test_part_infos_equal(upload):
    assert [_fields(p) for p in upload["infos"]["port"]] == [_fields(p) for p in upload["infos"]["jax"]]
    assert [p.size for p in upload["infos"]["port"]] == list(PART_SIZES)


def test_parts_encoded_on_the_device_path(upload):
    st = upload["codec"].stats()
    assert st["blocks_encoded"] == 5  # the five full blocks of the 5 MiB part
    assert st["small_blocks_encoded"] == 1  # the 1,000-byte part, on the device path
    assert st["host_fallback_blocks"] == 0


def test_list_parts_equal(upload):
    got = upload["port"].multipart.list_parts(BUCKET, KEY, upload["ids"]["port"])
    want = upload["ref"].multipart.list_parts(BUCKET, KEY, upload["ids"]["jax"])
    assert [_fields(p) for p in got] == [_fields(p) for p in want]
    got = upload["port"].multipart.list_parts(BUCKET, KEY, upload["ids"]["port"], part_marker=1)
    assert [p.number for p in got] == [2]


def test_list_multipart_uploads_equal(upload):
    got = upload["port"].multipart.list_multipart_uploads(BUCKET)
    want = upload["ref"].multipart.list_multipart_uploads(BUCKET)
    assert [u["object"] for u in got] == [u["object"] for u in want] == [KEY]
    assert got[0]["upload_id"] == upload["ids"]["port"]
    assert upload["port"].multipart.list_multipart_uploads(BUCKET, prefix="audio/") == []


@pytest.mark.parametrize("case", ["wrong-etag", "unknown-part", "part-order", "no-parts", "bad-part-number"])
def test_refusals_raise_the_same_error_class(upload, case):
    port_mp, ref_mp = upload["port"].multipart, upload["ref"].multipart
    ids = upload["ids"]
    etags = [p.etag for p in upload["infos"]["port"]]

    def call(mp, uid):
        if case == "wrong-etag":
            return mp.complete_multipart_upload(BUCKET, KEY, uid, [(1, etags[0]), (2, "0" * 32)])
        if case == "unknown-part":
            return mp.complete_multipart_upload(BUCKET, KEY, uid, [(1, etags[0]), (3, etags[1])])
        if case == "part-order":
            return mp.complete_multipart_upload(BUCKET, KEY, uid, [(2, etags[1]), (1, etags[0])])
        if case == "no-parts":
            return mp.complete_multipart_upload(BUCKET, KEY, uid, [])
        return mp.put_object_part(BUCKET, KEY, uid, multipart.MAX_PARTS + 1, b"x")

    got = _raised(lambda: call(port_mp, ids["port"]))
    assert got == _raised(lambda: call(ref_mp, ids["jax"]))
    assert got == {"wrong-etag": "InvalidPart", "unknown-part": "InvalidPart", "part-order": "InvalidArgument",
                   "no-parts": "InvalidArgument", "bad-part-number": "InvalidArgument"}[case]


def test_too_small_middle_part_is_refused_as_the_jax_package_does(upload):
    raised = []
    for eo in (upload["port"], upload["ref"]):
        uid = eo.multipart.new_multipart_upload(BUCKET, "small-parts")
        p1 = eo.multipart.put_object_part(BUCKET, "small-parts", uid, 1, b"a" * 1000)
        p2 = eo.multipart.put_object_part(BUCKET, "small-parts", uid, 2, b"b" * 1000)
        raised.append(_raised(lambda: eo.multipart.complete_multipart_upload(
            BUCKET, "small-parts", uid, [(1, p1.etag), (2, p2.etag)])))
        eo.multipart.abort_multipart_upload(BUCKET, "small-parts", uid)
    assert raised == ["InvalidArgument", "InvalidArgument"]


def test_abort_removes_the_upload(upload):
    raised = []
    for eo in (upload["port"], upload["ref"]):
        uid = eo.multipart.new_multipart_upload(BUCKET, "aborted")
        eo.multipart.put_object_part(BUCKET, "aborted", uid, 1, b"z" * 3000)
        assert "aborted" in [u["object"] for u in eo.multipart.list_multipart_uploads(BUCKET)]
        eo.multipart.abort_multipart_upload(BUCKET, "aborted", uid)
        assert "aborted" not in [u["object"] for u in eo.multipart.list_multipart_uploads(BUCKET)]
        raised.append(_raised(lambda: eo.multipart.put_object_part(BUCKET, "aborted", uid, 2, b"y")))
        raised.append(_raised(lambda: eo.multipart.abort_multipart_upload(BUCKET, "aborted", uid)))
    assert raised == ["InvalidUploadID"] * 4


@pytest.fixture(scope="module")
def completed(upload):
    parts = [(p.number, p.etag) for p in upload["infos"]["port"]]
    port_oi = upload["port"].multipart.complete_multipart_upload(BUCKET, KEY, upload["ids"]["port"], parts)
    ref_oi = upload["ref"].multipart.complete_multipart_upload(BUCKET, KEY, upload["ids"]["jax"], parts)
    return port_oi, ref_oi


def test_complete_etag_and_size_equal(upload, completed):
    port_oi, ref_oi = completed
    assert port_oi.etag == ref_oi.etag and port_oi.etag.endswith("-2")
    assert port_oi.size == ref_oi.size == sum(PART_SIZES)
    assert upload["port"].multipart.list_multipart_uploads(BUCKET) == []


def _obj_files(drive) -> dict[str, bytes]:
    obj = os.path.join(drive.root, BUCKET, KEY)
    data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
    out = {}
    for name in sorted(os.listdir(os.path.join(obj, data_dir))):
        with open(os.path.join(obj, data_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def test_final_part_files_equal_on_every_drive(upload, completed):
    for i in range(DRIVES):
        got = _obj_files(upload["port_drives"][i])
        assert list(got) == ["part.1", "part.2"]
        assert got == _obj_files(upload["jax_drives"][i]), f"drive {i}"


def test_xl_meta_parts_and_erasure_fields_equal(upload, completed):
    for i in range(DRIVES):
        got = upload["port_drives"][i].read_version(BUCKET, KEY)
        want = upload["jax_drives"][i].read_version(BUCKET, KEY)
        assert [_fields(p) for p in got.parts] == [_fields(p) for p in want.parts]
        e, f = got.erasure, want.erasure
        assert (e.data_blocks, e.parity_blocks, e.block_size, e.index, e.distribution) == (
            f.data_blocks, f.parity_blocks, f.block_size, f.index, f.distribution
        )
        assert got.metadata == want.metadata and got.size == want.size


def test_get_of_the_completed_object(upload, completed):
    data = b"".join(upload["parts"])
    assert upload["port"].get_object(BUCKET, KEY)[1] == data
    lo = (5 << 20) - 300
    assert upload["port"].get_object(BUCKET, KEY, offset=lo, length=800)[1] == data[lo : lo + 800]
