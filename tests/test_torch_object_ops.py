"""The erasure set's other operations on the CPU, port against the JAX package.

Two 16-drive 12+4 stacks take the same numpy-seeded bytes under the same
names: minio_tpu_torch's ErasureObjects on its BatchingDeviceCodec
(device="cpu") and the JAX package's ErasureObjects on its HostCodec. Bucket
listing and deletion, metadata updates, the three delete forms and tier
transitions must leave the same xl.meta fields and raise the same error
classes. The legacy whole-file bitrot layout (sha256, blake2b,
highwayhash256) must write the same part files and checksums, read what the
JAX package wrote, and heal a corrupted row. Version ids and mod times are
random and are not compared.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.object.types import DeleteObjectOptions as JaxDeleteObjectOptions
from minio_tpu.object.types import GetObjectOptions as JaxGetObjectOptions
from minio_tpu.object.types import PutObjectOptions as JaxPutObjectOptions
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.control import tiering
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.object.types import DeleteObjectOptions, GetObjectOptions, PutObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

DRIVES, PARITY = 16, 4
BUCKET = "bkt"
WHOLE_SIZE = (1 << 20) + 4321  # one full block and a short one
WHOLE_ALGOS = ("sha256", "blake2b", "highwayhash256")


def _drives(root, fmt_mod, drive_cls):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(drive_cls(d))
    return drives


class _Pair:
    """The two stacks, driven with the same calls."""

    def __init__(self, root):
        self.codec = BatchingDeviceCodec(device="cpu")
        self.port_drives = _drives(str(root / "port"), port_format, LocalDrive)
        self.jax_drives = _drives(str(root / "jax"), jax_format, JaxLocalDrive)
        self.port = ErasureObjects(self.port_drives, parity=PARITY, codec=self.codec)
        self.ref = JaxErasureObjects(self.jax_drives, parity=PARITY, codec=JaxHostCodec())
        self.rng = np.random.default_rng(2024)

    def both(self):
        return ((self.port, self.port_drives, "port"), (self.ref, self.jax_drives, "jax"))

    def payload(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def put(self, key: str, data: bytes, **opts) -> None:
        self.port.put_object(BUCKET, key, data, PutObjectOptions(**opts))
        self.ref.put_object(BUCKET, key, data, JaxPutObjectOptions(**opts))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = _Pair(tmp_path_factory.mktemp("ops"))
    p.port.make_bucket(BUCKET)
    p.ref.make_bucket(BUCKET)
    yield p
    p.codec.close()


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is what is compared
        return type(e).__name__
    return "no error"


def _obj_dir(drive, key: str) -> str:
    return os.path.join(drive.root, BUCKET, key)


def _part_file(drive, key: str, part: int = 1) -> bytes:
    obj = _obj_dir(drive, key)
    data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
    with open(os.path.join(obj, data_dir, f"part.{part}"), "rb") as f:
        return f.read()


def _meta_fields(fi) -> tuple:
    e = fi.erasure
    return (
        e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
        [dict(c) for c in e.checksums],
        [(p.number, p.size, p.actual_size) for p in fi.parts], fi.size, bool(fi.data_dir),
        fi.deleted, dict(fi.metadata),
    )


def _assert_same_meta(pair, key: str, version_port: str = "", version_jax: str = "") -> None:
    for i in range(DRIVES):
        got = _meta_fields(pair.port_drives[i].read_version(BUCKET, key, version_port))
        want = _meta_fields(pair.jax_drives[i].read_version(BUCKET, key, version_jax))
        assert got == want, f"drive {i}"


# -- buckets -----------------------------------------------------------------------


def test_list_buckets_matches_and_votes_by_half_of_the_responders(pair):
    for eo, drives, _ in pair.both():
        eo.make_bucket("alpha")
        eo.make_bucket("thin")
        eo.make_bucket("half")
        # "thin" survives on 7 of 16 drives, "half" on 8: a bucket counts
        # when at least half the responding drives hold it.
        for i in range(9):
            os.rmdir(os.path.join(drives[i].root, "thin"))
        for i in range(8):
            os.rmdir(os.path.join(drives[i].root, "half"))
    names = [b.name for b in pair.port.list_buckets()]
    assert names == [b.name for b in pair.ref.list_buckets()]
    assert names == ["alpha", BUCKET, "half"]


@pytest.mark.parametrize("case", ["not-empty", "empty", "missing"])
def test_delete_bucket_raises_and_deletes_as_the_jax_package(pair, case):
    name = f"del-{case}"
    for eo, _, _ in pair.both():
        if case != "missing":
            eo.make_bucket(name)
        if case == "not-empty":
            eo.put_object(name, "obj", b"x" * 1000)
    got = _raised(lambda: pair.port.delete_bucket(name))
    assert got == _raised(lambda: pair.ref.delete_bucket(name))
    assert got == {"not-empty": "BucketNotEmpty", "empty": "no error", "missing": "BucketNotFound"}[case]
    if case == "empty":
        assert name not in [b.name for b in pair.port.list_buckets()]
        assert _raised(lambda: pair.port.get_bucket_info(name)) == "BucketNotFound"


def test_invalidate_bucket_cache_drops_a_bucket_deleted_underneath(pair):
    pair.port.make_bucket("cached")
    pair.port.get_bucket_info("cached")
    for d in pair.port_drives:
        os.rmdir(os.path.join(d.root, "cached"))
    assert pair.port.get_bucket_info("cached").name == "cached"  # still cached
    pair.port.invalidate_bucket_cache("cached")
    assert _raised(lambda: pair.port.get_bucket_info("cached")) == "BucketNotFound"


# -- metadata, deletes, transitions --------------------------------------------------


def test_put_object_metadata_keeps_each_drives_own_fileinfo(pair):
    pair.put("meta", pair.payload(200 << 10), user_defined={"x-amz-meta-a": "1", "x-amz-meta-b": "2"})
    for eo, _, _ in pair.both():
        oi = eo.put_object_metadata(BUCKET, "meta", updates={"x-amz-meta-c": "3"}, removes=["x-amz-meta-a"])
        assert oi.user_defined == {"x-amz-meta-b": "2", "x-amz-meta-c": "3"}
    _assert_same_meta(pair, "meta")
    indices = sorted(d.read_version(BUCKET, "meta").erasure.index for d in pair.port_drives)
    assert indices == list(range(1, DRIVES + 1))


def test_delete_marker_hides_the_object(pair):
    data = pair.payload(300 << 10)
    port_vid = pair.port.put_object(BUCKET, "marked", data, PutObjectOptions(versioned=True)).version_id
    jax_vid = pair.ref.put_object(BUCKET, "marked", data, JaxPutObjectOptions(versioned=True)).version_id
    port_oi = pair.port.delete_object(BUCKET, "marked", DeleteObjectOptions(versioned=True))
    ref_oi = pair.ref.delete_object(BUCKET, "marked", JaxDeleteObjectOptions(versioned=True))
    assert port_oi.delete_marker and ref_oi.delete_marker
    got = _raised(lambda: pair.port.get_object(BUCKET, "marked"))
    assert got == _raised(lambda: pair.ref.get_object(BUCKET, "marked")) == "ObjectNotFound"
    _assert_same_meta(pair, "marked")
    _assert_same_meta(pair, "marked", port_vid, jax_vid)
    # The version under the marker still reads by its id.
    assert pair.port.get_object(BUCKET, "marked", GetObjectOptions(version_id=port_vid))[1] == data


@pytest.mark.parametrize("form", ["null-version", "one-version", "missing", "missing-version"])
def test_physical_delete_forms_match(pair, form):
    key = f"phys-{form}"
    data = pair.payload(150 << 10)
    vids = {}
    if form == "null-version":
        pair.put(key, data)
        vids = {"port": "", "jax": ""}
    elif form == "one-version":
        pair.put(key, pair.payload(140 << 10), versioned=True)
        vids = {
            "port": pair.port.put_object(BUCKET, key, data, PutObjectOptions(versioned=True)).version_id,
            "jax": pair.ref.put_object(BUCKET, key, data, JaxPutObjectOptions(versioned=True)).version_id,
        }
    else:
        vids = {"port": "", "jax": ""} if form == "missing" else {"port": "nope", "jax": "nope"}
    port_err = _raised(lambda: pair.port.delete_object(BUCKET, key, DeleteObjectOptions(version_id=vids["port"])))
    ref_err = _raised(lambda: pair.ref.delete_object(BUCKET, key, JaxDeleteObjectOptions(version_id=vids["jax"])))
    assert port_err == ref_err
    assert port_err == {"null-version": "no error", "one-version": "no error",
                        "missing": "ObjectNotFound", "missing-version": "VersionNotFound"}[form]
    if form == "null-version":
        got = _raised(lambda: pair.port.get_object(BUCKET, key))
        assert got == _raised(lambda: pair.ref.get_object(BUCKET, key)) == "ObjectNotFound"
    if form == "one-version":
        # The deleted version is gone; the older one is latest again.
        got = _raised(lambda: pair.port.get_object(BUCKET, key, GetObjectOptions(version_id=vids["port"])))
        assert got == _raised(lambda: pair.ref.get_object(BUCKET, key, JaxGetObjectOptions(version_id=vids["jax"])))
        assert got == "VersionNotFound"
        assert len(pair.port.get_object(BUCKET, key)[1]) == 140 << 10
        _assert_same_meta(pair, key)


def test_transition_frees_parts_and_stamps_markers(pair):
    pair.put("tiered", pair.payload(400 << 10))
    for eo, drives, _ in pair.both():
        eo.transition_object(BUCKET, "tiered", "", "WARM", "remote/obj-1")
        for d in drives:
            assert os.listdir(_obj_dir(d, "tiered")) == ["xl.meta"]
    _assert_same_meta(pair, "tiered")
    meta = pair.port_drives[3].read_version(BUCKET, "tiered").metadata
    assert meta[tiering.META_TRANSITION_STATUS] == tiering.STATUS_COMPLETE
    assert meta[tiering.META_TRANSITION_TIER] == "WARM"
    assert meta[tiering.META_TRANSITION_NAME] == "remote/obj-1"


@pytest.mark.parametrize("case", ["inline", "etag-changed"])
def test_transition_refusals_match(pair, case):
    key = f"no-tier-{case}"
    pair.put(key, pair.payload(60 << 10 if case == "inline" else 300 << 10))
    kw = {"expected_etag": "0" * 32} if case == "etag-changed" else {}
    got = _raised(lambda: pair.port.transition_object(BUCKET, key, "", "WARM", "r", **kw))
    assert got == _raised(lambda: pair.ref.transition_object(BUCKET, key, "", "WARM", "r", **kw))
    assert got == {"inline": "InvalidArgument", "etag-changed": "PreconditionFailed"}[case]


# -- the legacy whole-file bitrot layout ----------------------------------------------


@pytest.fixture(scope="module")
def whole(pair):
    """Per algorithm: the payload of an object the JAX stack wrote in the
    whole-file layout."""
    out = {}
    for algo in WHOLE_ALGOS:
        data = pair.payload(WHOLE_SIZE)
        pair.ref.put_object(BUCKET, f"whole-{algo}", data, JaxPutObjectOptions(bitrot_algorithm=algo))
        out[algo] = data
    return out


@pytest.fixture(scope="module")
def whole_port(pair, whole):
    """The same objects written by the port's stack."""
    for algo, data in whole.items():
        pair.port.put_object(BUCKET, f"whole-{algo}", data, PutObjectOptions(bitrot_algorithm=algo))
    return whole


@pytest.mark.parametrize("algo", WHOLE_ALGOS)
def test_port_reads_a_whole_file_object_the_jax_package_wrote(pair, whole, algo):
    drives = [LocalDrive(d.root) for d in pair.jax_drives]
    codec = BatchingDeviceCodec(device="cpu")
    try:
        view = ErasureObjects(drives, parity=PARITY, codec=codec)
        key = f"whole-{algo}"
        assert view.get_object(BUCKET, key)[1] == whole[algo]
        lo, n = 1000, (1 << 20) + 100
        assert view.get_object(BUCKET, key, offset=lo, length=n)[1] == whole[algo][lo : lo + n]
        # Degraded: the part files of the drives holding data rows 1-4 gone.
        lost = [i for i in range(DRIVES) if drives[i].read_version(BUCKET, key).erasure.index <= 4]
        moved = []
        for i in lost:
            obj = _obj_dir(drives[i], key)
            data_dir = next(x for x in os.listdir(obj) if x != "xl.meta")
            src = os.path.join(obj, data_dir, "part.1")
            os.rename(src, src + ".away")
            moved.append(src)
        try:
            assert view.get_object(BUCKET, key)[1] == whole[algo]
        finally:
            for src in moved:
                os.rename(src + ".away", src)
    finally:
        codec.close()


@pytest.mark.parametrize("algo", WHOLE_ALGOS)
def test_whole_file_part_files_and_checksums_equal_the_jax_packages(pair, whole_port, algo):
    whole = whole_port
    key = f"whole-{algo}"
    for i in range(DRIVES):
        assert _part_file(pair.port_drives[i], key) == _part_file(pair.jax_drives[i], key), f"drive {i}"
    _assert_same_meta(pair, key)
    sums = pair.port_drives[0].read_version(BUCKET, key).erasure.checksums
    assert [(c["part"], c["algo"]) for c in sums] == [(1, algo)]
    assert pair.port.get_object(BUCKET, key)[1] == whole[algo]
    # A whole-file object's etag is the content md5, as in the JAX package.
    assert pair.port.get_object_info(BUCKET, key).etag == pair.ref.get_object_info(BUCKET, key).etag


@pytest.mark.parametrize("algo", WHOLE_ALGOS)
def test_corrupted_whole_row_heals(pair, whole_port, algo):
    whole = whole_port
    key = f"whole-{algo}"
    before = [_part_file(d, key) for d in pair.port_drives]
    results = {}
    for eo, drives, name in pair.both():
        obj = _obj_dir(drives[6], key)
        data_dir = next(x for x in os.listdir(obj) if x != "xl.meta")
        path = os.path.join(obj, data_dir, "part.1")
        with open(path, "r+b") as f:
            f.seek(777)
            b = f.read(1)
            f.seek(777)
            f.write(bytes([b[0] ^ 0x5A]))
        results[name] = eo.heal_object(BUCKET, key)
    p, r = results["port"], results["jax"]
    assert (p.disks_healed, p.before_drive_state, p.after_drive_state, p.data_blocks, p.parity_blocks) == (
        r.disks_healed, r.before_drive_state, r.after_drive_state, r.data_blocks, r.parity_blocks
    )
    assert p.disks_healed == 1 and p.after_drive_state[6] == "healed"
    assert [_part_file(d, key) for d in pair.port_drives] == before
    _assert_same_meta(pair, key)
    assert pair.port.get_object(BUCKET, key)[1] == whole[algo]


def test_unknown_bitrot_algorithm_is_refused_as_the_jax_package_does(pair):
    got = _raised(lambda: pair.port.put_object(BUCKET, "x", b"1" * 10, PutObjectOptions(bitrot_algorithm="md4")))
    assert got == _raised(
        lambda: pair.ref.put_object(BUCKET, "x", b"1" * 10, JaxPutObjectOptions(bitrot_algorithm="md4"))
    )
    assert got == "InvalidArgument"


def test_small_whole_file_object_is_not_inlined(pair):
    data = pair.payload(5000)
    pair.put("whole-small", data, bitrot_algorithm="sha256")
    for i in range(DRIVES):
        assert _part_file(pair.port_drives[i], "whole-small") == _part_file(pair.jax_drives[i], "whole-small")
    assert pair.port.get_object(BUCKET, "whole-small")[1] == data
    shutil.rmtree(_obj_dir(pair.port_drives[2], "whole-small"))
    assert pair.port.get_object(BUCKET, "whole-small")[1] == data
