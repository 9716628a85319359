"""The slice as a whole on the CPU: PutObject and GetObject of one 16-drive
12+4 erasure set through minio_tpu_torch (its BatchingDeviceCodec on
device="cpu"), held byte for byte against a second stack of the JAX
package's ErasureObjects with its HostCodec.

Both stacks take the same bytes under the same bucket and key: the staged
part file (or the inline blob) on every drive index must be identical, and
so must the erasure fields of xl.meta (version ids and mod times are
random and not compared). Every GET returns the object, also after the part
files of 4 drives are gone.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

DRIVES, PARITY = 16, 4
BUCKET = "bkt"
OBJECTS = {
    "three-mib": (3 << 20) + 37,  # 3 full blocks + a 37-byte tail block
    "two-hundred-kib": 200 << 10,  # one short block, streaming layout
    "fifty-kib": 50 << 10,  # under the 128 KiB inline threshold
}
LOST_DRIVES = (0, 5, 10, 15)


def _drives(root, fmt_mod, drive_cls):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(drive_cls(d))
    return drives


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    codec = BatchingDeviceCodec(device="cpu")
    port_drives = _drives(str(root / "port"), port_format, LocalDrive)
    jax_drives = _drives(str(root / "jax"), jax_format, JaxLocalDrive)
    port = ErasureObjects(port_drives, parity=PARITY, codec=codec)
    ref = JaxErasureObjects(jax_drives, parity=PARITY, codec=JaxHostCodec())
    port.make_bucket(BUCKET)
    ref.make_bucket(BUCKET)
    rng = np.random.default_rng(99)
    payloads = {key: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for key, n in OBJECTS.items()}
    for key, data in payloads.items():
        port.put_object(BUCKET, key, data)
        ref.put_object(BUCKET, key, data)
    yield port, ref, port_drives, jax_drives, payloads, codec
    codec.close()


def _part_file(drive, key: str) -> bytes:
    obj = os.path.join(drive.root, BUCKET, key)
    data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
    with open(os.path.join(obj, data_dir, "part.1"), "rb") as f:
        return f.read()


def _erasure_fields(fi) -> tuple:
    e = fi.erasure
    return (
        e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
        [(p.number, p.size, p.actual_size) for p in fi.parts], fi.size, bool(fi.data_dir),
    )


@pytest.mark.parametrize("key", ["three-mib", "two-hundred-kib"])
def test_part_files_identical_on_every_drive(stacks, key):
    _, _, port_drives, jax_drives, _, _ = stacks
    for i in range(DRIVES):
        assert _part_file(port_drives[i], key) == _part_file(jax_drives[i], key), f"drive {i}"


def test_inline_blobs_identical_on_every_drive(stacks):
    _, _, port_drives, jax_drives, _, _ = stacks
    for i in range(DRIVES):
        got = port_drives[i].read_version(BUCKET, "fifty-kib").inline_data
        want = jax_drives[i].read_version(BUCKET, "fifty-kib").inline_data
        assert got and got == want, f"drive {i}"


@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_xl_meta_erasure_fields_match(stacks, key):
    _, _, port_drives, jax_drives, _, _ = stacks
    for i in range(DRIVES):
        got = _erasure_fields(port_drives[i].read_version(BUCKET, key))
        assert got == _erasure_fields(jax_drives[i].read_version(BUCKET, key)), f"drive {i}"
        assert got[0:3] == (DRIVES - PARITY, PARITY, 1 << 20)


def test_device_path_carried_the_put(stacks):
    *_, codec = stacks
    st = codec.stats()
    assert st["batches_run"] >= 1 and st["blocks_encoded"] == 3
    # The 200 KiB and 50 KiB blocks and the 37-byte tail block.
    assert st["small_blocks_encoded"] == 3
    assert st["host_fallback_blocks"] == 0


def test_get_then_degraded_get(stacks):
    port, _, port_drives, _, payloads, codec = stacks
    for key, data in payloads.items():
        assert port.get_object(BUCKET, key)[1] == data, key
        assert port.get_object_info(BUCKET, key).size == len(data)
    for key in ("three-mib", "two-hundred-kib"):
        for i in LOST_DRIVES:
            obj = os.path.join(port_drives[i].root, BUCKET, key)
            data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
            os.remove(os.path.join(obj, data_dir, "part.1"))
    before = codec.stats()
    for key, data in payloads.items():
        assert port.get_object(BUCKET, key)[1] == data, key
    after = codec.stats()
    # A window whose blocks differ in chunk size (3 full blocks + the tail)
    # or that holds one block is rebuilt on the device path too, in groups
    # of one chunk length; only objects that lost data rows rebuild at all.
    expected = 0
    for key, nblocks in (("three-mib", 4), ("two-hundred-kib", 1)):
        dist = port_drives[1].read_version(BUCKET, key).erasure.distribution
        if any(dist[i] - 1 < DRIVES - PARITY for i in LOST_DRIVES):
            expected += nblocks
    assert expected > 0
    assert after["blocks_reconstructed"] - before["blocks_reconstructed"] == expected
    assert after["host_fallback_recon_blocks"] == before["host_fallback_recon_blocks"]


def test_port_reads_objects_the_jax_package_wrote(stacks):
    _, _, _, jax_drives, payloads, _ = stacks
    drives = [LocalDrive(d.root) for d in jax_drives]
    codec = BatchingDeviceCodec(device="cpu")
    try:
        port_view = ErasureObjects(drives, parity=PARITY, codec=codec)
        for key in ("two-hundred-kib", "fifty-kib"):
            assert port_view.get_object(BUCKET, key)[1] == payloads[key]
    finally:
        codec.close()
