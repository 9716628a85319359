"""heal_object on the CPU, port against the JAX package.

Two 16-drive 12+4 stacks take the same numpy-seeded objects: minio_tpu_torch's
ErasureObjects on its BatchingDeviceCodec (device="cpu") and the JAX
package's ErasureObjects on its HostCodec. Each case damages the same drives
of both stacks and heals both. The HealResultItem fields, the healed part
files, inline blobs and xl.meta fields must equal the JAX package's byte for
byte, and the part files must equal the ones written before the damage.

The objects: exactly 2 MiB (every rebuild window is two full blocks, so the
port's rebuild runs the device branch, reconstruct_batch(...,
with_digests=True), through the kernels' plain versions); 3 MiB + 37 B (its
window holds a short tail block, so the rebuild takes the host branch); a
50 KiB inline object; a delete marker; a transitioned version.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.object.types import DeleteObjectOptions as JaxDeleteObjectOptions
from minio_tpu.object.types import PutObjectOptions as JaxPutObjectOptions
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

DRIVES, PARITY = 16, 4
BUCKET = "bkt"
SIZES = {"two-mib": 2 << 20, "three-mib": (3 << 20) + 37, "fifty-kib": 50 << 10, "tiered": 300 << 10}
PART_OBJECTS = ("two-mib", "three-mib")


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
    root = tmp_path_factory.mktemp("heal")
    codec = BatchingDeviceCodec(device="cpu")
    port_drives = _drives(str(root / "port"), port_format, LocalDrive)
    jax_drives = _drives(str(root / "jax"), jax_format, JaxLocalDrive)
    port = ErasureObjects(port_drives, parity=PARITY, codec=codec)
    ref = JaxErasureObjects(jax_drives, parity=PARITY, codec=JaxHostCodec())
    port.make_bucket(BUCKET)
    ref.make_bucket(BUCKET)
    rng = np.random.default_rng(7)
    payloads = {key: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for key, n in SIZES.items()}
    for key, data in payloads.items():
        port.put_object(BUCKET, key, data)
        ref.put_object(BUCKET, key, data)
    port.transition_object(BUCKET, "tiered", "", "WARM", "remote/tiered")
    ref.transition_object(BUCKET, "tiered", "", "WARM", "remote/tiered")
    marker = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    port.put_object(BUCKET, "marked", marker, PutObjectOptions(versioned=True))
    ref.put_object(BUCKET, "marked", marker, JaxPutObjectOptions(versioned=True))
    port.delete_object(BUCKET, "marked", DeleteObjectOptions(versioned=True))
    ref.delete_object(BUCKET, "marked", JaxDeleteObjectOptions(versioned=True))
    pristine = {key: [_part_file(d, key) for d in port_drives] for key in PART_OBJECTS}
    for key in PART_OBJECTS:
        assert pristine[key] == [_part_file(d, key) for d in jax_drives]
    yield port, ref, port_drives, jax_drives, payloads, pristine, codec
    codec.close()


def _part_path(drive, key: str) -> str:
    obj = os.path.join(drive.root, BUCKET, key)
    data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
    return os.path.join(obj, data_dir, "part.1")


def _part_file(drive, key: str) -> bytes:
    with open(_part_path(drive, key), "rb") as f:
        return f.read()


def _meta_fields(fi) -> tuple:
    e = fi.erasure
    return (
        e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
        [dict(c) for c in e.checksums],
        [(p.number, p.size, p.actual_size) for p in fi.parts], fi.size, bool(fi.data_dir),
        fi.deleted, dict(fi.metadata), bytes(fi.inline_data or b""),
    )


def _result_fields(r) -> tuple:
    return (
        r.bucket, r.object, r.disks_healed, r.data_blocks, r.parity_blocks,
        list(r.before_drive_state), list(r.after_drive_state),
    )


def _flip_byte(path: str, pos: int) -> None:
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xA5]))


def _heal_both(stacks, key: str, damage, dry_run: bool = False):
    """Apply damage(drives) to both stacks, heal both, return the two
    HealResultItems."""
    port, ref, port_drives, jax_drives, *_ = stacks
    damage(port_drives)
    damage(jax_drives)
    return port.heal_object(BUCKET, key, dry_run=dry_run), ref.heal_object(BUCKET, key, dry_run=dry_run)


def _assert_healed_like_the_jax_package(stacks, key: str, get: bool = False) -> None:
    port, _, port_drives, jax_drives, payloads, pristine, _ = stacks
    for i in range(DRIVES):
        got = _meta_fields(port_drives[i].read_version(BUCKET, key))
        assert got == _meta_fields(jax_drives[i].read_version(BUCKET, key)), f"drive {i}"
    if key in pristine:
        got_files = [_part_file(d, key) for d in port_drives]
        assert got_files == [_part_file(d, key) for d in jax_drives]
        assert got_files == pristine[key]
    if get:
        assert port.get_object(BUCKET, key)[1] == payloads[key]


def _remove_parts(drives_idx, key):
    def damage(drives):
        for i in drives_idx:
            os.remove(_part_path(drives[i], key))

    return damage


@pytest.mark.parametrize("key", PART_OBJECTS)
def test_heal_four_lost_part_files(stacks, key):
    *_, codec = stacks
    before = codec.stats()
    p, r = _heal_both(stacks, key, _remove_parts((1, 6, 11, 12), key))
    assert _result_fields(p) == _result_fields(r)
    assert p.version_id == r.version_id == ""
    assert p.disks_healed == 4
    assert [i for i, s in enumerate(p.after_drive_state) if s == "healed"] == [1, 6, 11, 12]
    _assert_healed_like_the_jax_package(stacks, key, get=True)
    after = codec.stats()
    if key == "two-mib":
        # The rebuild ran as one device-branch batch (plain kernels on the CPU).
        assert after["recon_batches_run"] - before["recon_batches_run"] == 1
        assert after["blocks_reconstructed"] - before["blocks_reconstructed"] == 2
        assert after["host_fallback_recon_blocks"] == before["host_fallback_recon_blocks"]
        # Heal's verify and the GET's, 12 rows of 2 chunks each; the GET's
        # calls of 2 chunks run on the device too.
        assert after["digests_verified"] - before["digests_verified"] == 2 * 12 * 2
    else:
        # Three full blocks and a 4-byte tail in one window: two device
        # programs (the full blocks, then the tail), none on the host codec.
        assert after["recon_batches_run"] - before["recon_batches_run"] == 2
        assert after["blocks_reconstructed"] - before["blocks_reconstructed"] == 4
        assert after["host_fallback_recon_blocks"] == before["host_fallback_recon_blocks"]
        assert after["digests_verified"] - before["digests_verified"] == 2 * 12 * 4


@pytest.mark.parametrize("key", PART_OBJECTS)
def test_heal_two_lost_and_one_corrupted_byte(stacks, key):
    def damage(drives):
        os.remove(_part_path(drives[2], key))
        os.remove(_part_path(drives[9], key))
        # A byte inside the second frame's chunk of drive 14's row.
        _flip_byte(_part_path(drives[14], key), 32 + 87382 + 32 + 1234)

    p, r = _heal_both(stacks, key, damage)
    assert _result_fields(p) == _result_fields(r)
    assert p.disks_healed == 3
    assert [i for i, s in enumerate(p.after_drive_state) if s == "healed"] == [2, 9, 14]
    _assert_healed_like_the_jax_package(stacks, key)


@pytest.mark.parametrize("key", PART_OBJECTS)
def test_heal_dry_run_reports_and_writes_nothing(stacks, key):
    lost = (0, 3, 5, 8)
    p, r = _heal_both(stacks, key, _remove_parts(lost, key), dry_run=True)
    assert _result_fields(p) == _result_fields(r)
    assert p.disks_healed == 4 and p.after_drive_state == ["ok"] * DRIVES
    port, ref, port_drives, *_ = stacks
    for i in lost:
        assert not os.path.exists(_part_path(port_drives[i], key))
    # Heal for real so the next case starts from a healthy set.
    p, r = port.heal_object(BUCKET, key), ref.heal_object(BUCKET, key)
    assert _result_fields(p) == _result_fields(r)
    _assert_healed_like_the_jax_package(stacks, key)


@pytest.mark.parametrize("key", PART_OBJECTS)
def test_heal_five_lost_raises_in_both_packages(stacks, key):
    port, ref, port_drives, jax_drives, _, pristine, _ = stacks
    lost = (0, 4, 7, 10, 13)
    for drives in (port_drives, jax_drives):
        _remove_parts(lost, key)(drives)
    raised = []
    for eo in (port, ref):
        with pytest.raises(Exception) as exc:
            eo.heal_object(BUCKET, key)
        raised.append(type(exc.value).__name__)
    assert raised == ["InsufficientReadQuorum", "InsufficientReadQuorum"]
    # Put the part files back (dirs and data dir are still there).
    for drives in (port_drives, jax_drives):
        for i in lost:
            obj = os.path.join(drives[i].root, BUCKET, key)
            data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
            with open(os.path.join(obj, data_dir, "part.1"), "wb") as f:
                f.write(pristine[key][i])
    _assert_healed_like_the_jax_package(stacks, key)


def _remove_object_dirs(drives_idx, key):
    def damage(drives):
        for i in drives_idx:
            shutil.rmtree(os.path.join(drives[i].root, BUCKET, key))

    return damage


@pytest.mark.parametrize("key", ["fifty-kib", "marked", "tiered"])
def test_heal_metadata_and_inline_objects(stacks, key):
    lost = (3, 7, 11, 15)
    p, r = _heal_both(stacks, key, _remove_object_dirs(lost, key))
    assert _result_fields(p) == _result_fields(r)
    assert p.disks_healed == 4
    assert [p.before_drive_state[i] for i in lost] == ["missing"] * 4
    assert [i for i, s in enumerate(p.after_drive_state) if s == "healed"] == list(lost)
    _assert_healed_like_the_jax_package(stacks, key, get=key == "fifty-kib")
    if key == "marked":
        assert stacks[2][3].read_version(BUCKET, key).deleted
