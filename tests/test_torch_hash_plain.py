"""The plain HighwayHash-256 of minio_tpu_torch (ops/highwayhash_torch.py),
held against the JAX package's numpy reference (minio_tpu/ops/highwayhash.py).

The plain version computes the zipper merge as one byte gather on a uint8
view of the [N, 4] int64 lanes, and updates its state in place. Held here:
the gather equals the reference's shift-and-mask `_zipper_merge` on seeded
lanes that set every bit (the top bit of each lane included); one packet
round equals the reference's `_update`; and the digests equal the
reference's at every tail length 0..64, around one 8-packet chunk, at the
production shard chunk, under the bitrot key and under another key, for one
row and for many. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minio_tpu.ops import highwayhash as jax_hh
from minio_tpu_torch.ops import highwayhash_torch


def _lanes(seed: int, n: int) -> np.ndarray:
    """[n, 4] u64 lanes: random words, all ones, lone top bits, alternating bytes."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 64, (n, 4), dtype=np.uint64, endpoint=False)
    v[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    v[1] = np.uint64(1 << 63)
    v[2] = np.uint64(0xFF00FF00FF00FF00)
    v[3] = np.uint64(0x00FF00FF00FF00FF)
    return v


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.view(np.int64).copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zipper_gather_matches_reference(seed):
    v = _lanes(seed, 257)
    assert (v >> np.uint64(63)).any()
    got = highwayhash_torch._zipper(_t(v)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, jax_hh._zipper_merge(v))


def test_zipper_gather_takes_a_strided_view():
    """The state's lanes are fresh tensors, but the gather must not depend
    on it: a non-contiguous [N, 4] view gives the same terms."""
    v = _lanes(5, 64)
    wide = torch.zeros((64, 8), dtype=torch.int64)
    wide[:, ::2] = _t(v)
    got = highwayhash_torch._zipper(wide[:, ::2]).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, jax_hh._zipper_merge(v))


def test_one_packet_round_matches_reference():
    key = bytes(np.random.default_rng(9).integers(0, 256, 32, dtype=np.uint8))
    n = 33
    ref = jax_hh._State(key, n)
    st = highwayhash_torch._State(key, n, "cpu")
    for i, packet in enumerate((_lanes(11, n), _lanes(12, n), _lanes(13, n))):
        jax_hh._update(ref, packet.copy())
        highwayhash_torch._update(st, _t(packet))
        for name in ("v0", "v1", "mul0", "mul1"):
            np.testing.assert_array_equal(getattr(st, name).numpy().view(np.uint64), getattr(ref, name), (i, name))


@pytest.mark.parametrize("length", list(range(65)) + [255, 256, 87_382])
def test_plain_hash_matches_reference(length):
    rng = np.random.default_rng(length + 70)
    n = 2 if length > 10_000 else 5
    data = rng.integers(0, 256, (n, length), dtype=np.uint8)
    got = highwayhash_torch.hash256_batch(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, jax_hh.hash256_batch(data))
    one = highwayhash_torch.hash256_batch(torch.from_numpy(data[:1])).numpy()
    np.testing.assert_array_equal(one, got[:1])


@pytest.mark.parametrize("length", [0, 17, 32, 100, 1000])
def test_plain_hash_matches_reference_under_another_key(length):
    rng = np.random.default_rng(length + 71)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    data = rng.integers(0, 256, (4, length), dtype=np.uint8)
    got = highwayhash_torch.hash256_batch(torch.from_numpy(data), key).numpy()
    np.testing.assert_array_equal(got, jax_hh.hash256_batch(data, key))
