"""minio_tpu_torch ops on the CPU, held byte for byte against the JAX package.

Inputs come from numpy generators and go through both packages: the JAX side
runs its Pallas kernels in interpret mode (as tests/test_rs_pallas.py and
tests/test_highwayhash_pallas.py run them), the port runs the plain torch
versions of its CUDA kernels (a CPU tensor selects them). Tolerance: exact
equality everywhere -- shard bytes and digests are an on-disk format.

Tests marked ``cuda`` run the hand-written kernels against their plain
versions and skip without a card.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import xxhash

from minio_tpu.ops import highwayhash as jax_hh_host
from minio_tpu.ops import highwayhash_pallas as jax_hhp
from minio_tpu.ops import rs as jax_rs
from minio_tpu.ops import rs_matrix as jax_rs_matrix
from minio_tpu.ops import rs_ref as jax_rs_ref
from minio_tpu.ops.rs_pallas import RSPallasCodec
from minio_tpu.storage import format as jax_format
from minio_tpu_torch import convert
from minio_tpu_torch.ops import highwayhash as port_hh
from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs, rs_cuda, rs_matrix
from minio_tpu_torch.storage import format as port_format
from tests.golden_rs import GOLDEN

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "minio_tpu_torch"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# -- Reed-Solomon ----------------------------------------------------------------


@pytest.mark.parametrize(
    "k,m,s",
    [(12, 4, 1), (12, 4, 3), (4, 2, 17), (7, 5, 4095), (3, 1, 17), (10, 6, 3), (12, 4, 87_382)],
)
def test_rs_encode_matches_pallas_and_reference(k, m, s):
    rng = np.random.default_rng(1000 * k + 10 * m + s)
    b = 1 if s > 10_000 else 3
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    want = np.asarray(RSPallasCodec(k, m).encode(data))
    got = rs.RSCodec(k, m).encode(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)
    got_wrapper = rs_cuda.apply(torch.from_numpy(data), rs_matrix.parity_matrix(k, m)).numpy()
    np.testing.assert_array_equal(got_wrapper, want)
    for i in range(b):
        np.testing.assert_array_equal(got[i], jax_rs_ref.encode(data[i], m)[k:])


@pytest.mark.parametrize("missing", [(0, 5, 13), (1, 2, 3, 15)])
def test_rs_reconstruct_matches_pallas(missing):
    k, m, s = 12, 4, 333
    rng = np.random.default_rng(sum(missing))
    data = rng.integers(0, 256, (2, k, s), dtype=np.uint8)
    full = np.asarray(RSPallasCodec(k, m).encode_all(data))
    present = tuple(i not in missing for i in range(k + m))
    surv = np.stack([full[:, i] for i in range(k + m) if present[i]][:k], axis=1)
    jax_codec = RSPallasCodec(k, m)
    want = np.asarray(jax_codec.apply(surv, jax_codec.reconstruct_weights(present, missing)))
    port_codec = rs.RSCodec(k, m)
    got = port_codec.apply(torch.from_numpy(surv), port_codec.reconstruct_weights(present, missing)).numpy()
    np.testing.assert_array_equal(got, want)
    coeffs = rs_matrix.reconstruct_rows(k, m, present, missing)
    got_wrapper = rs_cuda.apply(torch.from_numpy(surv), coeffs).numpy()
    np.testing.assert_array_equal(got_wrapper, want)
    for j, row in enumerate(missing):
        np.testing.assert_array_equal(got[:, j], full[:, row])


def _golden_hash(encoded: np.ndarray) -> int:
    h = xxhash.xxh64()
    for i in range(encoded.shape[0]):
        h.update(bytes([i]))
        h.update(encoded[i].tobytes())
    return h.intdigest()


@pytest.mark.parametrize("geometry", sorted(GOLDEN))
def test_rs_golden_vectors(geometry):
    k, m = geometry
    shards = rs_matrix.split(bytes(range(256)), k)
    enc = rs.RSCodec(k, m).encode_all(torch.from_numpy(shards)[None])[0].numpy()
    assert _golden_hash(enc) == GOLDEN[geometry]


def test_rs_apply_writes_out_view():
    k, m, s = 12, 4, 100
    data = np.random.default_rng(3).integers(0, 256, (2, k, s), dtype=np.uint8)
    all_shards = torch.zeros((2, k + m, s), dtype=torch.uint8)
    all_shards[:, :k] = torch.from_numpy(data)
    rs_cuda.apply(all_shards[:, :k], rs_matrix.parity_matrix(k, m), out=all_shards[:, k:])
    np.testing.assert_array_equal(all_shards.numpy(), np.asarray(RSPallasCodec(k, m).encode_all(data)))


def test_rs_product_table_bytes():
    coeffs = rs_matrix.parity_matrix(12, 4)
    table = rs_cuda.product_table(coeffs)
    mul = rs_matrix.gf.mul_table()
    assert table.shape == (1, 12, 256)
    for r in range(4):
        for k in (0, 7, 11):
            np.testing.assert_array_equal((table[0, k] >> (8 * r)) & 0xFF, mul[coeffs[r, k]])


_TILE = 512  # kTile in csrc/rs_gf.cu: 16 positions for each of 32 lanes


def _realign(lo, hi, a: int):
    """Bytes a..a+15 (0 <= a < 16) of lo ++ hi, [32, 4] u32 words each, as
    the kernel's realign(): word select, then __funnelshift_r."""
    c = np.concatenate([lo, hi], axis=1)[:, a >> 2 :][:, :5]
    return np.stack([_funnel_r(c[:, i], c[:, i + 1], 8 * (a & 3)) for i in range(4)], axis=1)


def _rs_kernel_model(xbuf, x_base, obuf, o_base, coeffs, s, span_tiles, exchange=True):
    """One batch item of csrc/rs_gf.cu, lane by lane: input row k starts at
    byte x_base + k*s of xbuf, output row r at o_base + r*s of obuf; both
    buffers start on a 16-byte boundary. A tile of an input row is staged as
    the 33 aligned granules that cover it (those holding a row byte), and
    lane t funnel-shifts its 16 bytes out of staged granules t and t+1;
    output granules take lane t-1's last bytes, and the first lane of a tile
    takes them from the previous tile's last lane. Full stores write whole
    aligned granules. `exchange` False drops the neighbour's part on both
    sides: lane t reads granule t alone and writes its own bytes alone."""
    r_rows, k_rows = coeffs.shape
    table = rs_cuda.product_table(coeffs).astype(np.uint64)
    lane = np.arange(32)
    tiles = -(-s // _TILE)
    for begin in range(0, tiles * _TILE, span_tiles * _TILE):
        end = min(s, begin + span_tiles * _TILE)
        for g in range(table.shape[0]):
            carry = [np.zeros(4, np.uint64)] * 4
            for t0 in range(begin, end, _TILE):
                p = t0 + 16 * lane
                acc = np.zeros((32, 16), np.uint64)
                for k in range(k_rows):
                    a = (x_base + k * s) & 15
                    g0 = x_base + k * s + t0 - a  # the aligned granule holding position t0
                    stage = np.zeros((33, 16), np.uint8)
                    for i in range(33):
                        if t0 - a + 16 * i < end:
                            stage[i] = xbuf[g0 + 16 * i : g0 + 16 * i + 16]
                    words = stage.view("<u4").astype(np.uint64)
                    hi = words[1:] if exchange else np.zeros_like(words[1:])
                    w = _realign(words[:32], hi, a)
                    for j in range(16):
                        v = (w[:, j >> 2] >> _U64(8 * (j & 3))) & _U64(0xFF)
                        acc[:, j] ^= table[g, k, v.astype(int)]
                o = np.zeros((4, 32, 4), np.uint64)
                for qd in range(4):
                    a0, a1, a2, a3 = (acc[:, 4 * qd + i] for i in range(4))
                    t_0, t_1 = _byte_perm(a0, a1, 0x5140), _byte_perm(a0, a1, 0x7362)
                    t_2, t_3 = _byte_perm(a2, a3, 0x5140), _byte_perm(a2, a3, 0x7362)
                    o[0, :, qd], o[1, :, qd] = _byte_perm(t_0, t_2, 0x5410), _byte_perm(t_0, t_2, 0x7632)
                    o[2, :, qd], o[3, :, qd] = _byte_perm(t_1, t_3, 0x5410), _byte_perm(t_1, t_3, 0x7632)
                for r in range(min(4, r_rows - 4 * g)):
                    row = o_base + (4 * g + r) * s
                    c = row & 15
                    prev = np.zeros_like(o[r])
                    if exchange:
                        prev[1:] = o[r][:-1]
                    prev[0] = carry[r]
                    carry[r] = o[r][31].copy()
                    va = (_realign(prev, o[r], 16 - c) if c else o[r]).astype("<u4").view(np.uint8).reshape(32, 16)
                    own = o[r].astype("<u4").view(np.uint8).reshape(32, 16)
                    for t in range(32):
                        ga = int(p[t]) - c
                        if ga < end:
                            lo, hi = max(ga, begin) - ga, min(ga + 16, end) - ga
                            obuf[row + ga + lo : row + ga + hi] = va[t, lo:hi]
                        if c and p[t] < end <= p[t] + 16 and ga + 16 < end:
                            obuf[row + ga + 16 : row + end] = own[t, 16 - c : 16 - c + end - ga - 16]


_MODEL_S = [1, 3, 15, 16, 17, 4095, 4096, 87_381, 87_382]


@pytest.mark.parametrize("s", _MODEL_S)
def test_rs_kernel_realignment_model_matches_plain_and_pallas(s):
    k, m = 12, 4
    data = np.random.default_rng(s).integers(0, 256, (1, k, s), dtype=np.uint8)
    want = np.asarray(RSPallasCodec(k, m).encode(data))[0]
    np.testing.assert_array_equal(rs_cuda.plain(torch.from_numpy(data), rs_matrix.parity_matrix(k, m))[0].numpy(), want)
    present = tuple(i not in (0, 5, 12, 15) for i in range(k + m))
    for shift in range(16):
        # Input rows `shift` bytes past a granule, output rows elsewhere, and
        # R = 1..4 rows; spans of 1-3 tiles put span edges inside rows.
        o_shift, span = (7 * shift + 3) % 16, 1 + shift % 3
        r = 1 + shift % 4
        coeffs = rs_matrix.parity_matrix(k, m) if r == 4 else rs_matrix.reconstruct_rows(k, m, present, (0, 5, 12)[:r])
        xbuf = np.zeros(16 + k * s + 32, np.uint8)
        xbuf[shift : shift + k * s] = data[0].reshape(-1)
        obuf = np.full(16 + r * s + 32, 0xA5, np.uint8)
        _rs_kernel_model(xbuf, shift, obuf, o_shift, coeffs, s, span)
        got = obuf[o_shift : o_shift + r * s].reshape(r, s)
        ref = want if r == 4 else rs_cuda.plain(torch.from_numpy(data), coeffs)[0].numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"shift {shift}, out shift {o_shift}, R {r}")
        # Nothing outside the output rows was written.
        assert (obuf[:o_shift] == 0xA5).all() and (obuf[o_shift + r * s :] == 0xA5).all()


def test_rs_kernel_model_fails_without_neighbour_exchange():
    k, m, s = 12, 4, 4096
    data = np.random.default_rng(9).integers(0, 256, (k, s), dtype=np.uint8)
    coeffs = rs_matrix.parity_matrix(k, m)
    want = rs_cuda.plain(torch.from_numpy(data[None]), coeffs)[0].numpy()
    xbuf = np.zeros(16 + k * s + 32, np.uint8)
    xbuf[6 : 6 + k * s] = data.reshape(-1)
    outs = {}
    for exchange in (True, False):
        obuf = np.zeros(16 + m * s + 32, np.uint8)
        _rs_kernel_model(xbuf, 6, obuf, 10, coeffs, s, 2, exchange=exchange)
        outs[exchange] = obuf[10 : 10 + m * s].reshape(m, s)
    np.testing.assert_array_equal(outs[True], want)
    assert not np.array_equal(outs[False], want)


def test_rs_apply_rejects_bad_shapes():
    with pytest.raises(ValueError):
        rs_cuda.apply(torch.zeros((2, 12, 8), dtype=torch.uint8), np.zeros((4, 11), np.uint8))
    with pytest.raises(ValueError):
        rs_cuda.apply(torch.zeros((12, 8), dtype=torch.uint8), np.zeros((4, 12), np.uint8))


# -- HighwayHash -----------------------------------------------------------------


# Lengths 0..33 cover the tail branches (r & 16, r & 3, whole words) and
# exact packets; 255 and 256 the remainder packets around one 8-packet chunk;
# 87,382 (2,730 packets + a 22-byte tail) is the production shard chunk.
@pytest.mark.parametrize("length", [0, 1, 3, 4, 15, 16, 22, 31, 32, 33, 255, 256, 87_382])
def test_hash_matches_oracle(length):
    rng = np.random.default_rng(length + 7)
    n = 2 if length > 10_000 else 5
    data = rng.integers(0, 256, (n, length), dtype=np.uint8)
    got = highwayhash_cuda.hash256_batch(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, jax_hh_host.hash256_batch(data))


# The JAX Pallas hash compiles one program per length on the CPU (seconds
# each; minutes where many remainder packets unroll), so it is held here at
# one remainder packet plus a 1-byte tail, and at the chunked chain plus a
# 22-byte tail; tests/test_highwayhash_pallas.py holds it against the numpy
# oracle at the production length.
@pytest.mark.parametrize("length", [33, 3 * 8 * 32 + 22])
def test_hash_matches_pallas(length):
    data = np.random.default_rng(length).integers(0, 256, (3, length), dtype=np.uint8)
    got = highwayhash_cuda.hash256_batch(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hhp.hash256_batch(data)))


_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)


def _byte_perm(x, y, sel: int):
    """CUDA __byte_perm on u32 values held in u64 arrays."""
    src = [(x >> _U64(8 * i)) & _U64(0xFF) for i in range(4)] + [
        (y >> _U64(8 * i)) & _U64(0xFF) for i in range(4)
    ]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << _U64(8 * i)
    return out


def _funnel_r(lo, hi, bits: int):
    """CUDA __funnelshift_r(lo, hi, bits) for 0 <= bits < 32."""
    return (((hi << _U64(32)) | lo) >> _U64(bits)) & _M32


def _join(lo, hi):
    return lo | (hi << _U64(32))


class _HalfState:
    """One kernel thread's state: lanes 2h, 2h+1 of v0/v1/mul0/mul1, [B] u64 each."""

    def __init__(self, half: int, b: int):
        key = np.frombuffer(port_hh.MAGIC_KEY, dtype="<u8")
        lanes = [2 * half, 2 * half + 1]
        rot = (key >> _U64(32)) | (key << _U64(32))
        self.v0 = [np.full(b, port_hh._INIT0[i] ^ key[i]) for i in lanes]
        self.v1 = [np.full(b, port_hh._INIT1[i] ^ rot[i]) for i in lanes]
        self.mul0 = [np.full(b, port_hh._INIT0[i]) for i in lanes]
        self.mul1 = [np.full(b, port_hh._INIT1[i]) for i in lanes]

    @staticmethod
    def _zipper(a, b):
        al, ah, bl, bh = a & _M32, a >> _U64(32), b & _M32, b >> _U64(32)
        e = _join(_byte_perm(_byte_perm(al, ah, 0x5203), bh, 0x3240), _byte_perm(al, bh, 0x0716))
        o = _join(_byte_perm(_byte_perm(bl, bh, 0x5203), ah, 0x3240), _byte_perm(bl, ah, 0x7061))
        return e, o

    def update(self, lanes) -> None:
        for i in range(2):
            self.v1[i] = self.v1[i] + self.mul0[i] + lanes[i]
            self.mul0[i] = self.mul0[i] ^ ((self.v1[i] & _M32) * (self.v0[i] >> _U64(32)))
            self.v0[i] = self.v0[i] + self.mul1[i]
            self.mul1[i] = self.mul1[i] ^ ((self.v0[i] & _M32) * (self.v1[i] >> _U64(32)))
        e, o = self._zipper(self.v1[0], self.v1[1])
        self.v0 = [self.v0[0] + e, self.v0[1] + o]
        e, o = self._zipper(self.v0[0], self.v0[1])
        self.v1 = [self.v1[0] + e, self.v1[1] + o]


def _lane_pair_hash(data: np.ndarray, shift: int) -> np.ndarray:
    """HighwayHash-256 of [B, L] rows as csrc/highwayhash.cu computes it: two
    independent lane-pair states per stream, each reading its 16 bytes of a
    packet as 5 aligned u32 words of a buffer whose row starts `shift` bytes
    past a 16-byte boundary, funnel-shifted; the pairs exchange v0 lanes only
    in the permute rounds."""
    b, length = data.shape
    width = -(-(shift + length + 20) // 4) * 4
    buf = np.zeros((b, width), dtype=np.uint8)
    buf[:, shift : shift + length] = data
    words = buf.view("<u4").astype(np.uint64)
    fs = 8 * (shift & 3)
    halves = [_HalfState(0, b), _HalfState(1, b)]
    n_full = length // 32
    with np.errstate(over="ignore"):
        for p in range(n_full):
            for h, st in enumerate(halves):
                w = words[:, (shift + 32 * p + 16 * h) // 4 :][:, :5].T
                st.update([
                    _join(_funnel_r(w[0], w[1], fs), _funnel_r(w[1], w[2], fs)),
                    _join(_funnel_r(w[2], w[3], fs), _funnel_r(w[3], w[4], fs)),
                ])
        r = length - 32 * n_full
        if r:
            packet = port_hh._remainder_packet(np.ascontiguousarray(data[:, 32 * n_full :]))
            lanes = packet.view("<u8").astype(np.uint64)
            for h, st in enumerate(halves):
                for i in range(2):
                    st.v0[i] = st.v0[i] + _U64((r << 32) + r)
                    st.v1[i] = port_hh._rotate_32_by(r, st.v1[i])
                st.update([lanes[:, 2 * h], lanes[:, 2 * h + 1]])
        for _ in range(10):
            # Each thread's packet lanes are the partner's v0 lanes, rotated.
            swapped = [list(halves[1].v0), list(halves[0].v0)]
            for st, partner in zip(halves, swapped):
                st.update([port_hh._rot32(v) for v in partner])
        out = []
        for st in halves:
            m0, m1 = port_hh._modular_reduction(
                st.v1[1] + st.mul1[1], st.v1[0] + st.mul1[0], st.v0[1] + st.mul0[1], st.v0[0] + st.mul0[0]
            )
            out += [m0, m1]
    return np.stack(out, axis=1).astype("<u8").view(np.uint8)


@pytest.mark.parametrize("shift", [0, 6, 13])
@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 255, 87_382])
def test_hash_lane_pair_split_matches_oracle(length, shift):
    data = np.random.default_rng(length * 16 + shift).integers(0, 256, (3, length), dtype=np.uint8)
    np.testing.assert_array_equal(_lane_pair_hash(data, shift), port_hh.hash256_batch(data))


# One row of a wider tensor counts as contiguous whatever its row stride, and
# a view can start at any byte: the plain version must hash both.
@pytest.mark.parametrize("length", [33, 64, 87_382])
def test_hash_plain_one_row_and_offset_views(length):
    data = np.random.default_rng(length).integers(0, 256, (3, length + 1), dtype=np.uint8)
    t = torch.from_numpy(data)
    np.testing.assert_array_equal(
        highwayhash_cuda.hash256_batch(t[:1, :length]).numpy(), jax_hh_host.hash256_batch(data[:1, :length])
    )
    flat = t.reshape(-1)[3 : 3 + 2 * length].view(2, length)
    np.testing.assert_array_equal(
        highwayhash_cuda.hash256_batch(flat).numpy(), jax_hh_host.hash256_batch(flat.numpy())
    )


def test_hash_leading_batch_shape():
    data = np.random.default_rng(11).integers(0, 256, (2, 3, 100), dtype=np.uint8)
    got = highwayhash_torch.hash256_batch(torch.from_numpy(data)).numpy()
    want = jax_hh_host.hash256_batch(data.reshape(6, 100)).reshape(2, 3, 32)
    np.testing.assert_array_equal(got, want)


# -- state carried across from the JAX package ------------------------------------


def test_from_jax_layout_coding_state():
    k, m = 12, 4
    present = tuple(i not in (2, 9, 14) for i in range(k + m))
    want = (2, 9, 14)
    out = convert.from_jax_layout(
        k, m,
        parity_matrix=jax_rs_matrix.parity_matrix(k, m),
        parity_weights=jax_rs.parity_weights(k, m),
        present=present, want=want,
        reconstruct_rows=jax_rs_matrix.reconstruct_rows(k, m, present, want),
        device="cpu",
    )
    assert out["parity"].dtype == torch.uint8 and tuple(out["parity"].shape) == (m, k)
    np.testing.assert_array_equal(out["parity_weights"].numpy(), jax_rs.parity_weights(k, m))
    np.testing.assert_array_equal(
        out["reconstruct"].numpy(), jax_rs_matrix.reconstruct_rows(k, m, present, want)
    )
    data = np.random.default_rng(5).integers(0, 256, (1, k, 64), dtype=np.uint8)
    got = rs.gf_matmul(torch.from_numpy(data), out["parity_weights"]).numpy()
    np.testing.assert_array_equal(got, np.asarray(RSPallasCodec(k, m).encode(data)))


def test_from_jax_layout_defaults_to_cuda():
    # Like every entry point of the port, the converter puts tensors on the
    # card unless the caller asks for the CPU; without a card that raises.
    pm = jax_rs_matrix.parity_matrix(12, 4)
    if torch.cuda.is_available():
        assert convert.from_jax_layout(12, 4, parity_matrix=pm)["parity"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.from_jax_layout(12, 4, parity_matrix=pm)
    assert convert.from_jax_layout(12, 4, parity_matrix=pm, device="cpu")["parity"].device.type == "cpu"


def test_from_jax_layout_rejects_mismatch():
    with pytest.raises(ValueError):
        convert.from_jax_layout(12, 4, parity_matrix=jax_rs_matrix.parity_matrix(12, 3)[:, :12])
    bad = jax_rs.parity_weights(12, 4).copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError):
        convert.from_jax_layout(12, 4, parity_weights=bad)
    with pytest.raises(ValueError):
        convert.from_jax_layout(
            12, 4, reconstruct_rows=jax_rs_matrix.reconstruct_rows(12, 4, (True,) * 16, (0,))
        )


def test_format_json_loads_both_ways(tmp_path):
    jax_formats = jax_format.init_format(1, 4)
    for i, f in enumerate(jax_formats):
        f.save(str(tmp_path / f"jax{i}"))
        port = port_format.DriveFormat.load(str(tmp_path / f"jax{i}"))
        assert (port.deployment_id, port.this_id, port.sets) == (f.deployment_id, f.this_id, f.sets)
        conv = convert.from_jax_layout(12, 4, format_json=json.loads(f.to_json()))["format"]
        assert conv == port
    for i, f in enumerate(port_format.init_format(1, 4)):
        f.save(str(tmp_path / f"port{i}"))
        back = jax_format.DriveFormat.load(str(tmp_path / f"port{i}"))
        assert (back.deployment_id, back.this_id, back.sets, back.distribution_algo) == (
            f.deployment_id, f.this_id, f.sets, f.distribution_algo,
        )


# -- structure: the port imports neither jax nor the JAX package -------------------


def _port_modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_checks_cover_sets_pools_and_metacache():
    mods = _port_modules()
    for m in ("object.metacache", "object.sets", "object.pools"):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_the_s3_front():
    mods = _port_modules()
    for m in ("api.server", "api.auth", "control.iam", "utils.deadline"):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_the_fault_plane():
    mods = _port_modules()
    for m in (
        "control.sanitizer", "control.pubsub", "control.logging", "control.perf",
        "control.tracing", "control.degrade", "control.profiler", "control.bufsan",
        "chaos.faults", "chaos.crash", "chaos", "storage.metered", "chaos.disk",
        "storage.breaker", "storage.recovery",
    ):
        assert f"minio_tpu_torch.{m}" in mods
        rel = m.replace(".", "/") + ("/__init__.py" if m == "chaos" else ".py")
        assert (PORT / rel) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_the_boot_path():
    mods = _port_modules()
    for m in (
        "_probe_child", "runtime", "cli", "__main__", "dist", "dist.node", "api.admin",
        "control.config", "control.healmgr", "ops.goldens",
        # Pool lifecycle, the scanner and tiering (node.py wires them).
        "object.poolmgr", "control.rebalance", "control.scanner", "control.usage",
        "control.lifecycle", "control.tiering", "control.replication",
    ):
        assert f"minio_tpu_torch.{m}" in mods
        rel = m.replace(".", "/") + ("/__init__.py" if m == "dist" else ".py")
        assert (PORT / rel) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_the_host_side():
    mods = _port_modules()
    for m in ("ops.native", "api.prefork", "control.compress", "storage.local", "object.codec", "ops.bitrot"):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))
    # The host library's C++ sources are the port's own copies.
    for name in ("minio_native.cpp", "minio_io.cpp"):
        assert (PORT / "csrc" / "host" / name).is_file()
    assert not list((PORT / "csrc").glob("*.cpp"))  # the nvcc build globs csrc/*.cu only


def test_import_checks_cover_distribution():
    mods = _port_modules()
    for m in ("dist.transport", "dist.storage_rest", "dist.locks", "dist.peer", "chaos.net"):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))
    # The breaker takes jitter from the transport, as the JAX breaker does,
    # and the object layer keeps no process-local lock of its own.
    from minio_tpu_torch.object import erasure
    from minio_tpu_torch.storage import breaker

    assert not hasattr(breaker, "jitter")
    assert not hasattr(erasure, "_NamespaceLock")


def test_import_checks_cover_events_and_operations():
    mods = _port_modules()
    for m in (
        "control.events", "control.event_targets", "api.streams", "control.bandwidth", "control.metrics",
        "control.selftest", "control.health", "control.flight", "control.update",
    ):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_replication_and_identity():
    mods = _port_modules()
    for m in (
        "control.replication", "control.site_replication", "api.jwt", "api.sts", "api.console",
        "control.ldap", "control.etcd",
    ):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))


def test_import_checks_cover_select_fs_and_gateways():
    mods = _port_modules()
    for m in (
        "s3select", "s3select.value", "s3select.records", "s3select.sql", "s3select.eval", "s3select.readers",
        "s3select.parquet", "s3select.eventstream", "s3select.select", "object.fs", "object.gateway",
    ):
        assert f"minio_tpu_torch.{m}" in mods
        rel = m.replace(".", "/") + ("/__init__.py" if m == "s3select" else ".py")
        assert (PORT / rel) in sorted(PORT.rglob("*.py"))
    assert sorted(p.name for p in (PORT / "s3select").glob("*.py")) == sorted(
        p.name for p in (REPO / "minio_tpu" / "s3select").glob("*.py"))


def test_import_checks_cover_the_mesh():
    mods = _port_modules()
    for m in ("parallel.mesh", "parallel.batching", "models.pipeline"):
        assert f"minio_tpu_torch.{m}" in mods
        assert (PORT / (m.replace(".", "/") + ".py")) in sorted(PORT.rglob("*.py"))
    # Every module of the JAX package's parallel/ has its counterpart.
    assert sorted(p.name for p in (PORT / "parallel").glob("*.py")) == sorted(
        p.name for p in (REPO / "minio_tpu" / "parallel").glob("*.py"))


def test_port_imports_no_jax_in_fresh_interpreter():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, '.'); import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'minio_tpu' or n.startswith('minio_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_port_sources_have_no_jax_or_minio_tpu_imports():
    offenders = []
    for p in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(p.read_text(), filename=str(p))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "minio_tpu"):
                    offenders.append(f"{p.relative_to(REPO)}: {n}")
    assert offenders == []


# -- the CUDA kernels against their plain versions (card only) ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 17, 4096, 87_382])
def test_cuda_rs_kernel_matches_plain(cuda_device, s):
    gen = torch.Generator().manual_seed(s)
    x = torch.randint(0, 256, (4, 12, s), dtype=torch.uint8, generator=gen).to(cuda_device)
    pm = rs_matrix.parity_matrix(12, 4)
    assert torch.equal(rs_cuda.apply(x, pm), rs_cuda.plain(x, pm))
    # The fused encode's strided out view: parity rows of an all-shards tensor.
    shards = torch.randint(0, 256, (4, 16, s), dtype=torch.uint8, generator=gen).to(cuda_device)
    rs_cuda.apply(shards[:, :12], pm, out=shards[:, 12:])
    assert torch.equal(shards[:, 12:], rs_cuda.plain(shards[:, :12], pm))
    # R = 1..4 reconstruct rows on rows 1..15 bytes past a 16-byte boundary,
    # in and out.
    present = tuple(i not in (0, 5, 12, 15) for i in range(16))
    xbuf = torch.randint(0, 256, (16 + 2 * 12 * s,), dtype=torch.uint8, generator=gen).to(cuda_device)
    obuf = torch.zeros(16 + 2 * 4 * s, dtype=torch.uint8, device=cuda_device)
    for off in range(1, 16):
        r = 1 + off % 4
        coeffs = rs_matrix.reconstruct_rows(12, 4, present, (0, 5, 12, 15)[:r])
        xv = xbuf[off : off + 2 * 12 * s].view(2, 12, s)
        ov = obuf[(7 * off + 3) % 16 :][: 2 * r * s].view(2, r, s)
        rs_cuda.apply(xv, coeffs, out=ov)
        assert torch.equal(ov, rs_cuda.plain(xv, coeffs)), f"offset {off}, R {r}"


@pytest.mark.cuda
def test_cuda_rs_launches_from_threads_with_different_k(cuda_device):
    """The degraded GET launches reconstructs of 12+4 and 14+2 objects from
    many threads at once; each K asks the kernel for another amount of
    dynamic shared memory, a limit every thread shares. No launch may fail
    or differ."""
    import concurrent.futures as cf

    gen = torch.Generator().manual_seed(7)
    cases = []
    for k, m, lost in ((12, 4, (0, 5, 12, 15)), (14, 2, (3, 15))):
        x = torch.randint(0, 256, (2, k, 4096), dtype=torch.uint8, generator=gen).to(cuda_device)
        present = tuple(i not in lost for i in range(k + m))
        for r in range(1, len(lost) + 1):
            c = rs_matrix.reconstruct_rows(k, m, present, lost[:r])
            cases.append((x, c, rs_cuda.plain(x, c)))

    def hammer(t: int) -> int:
        bad = 0
        for i in range(1000):
            x, c, want = cases[(t + i * (1 + t % 5)) % len(cases)]
            bad += not torch.equal(rs_cuda.apply(x, c), want)
        return bad

    with cf.ThreadPoolExecutor(8) as ex:
        assert sum(ex.map(hammer, range(8))) == 0


# N = 16 is the GET verify batch (one block), 17 leaves a part-filled block,
# 1,024 is the 64-block encode batch.
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 17, 1024])
@pytest.mark.parametrize("length", [0, 3, 22, 33, 87_382])
def test_cuda_hash_kernel_matches_plain(cuda_device, length, n):
    gen = torch.Generator().manual_seed(length + n)
    x = torch.randint(0, 256, (n, length), dtype=torch.uint8, generator=gen).to(cuda_device)
    assert torch.equal(highwayhash_cuda.hash256_batch(x), highwayhash_torch.hash256_batch(x))


# Rows whose base lies 1..15 bytes past a 16-byte boundary: views into one
# flat buffer. The plain version runs once on all offsets' rows stacked.
@pytest.mark.cuda
@pytest.mark.parametrize("length", [22, 33, 1046, 87_382])
def test_cuda_hash_kernel_unaligned_rows(cuda_device, length):
    n, offsets = 17, range(1, 16)
    gen = torch.Generator().manual_seed(length)
    buf = torch.randint(0, 256, (16 + n * length,), dtype=torch.uint8, generator=gen).to(cuda_device)
    views = [buf[off : off + n * length].view(n, length) for off in offsets]
    got = torch.cat([highwayhash_cuda.hash256_batch(v) for v in views])
    assert torch.equal(got, highwayhash_torch.hash256_batch(torch.cat(views)))
