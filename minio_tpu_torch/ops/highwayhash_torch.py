"""Batched HighwayHash-256 on torch tensors: the plain version of kernel 2.

``hash256_batch`` maps [..., L] u8 streams to [..., 32] u8 digests under the
bitrot key (ops/highwayhash.py MAGIC_KEY). It is the numpy oracle of
ops/highwayhash.py written in torch: the four u64 lanes of v0/v1/mul0/mul1
are int64 tensors of shape [N, 4]. Additions and multiplications wrap modulo
2^64 exactly as on u64; logical right shifts are arithmetic shifts masked to
the bits a logical shift keeps, and constants with the top bit set are
written as their int64 two's-complement values.

The hash is sequential per stream, so this version runs one batch of torch
operations per 32-byte packet (about a dozen; the zipper merge is one byte
gather): right for the CPU tests and as the reference on the card, and no
measure of speed.
"""

from __future__ import annotations

import torch

from .highwayhash import MAGIC_KEY, _INIT0, _INIT1


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rot32(x: torch.Tensor) -> torch.Tensor:
    return _shr(x, 32) | (x << 32)


# The zipper merge is a fixed byte permutation of each 16-byte (even, odd)
# lane pair: output byte i is input byte _ZIPPER[i] of the pair, with the
# even lane's bytes first (little-endian). One gather on a uint8 view of the
# [N, 4] lanes computes all four terms.
_ZIPPER_PAIR = [3, 12, 2, 5, 14, 1, 15, 0, 11, 4, 10, 13, 9, 6, 8, 7]
_ZIPPER = torch.tensor(_ZIPPER_PAIR + [i + 16 for i in _ZIPPER_PAIR], dtype=torch.int64)


def _zipper(v: torch.Tensor) -> torch.Tensor:
    """[N, 4] lanes -> [N, 4] zipper terms (pairs (0, 1) and (2, 3))."""
    index = _ZIPPER if v.device.type == "cpu" else _ZIPPER.to(v.device)
    b = v.contiguous().view(torch.uint8)  # [N, 32]
    return b.index_select(1, index).view(torch.int64)


class _State:
    __slots__ = ("v0", "v1", "mul0", "mul1")

    def __init__(self, key: bytes, n: int, device):
        def lanes(vals) -> torch.Tensor:
            t = torch.tensor([_s64(int(v)) for v in vals], dtype=torch.int64, device=device)
            return t.expand(n, 4).clone()

        key_lanes = [int.from_bytes(key[8 * i : 8 * i + 8], "little") for i in range(4)]
        rot = [((k >> 32) | (k << 32)) & 0xFFFFFFFFFFFFFFFF for k in key_lanes]
        self.v0 = lanes([int(a) ^ b for a, b in zip(_INIT0, key_lanes)])
        self.v1 = lanes([int(a) ^ b for a, b in zip(_INIT1, rot)])
        self.mul0 = lanes(_INIT0)
        self.mul1 = lanes(_INIT1)


def _update(st: _State, lanes: torch.Tensor) -> None:
    """One packet round; lanes: [N, 4] int64 (little-endian packet words)."""
    # The state's tensors are its own (fresh results or clones), so all but
    # the first step update them in place: fewer tensors made per packet.
    st.v1 = st.v1 + st.mul0 + lanes
    st.mul0 ^= (st.v1 & _M32) * (st.v0 >> 32).bitwise_and_(_M32)
    st.v0 += st.mul1
    st.mul1 ^= (st.v0 & _M32) * (st.v1 >> 32).bitwise_and_(_M32)
    st.v0 += _zipper(st.v1)
    st.v1 += _zipper(st.v0)


def _rotate_32_by(count: int, v: torch.Tensor) -> torch.Tensor:
    """Rotate both 32-bit halves of each lane left by count (0 < count < 32)."""
    lo = v & _M32
    hi = _shr(v, 32)
    rl = ((lo << count) | (lo >> (32 - count))) & _M32
    rh = ((hi << count) | (hi >> (32 - count))) & _M32
    return rl | (rh << 32)


def _modular_reduction(a3u, a2, a1, a0):
    a3 = a3u & 0x3FFFFFFFFFFFFFFF
    m1 = a1 ^ ((a3 << 1) | _shr(a2, 63)) ^ ((a3 << 2) | _shr(a2, 62))
    m0 = a0 ^ (a2 << 1) ^ (a2 << 2)
    return m0, m1


def _words(packets: torch.Tensor) -> torch.Tensor:
    """[..., 32*P] u8 -> [..., P, 4] int64 little-endian packet lanes.

    The bytes are copied into fresh storage first: a slice can count as
    contiguous (one row) and still have a row stride or storage offset that
    is no multiple of 8, which an int64 view refuses."""
    *lead, nbytes = packets.shape
    dense = torch.empty(packets.shape, dtype=torch.uint8, device=packets.device)
    dense.copy_(packets)
    return dense.view(torch.int64).reshape(*lead, nbytes // 32, 4)


def hash256_batch(data: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HighwayHash-256 of equal-length streams: [..., L] u8 -> [..., 32] u8."""
    if data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8, got {data.dtype}")
    lead = data.shape[:-1]
    length = data.shape[-1]
    n = 1
    for d in lead:
        n *= d
    flat = data.reshape(n, length)
    st = _State(key, n, data.device)
    n_full = length // 32
    if n_full and n:
        lanes = _words(flat[:, : n_full * 32])  # [N, P, 4]
        for i in range(n_full):
            _update(st, lanes[:, i])
    r = length - n_full * 32
    if r:
        st.v0 = st.v0 + ((r << 32) + r)
        st.v1 = _rotate_32_by(r, st.v1)
        tail = flat[:, n_full * 32 :]
        packet = torch.zeros((n, 32), dtype=torch.uint8, device=data.device)
        whole = r & ~3
        packet[:, :whole] = tail[:, :whole]
        if r & 16:
            packet[:, 28:32] = tail[:, r - 4 : r]
        elif r & 3:
            mod4 = r & 3
            packet[:, 16] = tail[:, whole]
            packet[:, 17] = tail[:, whole + (mod4 >> 1)]
            packet[:, 18] = tail[:, whole + mod4 - 1]
        _update(st, _words(packet)[:, 0])
    for _ in range(10):
        p = _rot32(st.v0[:, [2, 3, 0, 1]])
        _update(st, p)
    h0, h1 = _modular_reduction(
        st.v1[:, 1] + st.mul1[:, 1],
        st.v1[:, 0] + st.mul1[:, 0],
        st.v0[:, 1] + st.mul0[:, 1],
        st.v0[:, 0] + st.mul0[:, 0],
    )
    h2, h3 = _modular_reduction(
        st.v1[:, 3] + st.mul1[:, 3],
        st.v1[:, 2] + st.mul1[:, 2],
        st.v0[:, 3] + st.mul0[:, 3],
        st.v0[:, 2] + st.mul0[:, 2],
    )
    out = torch.stack([h0, h1, h2, h3], dim=1).contiguous()  # [N, 4] int64
    return out.view(torch.uint8).reshape(*lead, 32)
