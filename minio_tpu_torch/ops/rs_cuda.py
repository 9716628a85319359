"""Kernel 1: the Reed-Solomon GF(2^8) linear map, hand-written in CUDA.

``apply(x, coeffs)`` computes out[b, r, s] = XOR_k gfmul(coeffs[r, k],
x[b, k, s]) for a [B, K, S] u8 shard batch and an [R, K] GF(2^8)
coefficient matrix: the parity matrix for encode, the reconstruct rows of a
loss pattern for a degraded read. It replaces the TPU kernel
``minio_tpu/ops/rs_pallas.py::_kernel`` (launched by ``_apply_sched``).

On a CUDA tensor it launches ``csrc/rs_gf.cu``; on a CPU tensor it runs the
plain version, the GF(2) bit-matmul of ops/rs.py. There is no other path:
a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import gf, rs, rs_matrix
from .cuda_build import Kernel

KERNEL = Kernel(
    "rs_gf_apply_launch",
    [
        ctypes.c_void_p,  # x
        ctypes.c_longlong,  # x batch stride
        ctypes.c_void_p,  # product tables
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # out batch stride
        ctypes.c_int,  # B
        ctypes.c_int,  # K
        ctypes.c_int,  # R
        ctypes.c_longlong,  # S
        ctypes.c_void_p,  # stream
    ],
    error_symbol="rs_gf_error_string",
)

# The kernel stages the product tables in shared memory beside its own
# ~17 KiB ring, within the 227 KiB a block may use.
_MAX_TABLE_BYTES = 192 * 1024
_MAX_ROWS_BYTES = 2**31 - 1  # K*S and R*S: the kernel's offsets within a batch item are 32-bit

_TABLES: dict[tuple, torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()
_MAX_CACHED_TABLES = 256


def product_table(coeffs: np.ndarray) -> np.ndarray:
    """[R, K] GF(2^8) coefficients -> [ceil(R/4), K, 256] u32 tables whose
    byte j at [g, k, v] is gfmul(coeffs[4g + j, k], v)."""
    r, k = coeffs.shape
    groups = -(-r // 4)
    mul = gf.mul_table().astype(np.uint32)  # [256 (c), 256 (v)]
    table = np.zeros((groups, k, 256), dtype=np.uint32)
    for row in range(r):
        g, j = divmod(row, 4)
        table[g] |= mul[coeffs[row]] << np.uint32(8 * j)
    return table


def _device_table(coeffs: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (coeffs.shape, coeffs.tobytes(), str(device))
    with _TABLES_LOCK:
        t = _TABLES.get(key)
    if t is None:
        host = product_table(coeffs).view(np.int32)  # torch has no uint32 copy kernel on every build
        t = torch.from_numpy(host).to(device)
        with _TABLES_LOCK:
            if len(_TABLES) >= _MAX_CACHED_TABLES:
                _TABLES.clear()
            _TABLES[key] = t
    return t


def plain(x: torch.Tensor, coeffs: np.ndarray) -> torch.Tensor:
    """The plain version on x's device: the GF(2) bit-matmul of ops/rs.py."""
    w = torch.from_numpy(rs_matrix.bit_expand(coeffs).astype(np.int8))
    return rs.gf_matmul(x, w)


def apply(x: torch.Tensor, coeffs, out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, K, S] u8 x [R, K] GF(2^8) coefficients -> [B, R, S] u8.

    ``out`` may be a [B, R, S] view with contiguous rows (for example the
    parity rows of an all-shards tensor), written in place."""
    coeffs = np.ascontiguousarray(np.asarray(coeffs, dtype=np.uint8))
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"x must be [B, K, S] uint8, got {tuple(x.shape)} {x.dtype}")
    b, k, s = x.shape
    if coeffs.ndim != 2 or coeffs.shape[1] != k:
        raise ValueError(f"coefficients must be [R, {k}], got {coeffs.shape}")
    r = coeffs.shape[0]
    if x.device.type == "cpu":
        res = plain(x, coeffs)
        if out is None:
            return res
        out.copy_(res)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.stride(2) != 1 or x.stride(1) != s:
        raise ValueError("x rows must be contiguous")
    if -(-r // 4) * k * 256 * 4 > _MAX_TABLE_BYTES:
        raise ValueError(f"[{r}, {k}] coefficients exceed the kernel's table budget")
    if max(k, r) * s > _MAX_ROWS_BYTES:
        raise ValueError(f"{max(k, r)} rows of {s} bytes exceed the kernel's 32-bit offsets")
    if out is None:
        out = torch.empty((b, r, s), dtype=torch.uint8, device=x.device)
    elif (
        out.shape != (b, r, s)
        or out.dtype != torch.uint8
        or out.device != x.device
        or out.stride(2) != 1
        or out.stride(1) != s
    ):
        raise ValueError("out must be a [B, R, S] uint8 tensor on x's device with contiguous rows")
    if b == 0 or r == 0 or s == 0:
        return out
    table = _device_table(coeffs, x.device)
    stream = torch.cuda.current_stream(x.device)
    # The cached table outlives any one stream's use of it: tell the
    # allocator, so an evicted table is not reused under a running kernel.
    table.record_stream(stream)
    # The launch queries the current device for its grid: make it x's.
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), x.stride(0), table.data_ptr(), out.data_ptr(), out.stride(0),
            b, k, r, s, stream.cuda_stream,
        )
    return out
