"""Kernel 2: batched HighwayHash-256, hand-written in CUDA.

``hash256_batch(data)`` maps [..., L] u8 equal-length streams to [..., 32] u8
bitrot digests. It replaces the TPU kernel
``minio_tpu/ops/highwayhash_pallas.py::_kernel`` (launched by ``_run_chain``)
together with the XLA epilogue that finished its hash: ``csrc/highwayhash.cu``
runs the packet chain, the tail packet, the permute rounds and the modular
reduction in one launch, with two threads per stream (one lane pair each)
and the rows staged through shared memory. Rows may start at any byte
address, so a contiguous view with a storage offset is hashed in place.

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version, ops/highwayhash_torch.py. A kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import highwayhash_torch
from .cuda_build import Kernel
from .highwayhash import MAGIC_KEY

KERNEL = Kernel(
    "hh256_launch",
    [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # N
        ctypes.c_longlong,  # L
        ctypes.c_uint64,  # key lane 0
        ctypes.c_uint64,  # key lane 1
        ctypes.c_uint64,  # key lane 2
        ctypes.c_uint64,  # key lane 3
        ctypes.c_void_p,  # stream
    ],
    error_symbol="hh256_error_string",
)

# The plain version runs about a dozen small torch operations per 32-byte
# packet, and each one hands the GIL back and forth: calls from many threads
# at once (the GET's parallel shard reads) slow each other down. One at a
# time is faster.
_PLAIN_LOCK = threading.Lock()


def hash256_batch(data: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HighwayHash-256 of equal-length streams: [..., L] u8 -> [..., 32] u8."""
    if data.dtype != torch.uint8 or data.dim() < 1:
        raise ValueError(f"data must be [..., L] uint8, got {tuple(data.shape)} {data.dtype}")
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    if data.device.type == "cpu":
        with _PLAIN_LOCK:
            return highwayhash_torch.hash256_batch(data, key)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    lead = data.shape[:-1]
    length = data.shape[-1]
    out = torch.empty((*lead, 32), dtype=torch.uint8, device=data.device)
    n = out.numel() // 32
    if n == 0:
        return out
    lanes = [int.from_bytes(key[8 * i : 8 * i + 8], "little") for i in range(4)]
    stream = torch.cuda.current_stream(data.device).cuda_stream
    # Launch under data's device, whichever device is current.
    with torch.cuda.device(data.device):
        KERNEL.launch(data.data_ptr(), out.data_ptr(), n, length, *lanes, stream)
    return out
