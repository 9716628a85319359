"""The device program of the store: fused erasure-encode + bitrot-hash.

One step turns a batch of 1 MiB-block data shards into parity shards plus
per-shard HighwayHash-256 bitrot digests -- the device-side fusion of the
reference's per-request hot loop (cmd/erasure-encode.go:73-109 feeding
cmd/bitrot-streaming.go:43-65), batched across concurrent uploads. The
decode step reuses the RS kernel with reconstruction coefficients
(cmd/erasure-decode.go:206).

On ``device="cuda"`` every step runs the hand-written CUDA kernels
(ops/rs_cuda.py, ops/highwayhash_cuda.py); on ``device="cpu"`` it runs their
plain torch versions, because the caller asked for the CPU. There is no
selection between the two and no fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..control.sanitizer import san_lock
from ..ops import bitmatrix, highwayhash_cuda, rs_cuda, rs_matrix
from ..ops import fused as fused_ops


@dataclass(frozen=True)
class Geometry:
    """Erasure geometry: K data + M parity shards over a block size."""

    data: int
    parity: int
    block_size: int = 1 << 20  # blockSizeV2, cmd/object-api-common.go:40

    @property
    def total(self) -> int:
        return self.data + self.parity

    @property
    def shard_size(self) -> int:
        return rs_matrix.shard_size(self.block_size, self.data)


def resolve_device(device) -> torch.device:
    """The device a pipeline runs on; "cuda" without a card raises instead
    of moving to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_status(k: int = 12, m: int = 4) -> dict:
    """Which implementation serves each stage on each device, and the
    launch counts of the two kernels in this process. ``xor_schedule`` is
    the cost of the XOR schedule the TPU kernel ran for this geometry (for
    comparison; the CUDA kernel does not use it)."""
    return {
        "cuda": "rs: csrc/rs_gf.cu rs_gf_apply, hash: csrc/highwayhash.cu hh256",
        "cpu": "rs: ops/rs.py gf_matmul, hash: ops/highwayhash_torch.py hash256_batch",
        "launches": {
            "rs_gf_apply": rs_cuda.KERNEL.launches,
            "hh256": highwayhash_cuda.KERNEL.launches,
        },
        "xor_schedule": bitmatrix.schedule_stats(k, m),
    }


class ErasurePipeline:
    """Batched encode/decode steps for a fixed geometry on one device.

    Steps take shard batches shaped [B, K(+M), S] u8 (numpy arrays or
    tensors) and return tensors on the pipeline's device."""

    def __init__(self, geometry: Geometry, device="cuda"):
        self.geom = geometry
        self.device = resolve_device(device)
        self._parity = rs_matrix.parity_matrix(geometry.data, geometry.parity)
        self._encode_fn = fused_ops.make_step(geometry.data, geometry.parity)
        self._recon: dict[tuple, np.ndarray] = {}
        self._recon_lock = san_lock("ErasurePipeline._recon_lock")

    def _to_device(self, shards) -> torch.Tensor:
        if not isinstance(shards, torch.Tensor):
            arr = np.asarray(shards)
            # torch refuses to alias read-only memory (np.frombuffer views).
            shards = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        return shards.to(self.device, non_blocking=True)

    # -- encode ------------------------------------------------------------

    def encode(self, data_shards) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, K, S] -> ([B, K+M, S] shards, [B, K+M, 32] digests)."""
        return self._encode_fn(self._to_device(data_shards))

    def encode_parity(self, data_shards) -> torch.Tensor:
        """[B, K, S] -> [B, M, S] parity only, no digests.

        The small-object coalescing path pads the shard-BYTE axis to a
        bucketed length; GF(2^8) math is per byte position, so the parity
        prefix at the true length is bit-exact, but digests of padded rows
        would be wrong -- the caller hashes at true lengths.
        """
        return rs_cuda.apply(self._to_device(data_shards), self._parity)

    def encode_padded(self, data_shards, shard_lens: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, K, S_pad] data shards, block i filling its first shard_lens[i]
        bytes of each row -> ([B, K+M, S_pad] shards, [len(shard_lens), K+M,
        32] digests).

        The small-object path pads the shard-BYTE axis; GF(2^8) math is per
        byte position, so each block's parity prefix is exact whatever the
        padding holds. The digests are taken at each block's true length:
        the rows of the blocks that share a length are gathered into one
        contiguous [n * (K+M), s] tensor and hashed in one launch. Blocks
        past len(shard_lens) are batch padding and are not hashed."""
        x = self._to_device(data_shards)
        b, k, s_pad = x.shape
        t = k + self.geom.parity
        shards = torch.empty((b, t, s_pad), dtype=torch.uint8, device=x.device)
        shards[:, :k] = x
        rs_cuda.apply(shards[:, :k], self._parity, out=shards[:, k:])
        digests = torch.empty((len(shard_lens), t, 32), dtype=torch.uint8, device=x.device)
        by_len: dict[int, list[int]] = {}
        for i, s in enumerate(shard_lens):
            by_len.setdefault(s, []).append(i)
        for s, idx in by_len.items():
            ii = torch.tensor(idx, device=x.device)
            rows = shards[ii, :, :s].reshape(len(idx) * t, s).contiguous()
            digests[ii] = highwayhash_cuda.hash256_batch(rows).reshape(len(idx), t, 32)
        return shards, digests

    # -- decode ------------------------------------------------------------

    def reconstruct_coeffs(self, present: tuple[bool, ...], want: tuple[int, ...]) -> np.ndarray:
        """[len(want), K] GF coefficients for one loss pattern, cached."""
        key = (present, want)
        with self._recon_lock:
            c = self._recon.get(key)
        if c is None:
            c = rs_matrix.reconstruct_rows(self.geom.data, self.geom.parity, present, want)
            with self._recon_lock:
                if len(self._recon) >= 256:
                    self._recon.clear()
                self._recon[key] = c
        return c

    def reconstruct(
        self,
        survivors,
        present: tuple[bool, ...],
        want: tuple[int, ...],
        with_digests: bool = True,
    ):
        """[B, K, S] survivor shards (first K present rows, index order) ->
        [B, len(want), S] rebuilt shards + their digests (or None).

        Degraded GETs don't need digests of the rebuilt rows -- skipping the
        hash halves the device work on that path."""
        rebuilt = rs_cuda.apply(self._to_device(survivors), self.reconstruct_coeffs(present, want))
        if not with_digests:
            return rebuilt, None
        b, r, s = rebuilt.shape
        return rebuilt, highwayhash_cuda.hash256_batch(rebuilt.reshape(b * r, s)).reshape(b, r, 32)

    def verify_digests(self, shards) -> torch.Tensor:
        """[B, T, S] shards -> [B, T, 32] digests (bitrot verification)."""
        x = self._to_device(shards).contiguous()
        b, t, s = x.shape
        return highwayhash_cuda.hash256_batch(x.reshape(b * t, s)).reshape(b, t, 32)
