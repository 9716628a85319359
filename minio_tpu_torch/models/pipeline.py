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

With a mesh (parallel/mesh.py), the encode step runs on every entry of the
(dp, tp, sp) grid: the erasure map on each entry's [B/dp, K, S/sp] block
(pointwise in the byte axis, so no communication), then the encode->hash
boundary is an all-to-all over sp (tile copies between devices) plus a tp
slice of the streams, and each entry hashes its share of the rows. The
other steps stay on one device, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..control.sanitizer import san_lock
from ..ops import bitmatrix, highwayhash_cuda, rs_cuda, rs_matrix
from ..ops import fused as fused_ops
from ..parallel import mesh as mesh_lib


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
    """Batched encode/decode steps for a fixed geometry.

    Steps take shard batches shaped [B, K(+M), S] u8 (numpy arrays or
    tensors) and return tensors on the pipeline's device. `mesh` fans the
    encode step over a (dp, tp, sp) grid of devices of the pipeline's
    device type."""

    def __init__(self, geometry: Geometry, device="cuda", mesh=None):
        self.geom = geometry
        self.device = resolve_device(device)
        self.mesh = mesh
        self._parity = rs_matrix.parity_matrix(geometry.data, geometry.parity)
        self._encode_fn = fused_ops.make_step(geometry.data, geometry.parity)
        if mesh is not None:
            for dev in mesh.distinct_devices():
                resolve_device(dev)
            if mesh.type != self.device.type:
                raise ValueError(f"a {mesh.type} mesh under a pipeline on {self.device}")
            tp, sp = mesh.shape["tp"], mesh.shape["sp"]
            if geometry.total % (tp * sp):
                raise ValueError(
                    f"shard streams ({geometry.total}) must divide evenly over the "
                    f"tp x sp grid ({tp}x{sp}); uneven stream sharding would "
                    "silently drop digests"
                )
        self._recon: dict[tuple, np.ndarray] = {}
        self._recon_lock = san_lock("ErasurePipeline._recon_lock")

    @staticmethod
    def _tensor(shards) -> torch.Tensor:
        if isinstance(shards, torch.Tensor):
            return shards
        arr = np.asarray(shards)
        # torch refuses to alias read-only memory (np.frombuffer views).
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

    def _to_device(self, shards) -> torch.Tensor:
        return self._tensor(shards).to(self.device, non_blocking=True)

    # -- encode ------------------------------------------------------------

    def encode(self, data_shards) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, K, S] -> ([B, K+M, S] shards, [B, K+M, 32] digests).

        On a mesh the input (host or device) is placed block by block
        (mesh.place_data) and both outputs are gathered onto the pipeline's
        device."""
        if self.mesh is None:
            return self._encode_fn(self._to_device(data_shards))
        x = self._tensor(data_shards)
        b, _, s = x.shape
        t = self.geom.total
        pieces = self.encode_blocks(mesh_lib.place_data(x, self.mesh))
        shards = torch.empty((b, t, s), dtype=torch.uint8, device=self.device)
        digests = torch.empty((b, t, 32), dtype=torch.uint8, device=self.device)
        mesh_lib.gather_shards({c: p[0] for c, p in pieces.items()}, self.mesh, shards)
        mesh_lib.gather_digests({c: p[1] for c, p in pieces.items()}, self.mesh, digests)
        return shards, digests

    def encode_blocks(self, blocks: dict) -> dict:
        """The mesh's encode step: {coord: [B/dp, K, S/sp] block on its
        device} -> {coord: ([B/dp, K+M, S/sp] shards, [B/dp, t_loc, 32]
        digests of its t_loc = (K+M)/(sp*tp) streams)}.

        Every grid entry runs the body, so a step launches each kernel
        dp*tp*sp times: (1) the RS kernel into the parity rows of its
        all-shards block; (2) the all-to-all over sp: entry (d, t, s) takes
        stream block s of every sp peer's all-shards block and lays the
        blocks side by side on the byte axis in peer order, giving
        [B/dp, (K+M)/sp, S]; (3) its tp slice of those streams, rows
        t*t_loc..(t+1)*t_loc, made contiguous; (4) the hash kernel on them.

        Each device's work goes on its current stream. Before the
        all-to-all, a receiving device's stream waits on an event that each
        other device recorded after its RS launches; so a caller that makes
        one stream current on every card (mesh.use_streams) and records its
        completion events on those streams covers the whole step."""
        mesh = self.mesh
        k, t_all = self.geom.data, self.geom.total
        tp, sp = mesh.shape["tp"], mesh.shape["sp"]
        per_sp = t_all // sp
        t_loc = per_sp // tp
        local = {}
        for c, x in blocks.items():
            b, kk, s_loc = x.shape
            if kk != k:
                raise ValueError(f"expected {k} data shards, got {kk}")
            a = torch.empty((b, t_all, s_loc), dtype=torch.uint8, device=x.device)
            a[:, :k] = x
            rs_cuda.apply(a[:, :k], self._parity, out=a[:, k:])
            local[c] = a
        ready = {}
        if mesh.type == "cuda" and len(mesh.distinct_devices()) > 1:
            for dev in mesh.distinct_devices():
                ready[dev] = torch.cuda.Event()
                ready[dev].record(torch.cuda.current_stream(dev))
        out = {}
        for (d, t, s), a in local.items():
            b, _, s_loc = a.shape
            recv = torch.empty((b, per_sp, s_loc * sp), dtype=torch.uint8, device=a.device)
            for peer in range(sp):
                src = local[(d, t, peer)]
                if src.device != a.device:
                    torch.cuda.current_stream(a.device).wait_event(ready[src.device])
                recv[:, :, peer * s_loc:(peer + 1) * s_loc].copy_(
                    src[:, s * per_sp:(s + 1) * per_sp], non_blocking=True)
            rows = recv[:, t * t_loc:(t + 1) * t_loc].contiguous()
            digests = highwayhash_cuda.hash256_batch(rows.reshape(b * t_loc, s_loc * sp))
            out[(d, t, s)] = (a, digests.reshape(b, t_loc, 32))
        return out

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
