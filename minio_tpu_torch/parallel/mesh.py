"""Device mesh for the storage data plane.

Parallel axes (the reference's parallelism inventory, SURVEY.md section 2.4):
  * dp -- across block batches (independent uploads / heal scans), the
    analogue of object-level parallelism across erasure sets;
  * tp -- across shard streams (the reference writes K+M shards concurrently,
    cmd/erasure-encode.go:29-70: `parallelWriter`); bitrot hashing shards
    this axis;
  * sp -- across shard byte ranges (sequence/long-object parallelism): the
    erasure map is pointwise in the byte axis so it runs sp-sharded with no
    communication, and the encode->hash boundary is an all-to-all reshard
    (sp <-> streams), the storage equivalent of sequence-parallel attention
    re-gathering.

A `Mesh` is a (dp, tp, sp) grid of torch devices addressed by one process,
as the JAX package's single-controller mesh is (one process drives every
local device). The sp all-to-all is therefore tile copies between devices
(`dst.copy_(src, non_blocking=True)`, peer to peer where
`torch.cuda.can_device_access_peer` allows), not NCCL: NCCL's all_to_all
needs one process per card, another program structure, and nothing in the
reference runs across hosts.

A device may appear more than once in the grid: `[torch.device("cpu")] * 8`
in the tests and `[torch.device("cuda", 0)] * 8` on a one-card host are
virtual meshes, the counterpart of the JAX package's virtual device
platform. Each grid entry still holds its own tensors, runs its own kernel
launches and sends its own tiles of the all-to-all.

The JAX module's `shard_map_compat` has no counterpart here: it papers over
JAX versions, and the port writes the per-device program as a loop over
the grid (models/pipeline.py). Its PartitionSpecs become the index
functions below.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading

import torch

AXES = ("dp", "tp", "sp")


class Mesh:
    """A (dp, tp, sp) grid of torch devices; entry (d, t, s) is
    `devices[(d * tp + t) * sp + s]`."""

    def __init__(self, devices, shape: tuple[int, int, int]):
        devices = tuple(torch.device(d) for d in devices)
        if len(shape) != 3 or any(int(a) < 1 for a in shape):
            raise ValueError(f"mesh shape must be three positive sizes (dp, tp, sp), got {shape}")
        if math.prod(shape) != len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} needs {math.prod(shape)} devices, got {len(devices)}")
        types = {d.type for d in devices}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        self.devices = devices
        self.shape = dict(zip(AXES, (int(a) for a in shape)))
        self.size = len(devices)

    @property
    def type(self) -> str:
        return self.devices[0].type

    def coords(self):
        """Every (d, t, s) of the grid, in device order."""
        return itertools.product(*(range(self.shape[a]) for a in AXES))

    def device(self, coord: tuple[int, int, int]) -> torch.device:
        d, t, s = coord
        return self.devices[(d * self.shape["tp"] + t) * self.shape["sp"] + s]

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct_devices()]})"


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Split n devices into (dp, tp, sp), preferring dp >= tp >= sp."""
    best = (n, 1, 1)
    best_score = None
    for dp in range(1, n + 1):
        if n % dp:
            continue
        rest = n // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            sp = rest // tp
            # Prefer balanced meshes with dp the largest axis.
            score = (abs(math.log(max(dp, 1) / max(tp, 1))) + abs(math.log(max(tp, 1) / max(sp, 1))),)
            if dp >= tp >= sp and (best_score is None or score < best_score):
                best, best_score = (dp, tp, sp), score
    return best


def make_mesh(n_devices: int | None = None, shape: tuple[int, int, int] | None = None,
              devices=None) -> Mesh:
    """A mesh over the first n of `devices` (default: cuda:0..n-1, every card
    of this host), shaped `shape` (default factor_mesh(n)). `devices` may
    repeat one device for a virtual mesh."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    if not 0 < n <= len(devices):
        raise RuntimeError(f"a mesh of {n or 'any'} devices, given {len(devices)} (CUDA devices: "
                           f"{torch.cuda.device_count()})")
    return Mesh(devices[:n], shape if shape is not None else factor_mesh(n))


def mesh_shape_from_env(n: int) -> tuple[int, int, int] | None:
    """Parse MTPU_MESH_SHAPE for n devices.

    Accepted: "dp,tp,sp" (must multiply to n), "auto"/"" (factor_mesh),
    "off"/"0"/"1" (disable the codec mesh entirely -> None from
    codec_mesh). A malformed or mismatched value is factored automatically
    rather than refusing to serve.
    """
    raw = os.environ.get("MTPU_MESH_SHAPE", "").strip().lower()
    if raw in ("off", "0", "1"):
        return None
    if raw in ("", "auto"):
        return factor_mesh(n)
    try:
        parts = tuple(int(p) for p in raw.split(","))
    except ValueError:
        return factor_mesh(n)
    if len(parts) != 3 or any(p < 1 for p in parts):
        return factor_mesh(n)
    if parts[0] * parts[1] * parts[2] != n:
        return factor_mesh(n)
    return parts


_CODEC_MESH_LOCK = threading.Lock()
_codec_mesh_cache: list = []  # [Mesh | None] once resolved


def codec_mesh() -> Mesh | None:
    """The mesh BatchingDeviceCodec fans encode batches over: every card of
    this host, shaped by MTPU_MESH_SHAPE (default factor_mesh). None with
    one card or none, or when MTPU_MESH_SHAPE=off -- callers then run the
    single-device pipeline. Never a mesh of CPU devices. Cached: device
    enumeration and mesh construction happen once per process."""
    with _CODEC_MESH_LOCK:
        if not _codec_mesh_cache:
            n = torch.cuda.device_count()
            shape = mesh_shape_from_env(n) if n > 1 else None
            _codec_mesh_cache.append(make_mesh(n, shape) if shape else None)
        return _codec_mesh_cache[0]


# -- layouts: where each grid entry's piece of a global tensor lies -----------


def data_index(mesh: Mesh, coord, b: int, s: int) -> tuple[slice, slice, slice]:
    """[B, K, S] input blocks: batch over dp, bytes over sp, replicated over
    tp (the JAX package's P("dp", None, "sp")). Encoded shards leave the
    grid in the same layout, taken from the tp = 0 replica."""
    d, _, sp_i = coord
    bl, sl = b // mesh.shape["dp"], s // mesh.shape["sp"]
    return slice(d * bl, (d + 1) * bl), slice(None), slice(sp_i * sl, (sp_i + 1) * sl)


def digest_index(mesh: Mesh, coord, b: int, streams: int) -> tuple[slice, slice]:
    """[B, T, 32] digests: batch over dp, streams over sp then tp.

    sp is MAJOR on the stream axis because the encode->hash all-to-all
    (models/pipeline.py) deals stream blocks to sp peers first; each peer
    then slices its tp share locally (the JAX package's P("dp", ("sp", "tp"),
    None))."""
    d, t, sp_i = coord
    bl = b // mesh.shape["dp"]
    t_loc = streams // (mesh.shape["sp"] * mesh.shape["tp"])
    j = sp_i * mesh.shape["tp"] + t
    return slice(d * bl, (d + 1) * bl), slice(j * t_loc, (j + 1) * t_loc)


def place_data(x: torch.Tensor, mesh: Mesh) -> dict:
    """[B, K, S] -> {coord: its contiguous [B/dp, K, S/sp] block on its
    device}. A block is made contiguous before it moves: on a virtual mesh
    `.to(same device)` would hand back the strided view."""
    b, _, s = x.shape
    if b % mesh.shape["dp"] or s % mesh.shape["sp"]:
        raise ValueError(f"[{b}, _, {s}] blocks do not tile dp={mesh.shape['dp']}, sp={mesh.shape['sp']}")
    return {
        c: x[data_index(mesh, c, b, s)].contiguous().to(mesh.device(c), non_blocking=True)
        for c in mesh.coords()
    }


def gather_shards(pieces: dict, mesh: Mesh, out: torch.Tensor) -> torch.Tensor:
    """{coord: [B/dp, T, S/sp]} -> out [B, T, S], from the tp = 0 replicas."""
    b, _, s = out.shape
    for c, piece in pieces.items():
        if c[1] == 0:
            out[data_index(mesh, c, b, s)].copy_(piece, non_blocking=True)
    return out


def gather_digests(pieces: dict, mesh: Mesh, out: torch.Tensor) -> torch.Tensor:
    """{coord: [B/dp, T/(sp*tp), 32]} -> out [B, T, 32]."""
    b, t, _ = out.shape
    for c, piece in pieces.items():
        out[digest_index(mesh, c, b, t)].copy_(piece, non_blocking=True)
    return out


@contextlib.contextmanager
def use_streams(streams: dict | None):
    """Make `streams` ({device: torch.cuda.Stream}) the current stream of
    each of their devices. A cross-device `copy_` is ordered against the
    current stream of both devices, so a step over a multi-card mesh makes
    its own stream current on every card it touches; None (the CPU) does
    nothing."""
    with contextlib.ExitStack() as stack:
        for st in (streams or {}).values():
            stack.enter_context(torch.cuda.stream(st))
        yield
