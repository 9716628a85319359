"""Smoke run of minio_tpu_torch on one NVIDIA GPU (an H100: sm_90a kernels).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. GPU and build: prints the card's name and power limit and builds the
   package's CUDA kernels from minio_tpu_torch/csrc/ (with
   torch.utils.cpp_extension.load: one nvcc per source, in parallel) into
   minio_tpu_torch/_build/.
2. Kernels against their plain torch versions on the card, at the shapes the
   PUT/GET path gives them: the Reed-Solomon kernel at [64, 12, 87382] for
   encode and a 4-row reconstruct, on the fused encode's layout (data and
   parity rows of one all-shards tensor) at B = 1, 16 and 64, at R = 1..4
   rows and at S in {1, 3, 15, 16, 17, 4095, 4096, 87381, 87382}, and on
   input and output rows whose base lies 1..15 bytes past a 16-byte
   boundary; the HighwayHash kernel at N = 1, 16 (the GET verify batch), 17
   and 1,024 (the 64-block encode batch) streams at every tail length, and
   on rows whose base lies 1..15 bytes past a 16-byte boundary. Bytes must
   be equal (tolerance: exact). Times come from CUDA events, each launch on
   rows not in the L2 cache: the RS kernel at [64, 12, 87382] contiguous,
   on the encode view at B = 16 and 64 and a 4-row reconstruct at B = 16,
   each with its bytes bound; the hash at [16, 87382], [64, 87382] (heal's
   verify batch and its rebuilt-row hash, 16 blocks x 4 rows) and
   [1024, 87382].
3. The slice: one 16-drive 12+4 erasure set under a temp dir, driven through
   ErasureObjects with BatchingDeviceCodec(max_batch=64): PUT one 128 MiB
   object, then 8 concurrent 16 MiB objects; GET each back byte-exact;
   remove the part files of 4 drives and GET each again (degraded read
   through the reconstruct kernel). Kernel launch counts are reset just
   before this phase and read just after; each kernel must have launched.
   The hash kernel's launches are also tallied by their N, the RS kernel's
   by their (B, R).
   A small object is also PUT through a numpy HostCodec stack and its part
   files must equal the device stack's byte for byte.
4. The rest of the erasure set, on the same set and codec, each path with
   the launch counts reset just before it and read just after (each kernel
   must have launched in each):
   - heal: the part files phase 3 removed were kept; heal_object rebuilds
     them for all 9 objects (4 drives each, byte-identical to the removed
     files, xl.meta erasure fields unchanged), through reconstruct_batch(...,
     with_digests=True): the RS kernel at (B, R) = (16, 4), then the hash
     kernel on the rebuilt rows at N = 64, with no window on the host codec;
     then one flipped byte in a healthy row of the big object heals
     (1 drive). A GET of every object is then byte-exact with the part
     files of 4 other drives removed;
   - multipart: four 8 MiB parts from 4 threads and a last part of
     1 MiB + 37 B, completed (ETag "-5", GET byte-exact); the same upload on
     a numpy HostCodec set must leave byte-identical part.N files; an
     aborted upload leaves list_multipart_uploads;
   - the legacy whole-file bitrot layout: a sha256 PUT of 3 MiB + 37 B (its
     RS encode on the card), a GET, and a heal of one lost row.
   Besides, once each and with no kernel: put_object_metadata, a versioned
   delete marker (GET: not found), a physical delete, list_buckets,
   delete_bucket (a non-empty bucket refuses), and transition_object then
   the metadata-only heal of the transitioned version.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate
INT32_ALU_OPS_PER_S = 67e12  # taken as the fp32 non-tensor rate: no published int64 rate

K, M, DRIVES = 12, 4, 16
S_FULL = -(-(1 << 20) // K)  # 87,382: the shard chunk of a 1 MiB block
MiB = 1 << 20


def log(*args) -> None:
    print(*args, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item()) if a.numel() else 0


def phase_gpu_and_build():
    from minio_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    lib = cuda_build.build_all()
    log(f"build: {len(cuda_build.sources())} kernel sources -> {lib.name} in {time.perf_counter() - t0:.3f} s")
    return smi


def phase_kernels(dev: torch.device) -> dict:
    from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_matrix
    from minio_tpu_torch.tools.rs_probe import graph_ms

    gen = torch.Generator(device="cpu").manual_seed(1234)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).to(dev)

    # -- kernel 1: RS GF(2^8) map ------------------------------------------
    parity = rs_matrix.parity_matrix(K, M)
    lost = (0, 5, 12, 15)
    present = tuple(i not in lost for i in range(K + M))
    recs = {r: rs_matrix.reconstruct_rows(K, M, present, (0, 5, 12, 15)[:r]) for r in (1, 2, 3, 4)}

    def rs_err(x, coeffs, out=None) -> int:
        got = rs_cuda.apply(x, coeffs, out=out)
        return max_abs_err(got, rs_cuda.plain(x, coeffs))

    x = rand((64, K, S_FULL))
    err = rs_err(x, parity)
    surv = rand((64, K, S_FULL))
    err = max(err, rs_err(surv, recs[4]))
    # The fused encode's layout: data rows and parity rows of one all-shards
    # tensor (batch stride (K+M)*S, parity rows at (K+r)*S).
    for b in (1, 16, 64):
        shards = rand((b, K + M, S_FULL))
        err = max(err, rs_err(shards[:, :K], parity, out=shards[:, K:]))
    rs_lengths = (1, 3, 15, 16, 17, 4095, 4096, 87_381, S_FULL)
    for s in rs_lengths:
        for r, coeffs in recs.items():
            err = max(err, rs_err(rand((3, K, s)), coeffs))
        err = max(err, rs_err(rand((3, K, s)), parity))
        # Rows 1..15 bytes past a 16-byte boundary, in and out: views into
        # flat buffers, one R in 1..4 per offset.
        xbuf, obuf = rand((16 + 2 * K * s,)), rand((16 + 2 * M * s,))
        for off in range(1, 16):
            r = 1 + off % 4
            coeffs = parity if r == M else recs[r]
            o = (7 * off + 3) % 16
            xv = xbuf[off : off + 2 * K * s].view(2, K, s)
            ov = obuf[o : o + 2 * r * s].view(2, r, s)
            err = max(err, rs_err(xv, coeffs, out=ov))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"rs_gf_apply disagrees with its plain version: max abs err {err}")
    log(f"rs_gf_apply equals its plain version: [64,{K},{S_FULL}] encode and 4-row reconstruct, the fused "
        f"layout at B in (1, 16, 64), R in 1..4 at S in {rs_lengths}, base offsets 1..15 in and out")

    def rs_bound(b: int, r: int) -> tuple[float, str]:
        nbytes = b * (K + r) * S_FULL
        ops = 2 * b * S_FULL * (K * 8) * (r * 8)  # the bit-matmul's MACs x 2
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def rs_cold_ms(b: int, r: int, layout: str) -> float:
        # Rotate over copies that together exceed the 50 MB L2, so each
        # launch reads rows that are not in the cache.
        copies = max(2, -(-64 * MiB // (b * (K + M) * S_FULL)))
        coeffs = parity if layout != "reconstruct" else recs[r]
        if layout == "encode view":
            bufs = [rand((b, K + M, S_FULL)) for _ in range(copies)]
            calls = [(t[:, :K], t[:, K:]) for t in bufs]
        else:
            calls = [(rand((b, K, S_FULL)), torch.empty((b, r, S_FULL), dtype=torch.uint8, device=dev))
                     for _ in range(copies)]
        # Device time from a CUDA graph of the launches: at B = 16 the wrapper's
        # host time per call is not far below the kernel's.
        return graph_ms([lambda xi=xi, oi=oi: rs_cuda.apply(xi, coeffs, out=oi) for xi, oi in calls], 10)

    rs_shapes = []
    for b, r, layout in ((64, M, "contiguous"), (16, M, "encode view"), (64, M, "encode view"),
                         (16, 4, "reconstruct")):
        ms = rs_cold_ms(b, r, layout)
        bound_ms, bound_by = rs_bound(b, r)
        rs_shapes.append({"shape": [b, K, S_FULL], "rows": r, "layout": layout, "ms": ms,
                          "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"kernel rs_gf_apply: [{b},{K},{S_FULL}] -> {r} rows, {layout}: {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms, {bound_by})")
    rs_ms = rs_shapes[0]["ms"]
    rs_plain_ms = cuda_time_ms(lambda: rs_cuda.plain(x, parity), 2)
    # Library yardstick: one torch matmul doing the same GF(2) product on
    # pre-unpacked bits in fp16 (sums <= 96 are exact), not used by the port.
    bits = torch.randint(0, 2, (64 * S_FULL, K * 8), generator=gen).to(dev, torch.float16)
    w = torch.from_numpy(rs_matrix.bit_expand(parity).astype(np.float16)).to(dev)
    rs_lib_ms = cuda_time_ms(lambda: bits @ w, 20)
    del bits
    rs_bound_ms, rs_bound_by = rs_bound(64, M)
    log(f"kernel rs_gf_apply ok: [64,{K},{S_FULL}] encode {rs_ms:.4f} ms "
        f"(plain {rs_plain_ms:.2f} ms, torch fp16 bit-matmul {rs_lib_ms:.4f} ms, bound {rs_bound_ms:.4f} ms)")

    # -- kernel 2: HighwayHash-256 -----------------------------------------
    def hash_err(x: torch.Tensor) -> int:
        return max_abs_err(highwayhash_cuda.hash256_batch(x), highwayhash_torch.hash256_batch(x))

    def plain_timed(x: torch.Tensor) -> tuple[torch.Tensor, float]:
        t0 = time.perf_counter()
        want = highwayhash_torch.hash256_batch(x)
        torch.cuda.synchronize()
        return want, (time.perf_counter() - t0) * 1e3

    lengths = (0, 1, 3, 4, 15, 16, 22, 31, 32, 33, 255, 256, 4096, S_FULL)
    h, h16 = rand((1024, S_FULL)), rand((16, S_FULL))
    want_h, hh_plain_ms = plain_timed(h)
    want_h16, hh_plain_ms_n16 = plain_timed(h16)
    herr = max(max_abs_err(highwayhash_cuda.hash256_batch(h), want_h),
               max_abs_err(highwayhash_cuda.hash256_batch(h16), want_h16))
    for n in (1, 16, 17, 1024):
        for length in lengths:
            if length != S_FULL or n not in (16, 1024):
                herr = max(herr, hash_err(rand((n, length))))
    # Rows whose base lies off a 16-byte boundary: views into one flat buffer.
    offsets = range(1, 16)
    for length in lengths:
        buf = rand((16 + 17 * length,))
        views = [buf[off : off + 17 * length].view(17, length) for off in offsets]
        got = torch.cat([highwayhash_cuda.hash256_batch(v) for v in views])
        herr = max(herr, max_abs_err(got, highwayhash_torch.hash256_batch(torch.cat(views))))
    torch.cuda.synchronize()
    if herr:
        raise AssertionError(f"hh256 disagrees with its plain version: max abs err {herr}")
    log(f"hh256 equals its plain version at N in (1, 16, 17, 1024) x {len(lengths)} lengths "
        f"and at base offsets {offsets.start}..{offsets.stop - 1}")
    # [1024, 87382] is 89 MB, more than the 50 MB L2, so each launch reads
    # cold rows; the verify shape rotates over 48 batches (67 MB) for the same.
    hh_ms = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(h), 10)
    verify = rand((48, 16, S_FULL))
    turn = itertools.cycle(range(48))
    hh_ms_n16 = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(verify[next(turn)]), 96)
    # Heal's shape: 64 streams (a 16-block window's 4 rebuilt rows, and a
    # verify batch), over 12 batches (67 MB) for cold rows.
    heal = verify.view(12, 64, S_FULL)
    turn = itertools.cycle(range(12))
    hh_ms_n64 = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(heal[next(turn)]), 24)
    del verify, heal

    def hh_bound(n: int) -> tuple[float, str]:
        nbytes = n * S_FULL + n * 32
        # Per 32-byte packet and lane: 3 adds, 2 multiplies, 2 masks, 2
        # shifts, 2 xors, plus ~24 zipper shift/mask/or ops per lane pair:
        # ~60 ops.
        ops = n * (S_FULL // 32 + 11) * 4 * 60
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_ALU_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    hh_bound_ms, hh_bound_by = hh_bound(1024)
    hh_bound_ms_n16, _ = hh_bound(16)
    hh_bound_ms_n64, _ = hh_bound(64)
    log(f"kernel hh256 ok: [1024,{S_FULL}] {hh_ms:.4f} ms (plain {hh_plain_ms:.1f} ms, bound {hh_bound_ms:.4f} ms); "
        f"[16,{S_FULL}] {hh_ms_n16:.4f} ms (plain {hh_plain_ms_n16:.1f} ms, bound {hh_bound_ms_n16:.6f} ms); "
        f"[64,{S_FULL}] {hh_ms_n64:.4f} ms (bound {hh_bound_ms_n64:.6f} ms)")
    return {
        "rs_gf_apply": {
            "name": "rs_gf_apply", "route": "cuda", "source": "minio_tpu_torch/csrc/rs_gf.cu",
            "replaces": "minio_tpu/ops/rs_pallas.py:72", "max_abs_err": err,
            "ms": rs_ms, "plain_ms": rs_plain_ms, "bound_ms": rs_bound_ms,
            "bound_by": rs_bound_by, "library_ms": rs_lib_ms, "shape": [64, K, S_FULL],
            "shapes": rs_shapes,
        },
        "hh256": {
            "name": "hh256", "route": "cuda", "source": "minio_tpu_torch/csrc/highwayhash.cu",
            "replaces": "minio_tpu/ops/highwayhash_pallas.py:92", "max_abs_err": herr,
            "ms": hh_ms, "plain_ms": hh_plain_ms, "bound_ms": hh_bound_ms,
            "bound_by": hh_bound_by, "library_ms": None, "shape": [1024, S_FULL],
            "ms_n16": hh_ms_n16, "plain_ms_n16": hh_plain_ms_n16, "bound_ms_n16": hh_bound_ms_n16,
            "ms_n64": hh_ms_n64, "bound_ms_n64": hh_bound_ms_n64,
        },
    }


def _make_set(root: str, codec):
    from minio_tpu_torch.object.erasure import ErasureObjects
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    drives = []
    for i, f in enumerate(fmt.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    eo = ErasureObjects(drives, parity=M, codec=codec)
    eo.make_bucket("bench")
    return eo, drives


def _data_dir(drive, key: str) -> str:
    obj = os.path.join(drive.root, "bench", key)
    return os.path.join(obj, next(n for n in os.listdir(obj) if n != "xl.meta"))


def _part_path(drive, key: str, part: int = 1) -> str:
    return os.path.join(_data_dir(drive, key), f"part.{part}")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _part_files(drives, key: str) -> list[bytes]:
    return [_read(_part_path(d, key)) for d in drives]


class Tally:
    """Counts each kernel's launches by shape beside the wrappers' own
    counts: the hash kernel's by N (its third argument), the RS kernel's by
    (B, R) (its sixth and eighth). reset() zeroes every count just before a
    path; read() reads them just after."""

    def __init__(self):
        from minio_tpu_torch.ops import highwayhash_cuda, rs_cuda

        self.kernels = {"rs_gf_apply": rs_cuda.KERNEL, "hh256": highwayhash_cuda.KERNEL}
        self.hh_by_n: collections.Counter = collections.Counter()
        self.rs_by_br: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        hh_launch = highwayhash_cuda.KERNEL.launch
        rs_launch = rs_cuda.KERNEL.launch

        def hh_launch_tallied(*args):
            hh_launch(*args)
            with self._lock:
                self.hh_by_n[args[2]] += 1

        def rs_launch_tallied(*args):
            rs_launch(*args)
            with self._lock:
                self.rs_by_br[(args[5], args[7])] += 1

        highwayhash_cuda.KERNEL.launch = hh_launch_tallied
        rs_cuda.KERNEL.launch = rs_launch_tallied

    def reset(self) -> None:
        with self._lock:
            for k in self.kernels.values():
                k.launches = 0
            self.hh_by_n.clear()
            self.rs_by_br.clear()

    def read(self, path: str) -> dict:
        """The counts of one path; raises if a kernel did not launch in it."""
        with self._lock:
            out = {
                "launches": {name: k.launches for name, k in self.kernels.items()},
                "hh256_by_n": dict(sorted(self.hh_by_n.items())),
                "rs_gf_apply_by_b_r": dict(sorted(self.rs_by_br.items())),
            }
        for name, n in out["launches"].items():
            if n == 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
        log(f"{path}: launches {json.dumps(out['launches'])}; hh256 by N "
            f"{json.dumps(out['hh256_by_n'])}; rs_gf_apply by (B, R) "
            f"{json.dumps({f'B={b},R={r}': c for (b, r), c in out['rs_gf_apply_by_b_r'].items()})}")
        return out

    def uninstall(self) -> None:
        for k in self.kernels.values():
            k.__dict__.pop("launch", None)


def phase_slice(dev, smi: str, root: str, codec, tally: Tally, big_mib: int = 128, small_mib: int = 16):
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    rng = np.random.default_rng(20)
    big = rng.integers(0, 256, big_mib * MiB, dtype=np.uint8).tobytes()
    smalls = [rng.integers(0, 256, small_mib * MiB, dtype=np.uint8).tobytes() for _ in range(8)]
    payloads = {"big": big, **{f"small{i}": smalls[i] for i in range(8)}}
    eo, drives = _make_set(os.path.join(root, "gpu"), codec)
    tally.reset()

    t0 = time.perf_counter()
    eo.put_object("bench", "big", big)
    put_big = time.perf_counter() - t0
    put_big_launches = (tally.kernels["rs_gf_apply"].launches, tally.kernels["hh256"].launches)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: eo.put_object("bench", f"small{i}", smalls[i]), range(8)))
    put_small = time.perf_counter() - t0

    def get_all():
        t = time.perf_counter()
        if eo.get_object("bench", "big")[1] != big:
            raise AssertionError("GET big: bytes differ")
        t_big = time.perf_counter() - t
        t = time.perf_counter()
        with cf.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda i: eo.get_object("bench", f"small{i}")[1], range(8)))
        if got != smalls:
            raise AssertionError("GET small: bytes differ")
        return t_big, time.perf_counter() - t

    get_big, get_small = get_all()
    # Lose the part files of 4 drives (their xl.meta stays): which shard
    # rows those drives hold varies per object, so some objects lose
    # data rows and their GETs rebuild them with the reconstruct kernel.
    # Their bytes are kept for phase 4's heal.
    lost = {}
    for key in payloads:
        for i in LOST:
            path = _part_path(drives[i], key)
            lost[(key, i)] = _read(path)
            os.remove(path)
    dget_big, dget_small = get_all()
    counts = tally.read("PUT/GET/degraded GET")
    st = codec.stats()
    if not (st["batches_run"] > 0 and st["recon_batches_run"] > 0 and st["digests_verified"] > 0):
        raise AssertionError(f"device counters did not move: {st}")
    if st["host_fallback_blocks"] != 0:
        raise AssertionError(f"full blocks went to the host codec: {st}")
    gib_big, gib_small = big_mib / 1024, 8 * small_mib / 1024
    log(f"slice stats: {json.dumps(st)}")
    log(f"launches during the {big_mib} MiB PUT: rs_gf_apply {put_big_launches[0]}, "
        f"hh256 {put_big_launches[1]}")
    log(f"PUT {big_mib} MiB: {gib_big / put_big:.3f} GiB/s; "
        f"PUT 8x{small_mib} MiB concurrent: {gib_small / put_small:.3f} GiB/s [{smi}]")
    log(f"GET {big_mib} MiB: {gib_big / get_big:.3f} GiB/s; "
        f"GET 8x{small_mib} MiB concurrent: {gib_small / get_small:.3f} GiB/s [{smi}]")
    log(f"degraded GET (part files of 4 drives lost) {big_mib} MiB: {gib_big / dget_big:.3f} GiB/s; "
        f"8x{small_mib} MiB concurrent: {gib_small / dget_small:.3f} GiB/s [{smi}]")

    # Reference check: the same small object through a numpy HostCodec stack
    # must leave byte-identical part files on every drive.
    obj = rng.integers(0, 256, 3 * MiB + 37, dtype=np.uint8).tobytes()
    codec2 = BatchingDeviceCodec(max_batch=64, device=dev)
    try:
        eo_dev, drives_dev = _make_set(os.path.join(root, "ref-gpu"), codec2)
        eo_host, drives_host = _make_set(os.path.join(root, "ref-host"), HostCodec())
        eo_dev.put_object("bench", "ref", obj)
        eo_host.put_object("bench", "ref", obj)
        if _part_files(drives_dev, "ref") != _part_files(drives_host, "ref"):
            raise AssertionError("device and host codecs wrote different part files")
        if eo_dev.get_object("bench", "ref")[1] != obj:
            raise AssertionError("GET ref: bytes differ")
    finally:
        codec2.close()
    log("reference check ok: 16 part files byte-identical to the numpy host codec")
    return eo, drives, payloads, lost, counts


LOST = (3, 7, 11, 15)  # the drives whose part files phase 3 removes
OTHERS = (0, 4, 8, 12)  # removed after the heal, for a degraded GET


def _erasure_fields(fi) -> tuple:
    e = fi.erasure
    return (e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
            [dict(c) for c in e.checksums], [(p.number, p.size) for p in fi.parts], fi.size)


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is what is checked
        return type(e).__name__
    return "no error"


def phase_heal(smi: str, eo, drives, codec, tally: Tally, payloads: dict, lost: dict) -> dict:
    """Heal every object of phase 3, then a flipped byte, then a degraded
    GET of the healed set."""
    before = codec.stats()
    fields = {key: [_erasure_fields(d.read_version("bench", key)) for d in drives] for key in payloads}
    tally.reset()
    t0 = time.perf_counter()
    for key in payloads:
        res = eo.heal_object("bench", key)
        if res.disks_healed != len(LOST) or [
            i for i, s in enumerate(res.after_drive_state) if s == "healed"
        ] != list(LOST):
            raise AssertionError(f"heal {key}: {res}")
    heal_s = time.perf_counter() - t0
    counts = tally.read("heal")
    after = codec.stats()
    for key in payloads:
        for i in LOST:
            if _read(_part_path(drives[i], key)) != lost[(key, i)]:
                raise AssertionError(f"heal {key}: drive {i}'s part file differs from the removed one")
        if [_erasure_fields(d.read_version("bench", key)) for d in drives] != fields[key]:
            raise AssertionError(f"heal {key}: xl.meta erasure fields changed")
    moved = {k: after[k] - before[k] for k in
             ("recon_batches_run", "blocks_reconstructed", "digests_verified", "host_fallback_recon_blocks",
              "verify_batches_run", "device_recon_seconds", "device_verify_seconds")}
    if moved["recon_batches_run"] <= 0 or moved["digests_verified"] <= 0:
        raise AssertionError(f"heal: device counters did not move: {moved}")
    if moved["host_fallback_recon_blocks"] != 0:
        raise AssertionError(f"heal: windows went to the host codec: {moved}")
    windows = sum(-(-len(p) // MiB // 16) for p in payloads.values())
    if counts["rs_gf_apply_by_b_r"].get((16, len(LOST)), 0) != windows:
        raise AssertionError(f"heal: expected {windows} reconstructs at (16, 4): {counts}")
    if counts["hh256_by_n"].get(16 * len(LOST), 0) < windows:
        raise AssertionError(f"heal: expected >= {windows} rebuilt-row hashes at N = 64: {counts}")
    nbytes = sum(len(p) for p in payloads.values())
    log(f"heal stats moved: {json.dumps(moved)}")
    log(f"heal of {len(payloads)} objects ({nbytes / MiB:.0f} MiB, 4 lost drives each): "
        f"{nbytes / 2**30 / heal_s:.3f} GiB/s [{smi}]")

    # One flipped byte in a healthy row of the big object.
    path = _part_path(drives[1], "big")
    good = _read(path)
    with open(path, "r+b") as f:
        f.seek(2 * (S_FULL + 32) + 32 + 999)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x3C]))
    tally.reset()
    res = eo.heal_object("bench", "big")
    counts_flip = tally.read("heal of a flipped byte")
    if res.disks_healed != 1 or res.after_drive_state[1] != "healed" or _read(path) != good:
        raise AssertionError(f"heal of a flipped byte: {res}")
    log("heal of one flipped byte ok: 1 drive healed, the file restored")

    # The healed set serves a GET with the part files of 4 other drives gone.
    for key in payloads:
        for i in OTHERS:
            os.remove(_part_path(drives[i], key))
    for key, data in payloads.items():
        if eo.get_object("bench", key)[1] != data:
            raise AssertionError(f"GET {key} after heal: bytes differ")
    log(f"GET of all {len(payloads)} healed objects byte-exact with drives {OTHERS} removed")
    return {"heal": counts, "heal_flipped_byte": counts_flip}


def phase_multipart(smi: str, root: str, eo, codec, tally: Tally, part_mib: int = 8) -> dict:
    from minio_tpu_torch.object.codec import HostCodec

    rng = np.random.default_rng(21)
    parts = [rng.integers(0, 256, part_mib * MiB, dtype=np.uint8).tobytes() for _ in range(4)]
    parts.append(rng.integers(0, 256, MiB + 37, dtype=np.uint8).tobytes())
    data = b"".join(parts)

    def upload(target) -> tuple:
        mp = target.multipart
        uid = mp.new_multipart_upload("bench", "mp")
        with cf.ThreadPoolExecutor(4) as ex:
            infos = list(ex.map(lambda n: mp.put_object_part("bench", "mp", uid, n, parts[n - 1]), range(1, 5)))
        infos.append(mp.put_object_part("bench", "mp", uid, 5, parts[4]))
        return mp.complete_multipart_upload("bench", "mp", uid, [(p.number, p.etag) for p in infos])

    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    oi = upload(eo)
    mp_s = time.perf_counter() - t0
    counts = tally.read("multipart")
    after = codec.stats()
    log("multipart stats moved: " + json.dumps({k: after[k] - before[k] for k in (
        "batches_run", "blocks_encoded", "blocks_padded", "host_fallback_blocks", "device_encode_seconds")}))
    if not oi.etag.endswith("-5") or oi.size != len(data):
        raise AssertionError(f"multipart: {oi}")
    if eo.get_object("bench", "mp")[1] != data:
        raise AssertionError("multipart GET: bytes differ")
    log(f"multipart PUT ({len(parts)} parts, {len(data) / MiB:.2f} MiB, 4 parts from 4 threads): "
        f"{len(data) / 2**30 / mp_s:.3f} GiB/s [{smi}]")
    # The same upload through a numpy HostCodec set: same part.N files.
    eo_host, drives_host = _make_set(os.path.join(root, "mp-host"), HostCodec())
    oi_host = upload(eo_host)
    if oi_host.etag != oi.etag:
        raise AssertionError(f"multipart: ETag {oi.etag} differs from the host codec's {oi_host.etag}")
    for i, (d, h) in enumerate(zip(eo.disks, drives_host)):
        for n in range(1, 6):
            if _read(_part_path(d, "mp", n)) != _read(_part_path(h, "mp", n)):
                raise AssertionError(f"multipart: drive {i} part.{n} differs from the host codec's")
    # An aborted upload leaves the listing.
    uid = eo.multipart.new_multipart_upload("bench", "mp-aborted")
    eo.multipart.put_object_part("bench", "mp-aborted", uid, 1, parts[4])
    listed = [u["upload_id"] for u in eo.multipart.list_multipart_uploads("bench")]
    eo.multipart.abort_multipart_upload("bench", "mp-aborted", uid)
    if uid not in listed or uid in [u["upload_id"] for u in eo.multipart.list_multipart_uploads("bench")]:
        raise AssertionError("multipart: the aborted upload is still listed")
    log("multipart ok: ETag -5, GET byte-exact, 80 part files byte-identical to the numpy host codec, "
        "abort leaves the listing")
    return {"multipart": counts}


def phase_object_ops(eo, drives) -> None:
    """The operations that run no kernel, once each."""
    from minio_tpu_torch.control import tiering
    from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions

    eo.put_object_metadata("bench", "small0", updates={"x-amz-meta-color": "blue"})
    if eo.get_object_info("bench", "small0").user_defined.get("x-amz-meta-color") != "blue":
        raise AssertionError("put_object_metadata: not applied")
    eo.put_object("bench", "versioned", b"v" * 300_000, PutObjectOptions(versioned=True))
    marker = eo.delete_object("bench", "versioned", DeleteObjectOptions(versioned=True))
    if not marker.delete_marker or _raised(lambda: eo.get_object("bench", "versioned")) != "ObjectNotFound":
        raise AssertionError("delete marker: the object still reads")
    eo.delete_object("bench", "small7")
    if _raised(lambda: eo.get_object("bench", "small7")) != "ObjectNotFound":
        raise AssertionError("physical delete: the object still reads")
    eo.make_bucket("empty")
    if [b.name for b in eo.list_buckets()] != ["bench", "empty"]:
        raise AssertionError(f"list_buckets: {eo.list_buckets()}")
    if _raised(lambda: eo.delete_bucket("bench")) != "BucketNotEmpty":
        raise AssertionError("delete_bucket: a non-empty bucket was not refused")
    eo.delete_bucket("empty")
    if [b.name for b in eo.list_buckets()] != ["bench"]:
        raise AssertionError("delete_bucket: the empty bucket is still listed")
    eo.transition_object("bench", "small6", "", "WARM", "remote/small6")
    for i in (2, 9):
        shutil.rmtree(os.path.join(drives[i].root, "bench", "small6"))
    res = eo.heal_object("bench", "small6")
    meta = drives[9].read_version("bench", "small6").metadata
    if res.disks_healed != 2 or meta.get(tiering.META_TRANSITION_STATUS) != tiering.STATUS_COMPLETE:
        raise AssertionError(f"heal of a transitioned version: {res}")
    log("put_object_metadata, delete marker, physical delete, list_buckets, delete_bucket, "
        "transition_object + metadata heal ok")


def phase_whole_file(eo, drives, tally: Tally) -> dict:
    from minio_tpu_torch.object.types import PutObjectOptions

    data = np.random.default_rng(22).integers(0, 256, 3 * MiB + 37, dtype=np.uint8).tobytes()
    tally.reset()
    eo.put_object("bench", "whole", data, PutObjectOptions(bitrot_algorithm="sha256"))
    counts = tally.read("whole-file PUT")
    if eo.get_object("bench", "whole")[1] != data:
        raise AssertionError("whole-file GET: bytes differ")
    path = _part_path(drives[5], "whole")
    good = _read(path)
    os.remove(path)
    res = eo.heal_object("bench", "whole")
    if res.disks_healed != 1 or _read(path) != good:
        raise AssertionError(f"whole-file heal: {res}")
    sums = drives[5].read_version("bench", "whole").erasure.checksums
    if [(c["part"], c["algo"]) for c in sums] != [(1, "sha256")]:
        raise AssertionError(f"whole-file heal: checksums {sums}")
    log("whole-file layout (sha256) ok: PUT, GET byte-exact, heal of one lost row")
    return {"whole_file_put": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    dev = torch.device("cuda", 0)
    smi = phase_gpu_and_build()
    kernels = phase_kernels(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    tally = Tally()
    try:
        eo, drives, payloads, lost, main_counts = phase_slice(dev, smi, root, codec, tally)
        paths = {"put_get_degraded_get": main_counts}
        paths.update(phase_heal(smi, eo, drives, codec, tally, payloads, lost))
        paths.update(phase_multipart(smi, root, eo, codec, tally))
        phase_object_ops(eo, drives)
        paths.update(phase_whole_file(eo, drives, tally))
    finally:
        tally.uninstall()
        codec.close()
        shutil.rmtree(root, ignore_errors=True)
    for name, rec in kernels.items():
        rec["launches"] = main_counts["launches"][name]
        rec["launches_by_path"] = {path: c["launches"][name] for path, c in paths.items()}
    for path in ("put_get_degraded_get", "heal", "multipart"):
        suffix = "" if path == "put_get_degraded_get" else f"_{path}"
        kernels["hh256"][f"launches_by_n{suffix}"] = {str(n): c for n, c in paths[path]["hh256_by_n"].items()}
        kernels["rs_gf_apply"][f"launches_by_b_r{suffix}"] = {
            f"B={b},R={r}": c for (b, r), c in paths[path]["rs_gf_apply_by_b_r"].items()
        }
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
