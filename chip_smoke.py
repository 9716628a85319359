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
   each with its bytes bound; the hash at [16, 87382] and [1024, 87382].
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
    del verify

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
    log(f"kernel hh256 ok: [1024,{S_FULL}] {hh_ms:.4f} ms (plain {hh_plain_ms:.1f} ms, bound {hh_bound_ms:.4f} ms); "
        f"[16,{S_FULL}] {hh_ms_n16:.4f} ms (plain {hh_plain_ms_n16:.1f} ms, bound {hh_bound_ms_n16:.6f} ms)")
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


def _part_path(drive, key: str) -> str:
    obj = os.path.join(drive.root, "bench", key)
    data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
    return os.path.join(obj, data_dir, "part.1")


def _part_files(drives, key: str) -> list[bytes]:
    out = []
    for d in drives:
        with open(_part_path(d, key), "rb") as f:
            out.append(f.read())
    return out


def phase_slice(dev: torch.device, smi: str, big_mib: int = 128, small_mib: int = 16) -> dict:
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.ops import highwayhash_cuda, rs_cuda
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    rng = np.random.default_rng(20)
    big = rng.integers(0, 256, big_mib * MiB, dtype=np.uint8).tobytes()
    smalls = [rng.integers(0, 256, small_mib * MiB, dtype=np.uint8).tobytes() for _ in range(8)]
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    try:
        eo, drives = _make_set(os.path.join(root, "gpu"), codec)
        # Tally the hash kernel's launches by N (its third argument) beside
        # the wrapper's own count.
        hh_by_n: collections.Counter = collections.Counter()
        tally_lock = threading.Lock()
        hh_launch = highwayhash_cuda.KERNEL.launch

        def hh_launch_tallied(*args):
            hh_launch(*args)
            with tally_lock:
                hh_by_n[args[2]] += 1

        highwayhash_cuda.KERNEL.launch = hh_launch_tallied
        # And the RS kernel's by (B, R): its sixth and eighth arguments.
        rs_by_br: collections.Counter = collections.Counter()
        rs_launch = rs_cuda.KERNEL.launch

        def rs_launch_tallied(*args):
            rs_launch(*args)
            with tally_lock:
                rs_by_br[(args[5], args[7])] += 1

        rs_cuda.KERNEL.launch = rs_launch_tallied
        rs_cuda.KERNEL.launches = 0
        highwayhash_cuda.KERNEL.launches = 0

        t0 = time.perf_counter()
        eo.put_object("bench", "big", big)
        put_big = time.perf_counter() - t0
        put_big_launches = (rs_cuda.KERNEL.launches, highwayhash_cuda.KERNEL.launches)
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
        for key in ["big"] + [f"small{i}" for i in range(8)]:
            for i in (3, 7, 11, 15):
                os.remove(_part_path(drives[i], key))
        dget_big, dget_small = get_all()
        launches = {"rs_gf_apply": rs_cuda.KERNEL.launches, "hh256": highwayhash_cuda.KERNEL.launches}
        st = codec.stats()
    finally:
        highwayhash_cuda.KERNEL.__dict__.pop("launch", None)
        rs_cuda.KERNEL.__dict__.pop("launch", None)
        codec.close()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if not (st["batches_run"] > 0 and st["recon_batches_run"] > 0 and st["digests_verified"] > 0):
        raise AssertionError(f"device counters did not move: {st}")
    if st["host_fallback_blocks"] != 0:
        raise AssertionError(f"full blocks went to the host codec: {st}")
    gib_big, gib_small = big_mib / 1024, 8 * small_mib / 1024
    log(f"slice stats: {json.dumps(st)}")
    log(f"launches during the {big_mib} MiB PUT: rs_gf_apply {put_big_launches[0]}, "
        f"hh256 {put_big_launches[1]}")
    log(f"hh256 launches on the main path by N: {json.dumps(dict(sorted(hh_by_n.items())))}")
    rs_by_br = {f"B={b},R={r}": n for (b, r), n in sorted(rs_by_br.items())}
    log(f"rs_gf_apply launches on the main path by (B, R): {json.dumps(rs_by_br)}")
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
        shutil.rmtree(root, ignore_errors=True)
    log("reference check ok: 16 part files byte-identical to the numpy host codec")
    return launches, dict(sorted(hh_by_n.items())), rs_by_br


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_gpu_and_build()
    kernels = phase_kernels(dev)
    launches, hh_by_n, rs_by_br = phase_slice(dev, smi)
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
    kernels["hh256"]["launches_by_n"] = {str(n): c for n, c in hh_by_n.items()}
    kernels["rs_gf_apply"]["launches_by_b_r"] = rs_by_br
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
