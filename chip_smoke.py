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
   on rows whose base lies 1..15 bytes past a 16-byte boundary. Phase 5's
   shapes too: the RS kernel on the reduced-redundancy 14+2 encode (S =
   74,899, and its fused layout at B = 16) and on the small-object path's
   padded batches (S = 1 KiB .. 128 KiB, B up to 64, K = 12 and 14); the
   hash at L = 74,899 and at the small path's true row lengths. Bytes must
   be equal (tolerance: exact). Times come from CUDA events, each launch on
   rows not in the L2 cache: the RS kernel at [64, 12, 87382] contiguous,
   on the encode view at B = 16 and 64 and a 4-row reconstruct at B = 16,
   each with its bytes bound; the hash at [16, 87382], [64, 87382] (heal's
   verify batch and its rebuilt-row hash, 16 blocks x 4 rows) and
   [1024, 87382], and at [16, 74899] and [256, 2731]; the RS kernel also on
   the 14+2 encode view at B = 16 and 64, on two small-path batches and on
   phase 5's reconstructs (B = 1 and 4, R = 1 and 4, S = 87,382 and a
   padded 16,384), each beside the library yardstick (one torch fp16
   matmul of the same GF(2) product on pre-unpacked bits).
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
   In this phase, in phase 4's paths and in phase 5's, no work may reach the
   numpy host codec or a kernel's plain version (the launch tally counts
   such calls), and the codec's host_fallback_* counters must read 0.
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
5. Erasure sets and server pools at a deployment's size: 48 drive
   directories. Pool 0 is 32 drives formatted as 2 sets of 16 (12+4, RRS
   14+2, SIPMOD+PARITY), built by ErasureSets.from_drives; pool 1 is 16
   drives, 1 set, attached later by ServerPools.add_pool (SUSPENDED, then
   ACTIVE) while pool 0 turns DRAINING. Every set shares the phase's codec.
   2,048 objects from one numpy generator (names
   tenant-XX/YYYY-MM-DD/obj-NNNNN over 16 tenants and 8 days, sizes
   log-uniform from 1 KiB to 4 MiB, one in 8 REDUCED_REDUNDANCY), from 16
   client threads: 1,536 PUT into pool 0; 32 of them, of every size class
   and both storage classes, PUT again into a numpy HostCodec copy of
   pool 0 must leave the same part files and inline data; the listing of
   pool 0 is exact in pages of 1,000 with and without a delimiter and a
   prefix, its second page served by the metacache, and
   list_object_versions pages through versioned overwrites and a delete
   marker with key and version markers; after the attach the
   other 512 and 64 overwrites of pool-0 keys land in pool 1; every object's
   xl.meta lies only on its hashed set's drives; a GET of all 2,048 is
   byte-exact (an overwritten key reads its new bytes); the listing of both
   pools is exact without a delimiter (the delimiter listing and the
   version listing are printed, not held: the reference's multi-pool merges
   can skip keys and end a version listing early); delete_objects removes
   256 keys
   from the listing; with the part files and xl.meta of 4 drives of pool
   0's set 1 removed (2 of them for a 14+2 object), a GET of every object
   of that set is byte-exact and heal_object rebuilds each, byte-identical;
   heal_bucket recreates a drive's lost bucket directory. The PUTs, the
   GET, the degraded GET and the heal are paths of their own (counts reset
   before, read after; the healthy GET runs no RS); each prints its
   objects/s and GiB/s, the codec's clocks, the launch tally (hh256 by N
   and by row-length class, rs_gf_apply by (B, K, R) and by (K, R, S
   class)) and the device time those launches take at phase 2's times.
   Both kernels must have launched at K = 14, R = 2 and on small-path
   batches.
6. The S3 HTTP front over phase 5's deployment after its heal: the port's
   S3Server (SigV4, IAM root credentials, check_skew=True) on a
   ThreadedServer at 127.0.0.1, sharing the phase's codec. The client is a
   spawned process of 16 threads with keep-alive http.client connections;
   it signs with the port's api/auth.sign_request, a body up to 1 MiB with
   its sha256 and a larger one aws-chunked in 64 KiB chunks
   (api/streaming.encode_chunked), as minio-go does, and compares every
   body it reads with the bytes it made from the same seeds. Paths, each
   with the counts reset before it and read after:
   - http_put: 512 new objects (tenant-XX/YYYY-MM-DD/http-NNNNN, phase 5's
     size law, one in 8 REDUCED_REDUNDANCY); both kernels;
   - http_get: those 512 and 512 of phase 5's surviving objects in pool 0
     (pool 1's lost one drive's copy to phase 5's heal_bucket check),
     byte-exact; hh256, and rs_gf_apply only for windows where a hedged
     spare read beat a slow primary (at most 2 launches a winning hedge).
     Every HTTP-PUT object then also reads back byte-identical through
     layer.get_object;
   - http_big: one 128 MiB aws-chunked PUT, a 128 MiB multipart upload of
     16 x 8 MiB parts from 4 threads (ETag "-16"), a GET of both; both
     kernels;
   - http_degraded_get: the part files of 4 drives of pool 0's set 0
     removed (2 for a 14+2 object), every surviving object of that set read
     back byte-exact; both kernels.
   Then, with no rate: a HEAD, three Range GETs (first byte, a 1 MiB
   window, a suffix of 100) and an If-None-Match 304 per size class;
   ListObjectsV2 in pages of 1,000 equal to the layer's listing; POST
   ?delete of 128 new keys, gone from the next listing; an unsigned GET
   (403 AccessDenied), a tampered signature (403 SignatureDoesNotMatch)
   and a PUT with X-Mtpu-Deadline 0.0005 (503 SlowDownWrite, not listed).
   Each path prints objects/s, GiB/s, the client's p50 and p99 latency, the
   codec's device_* clocks, the launches by shape and the device time they
   take at phase 2's times, beside phase 3-5's direct-layer rates of the
   same run. No work may reach the host codec or a plain version.
   The always-on planes are read around each path (Planes): the stage
   ledger and the copy ledger are reset before it; after it the script
   prints each (layer, stage)'s count, p50, p99, wall and cpu sums, the
   copies per payload byte on each hop and the degrade records, and holds
   one api root span per request the client sent and one codec verify-batch
   record per object frame-parse record. The expired-deadline PUT must
   record one deadline abort. One signed PUT and one GET of a 4 MiB object
   run with a GLOBAL_TRACE subscriber: each must be one span tree keyed by
   its x-amz-request-id, with api, object and erasure spans. The continuous
   profiler stays off.
7. The fault plane on the card, on a fresh 16-drive 12+4 set whose drives
   are MeteredDrive(HealthGatedDrive(FaultyDisk(LocalDrive))), the stack
   dist/node.py builds, sharing the phase's codec; the launch tally is reset
   before each step and read after (both kernels must launch in each):
   - 7a: PUT 8 x 16 MiB and 128 objects of phase 5's size law from 16
     threads, GET each byte-exact, print the rates beside phases 3 and 5,
     the metered per-API latency EWMAs and the stage ledger; then a second
     GET pass with the continuous profiler on: gil_load, the share of
     samples by thread role and that pass's rate;
   - 7b: a seeded bitrot fault on one drive's writes while 16 x 4 MiB
     objects are PUT; every GET is byte-exact (hh256 drops the flipped
     shard, rs_gf_apply rebuilds it), heal_object rewrites it, and a GET
     with 4 other drives' part files removed is byte-exact;
   - 7c: drive-error on 2 drives: each breaker opens after 5 consecutive
     errors and the drive reads offline; 16 PUTs and 32 GETs are byte-exact
     (the GETs rebuild on the card); once disarmed, each breaker re-closes
     through its probe within max_cooldown; the degrade records and
     DriveBusy sheds are printed as they come;
   - 7d: four spawned processes, each on its own 16-drive set on the card,
     PUT an object, arm MTPU_CRASH through chaos.crash.arm_from_env and die
     with rc 137 at put.mid-commit:kill:8, put.mid-commit:kill:13,
     storage.append-iov.torn:torn-kill and multipart.complete.partial:kill;
     the parent runs recover_drive on every drive and recover_set, heals
     what it is handed, and holds the invariant: the victim is absent or
     byte-exact, no stage debris is left, and the acknowledged object reads
     byte-exact with 4 drives' part files removed.

The line before the last is a JSON object describing each kernel, with its
launches by path (phase 7's steps included); the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate
INT32_ALU_OPS_PER_S = 67e12  # taken as the fp32 non-tensor rate: no published int64 rate

K, M, DRIVES = 12, 4, 16
S_FULL = -(-(1 << 20) // K)  # 87,382: the shard chunk of a 1 MiB block
K_RRS = 14  # REDUCED_REDUNDANCY on a 16-drive set: 14+2
S_RRS = -(-(1 << 20) // K_RRS)  # 74,899
# The small-object path pads the shard axis to a power of two from 1 KiB.
SMALL_PADDED = tuple(1024 << i for i in range(8))
MiB = 1 << 20


T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def log_phase_end(phase: str) -> None:
    log(f"{phase} done at {time.perf_counter() - T0:.1f} s since start")


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
    # Reduced redundancy (14+2) encode, and the small-object path's padded
    # batches: B up to 64 at padded shard lengths of 1 KiB .. 128 KiB.
    parity_rrs = rs_matrix.parity_matrix(K_RRS, 2)
    for s in (1, 17, S_RRS):
        err = max(err, rs_err(rand((4, K_RRS, s)), parity_rrs))
    shards = rand((16, K_RRS + 2, S_RRS))
    err = max(err, rs_err(shards[:, :K_RRS], parity_rrs, out=shards[:, K_RRS:]))
    for s in SMALL_PADDED:
        err = max(err, rs_err(rand((64 if s <= 16384 else 8, K, s)), parity))
        err = max(err, rs_err(rand((8, K_RRS, s)), parity_rrs))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"rs_gf_apply disagrees with its plain version: max abs err {err}")
    log(f"rs_gf_apply equals its plain version: [64,{K},{S_FULL}] encode and 4-row reconstruct, the fused "
        f"layout at B in (1, 16, 64), R in 1..4 at S in {rs_lengths}, base offsets 1..15 in and out; "
        f"{K_RRS}+2 encode at S in (1, 17, {S_RRS}) and its fused layout at B = 16; the small path's "
        f"padded batches at S in {SMALL_PADDED}")

    def rs_bound(b: int, r: int, k: int = K, s: int = S_FULL) -> tuple[float, str]:
        nbytes = b * (k + r) * s
        ops = 2 * b * s * (k * 8) * (r * 8)  # the bit-matmul's MACs x 2
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def rs_cold_ms(b: int, r: int, layout: str, k: int = K, s: int = S_FULL) -> float:
        # Rotate over copies that together exceed the 50 MB L2, so each
        # launch reads rows that are not in the cache.
        copies = max(2, -(-64 * MiB // (b * (k + r) * s)))
        coeffs = recs[r] if layout == "reconstruct" else parity if k == K else parity_rrs
        if layout == "encode view":
            bufs = [rand((b, k + r, s)) for _ in range(copies)]
            calls = [(t[:, :k], t[:, k:]) for t in bufs]
        else:
            calls = [(rand((b, k, s)), torch.empty((b, r, s), dtype=torch.uint8, device=dev))
                     for _ in range(copies)]
        # Device time from a CUDA graph of the launches: at B = 16 the wrapper's
        # host time per call is not far below the kernel's.
        return graph_ms([lambda xi=xi, oi=oi: rs_cuda.apply(xi, coeffs, out=oi) for xi, oi in calls], 10)

    def rs_lib_ms(b: int, r: int, layout: str, k: int = K, s: int = S_FULL) -> float:
        # The library yardstick at this shape: one torch fp16 matmul of
        # pre-unpacked bits [B*S, K*8] by the bit-expanded coefficients.
        coeffs = recs[r] if layout == "reconstruct" else parity if k == K else parity_rrs
        bits = torch.randint(0, 2, (b * s, k * 8), device=dev, dtype=torch.float16)
        w = torch.from_numpy(rs_matrix.bit_expand(coeffs).astype(np.float16)).to(dev)
        ms = cuda_time_ms(lambda: bits @ w, 20)
        del bits
        return ms

    # The shapes of the paths: encode (contiguous, the fused view, 14+2, the
    # small path's padded batches), heal's 4-row window, and the degraded
    # GET's reconstructs of phase 5 (B = 1 and 4 blocks, R = 1 and 4 rows,
    # a full-block S and a padded small S).
    rs_shapes = []
    for b, r, layout, k, s in ((64, M, "contiguous", K, S_FULL), (16, M, "encode view", K, S_FULL),
                               (64, M, "encode view", K, S_FULL), (16, 4, "reconstruct", K, S_FULL),
                               (16, 2, "encode view", K_RRS, S_RRS), (64, 2, "encode view", K_RRS, S_RRS),
                               (64, M, "small-path batch", K, 16384), (8, M, "small-path batch", K, 131072),
                               *((b, r, "reconstruct", K, s) for s in (S_FULL, 16384) for b in (1, 4)
                                 for r in (1, 4))):
        ms = rs_cold_ms(b, r, layout, k, s)
        bound_ms, bound_by = rs_bound(b, r, k, s)
        lib_ms = rs_lib_ms(b, r, layout, k, s)
        rs_shapes.append({"shape": [b, k, s], "rows": r, "layout": layout, "ms": ms,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        log(f"kernel rs_gf_apply: [{b},{k},{s}] -> {r} rows, {layout}: {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms, {bound_by}; torch fp16 bit-matmul {lib_ms:.4f} ms)")
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
    # The 14+2 full-block row (1 MiB / 14) and the small path's true row
    # lengths (shards of 1 KiB .. 1 MiB objects over 12 and 14 data rows).
    small_lengths = (86, 74, 342, 293, 1366, 2731, 10923, 43691, 87381)
    for n in (1, 16, 64):
        herr = max(herr, hash_err(rand((n, S_RRS))))
        for length in small_lengths:
            herr = max(herr, hash_err(rand((n * 16, length))))
    torch.cuda.synchronize()
    if herr:
        raise AssertionError(f"hh256 disagrees with its plain version: max abs err {herr}")
    log(f"hh256 equals its plain version at N in (1, 16, 17, 1024) x {len(lengths)} lengths, "
        f"at base offsets {offsets.start}..{offsets.stop - 1}, at L = {S_RRS} (N = 1, 16, 64) and at the "
        f"small path's lengths {small_lengths} (N = 16, 256, 1024)")
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

    def hh_bound(n: int, length: int = S_FULL) -> tuple[float, str]:
        nbytes = n * length + n * 32
        # Per 32-byte packet and lane: 3 adds, 2 multiplies, 2 masks, 2
        # shifts, 2 xors, plus ~24 zipper shift/mask/or ops per lane pair:
        # ~60 ops.
        ops = n * (length // 32 + 11) * 4 * 60
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_ALU_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    hh_bound_ms, hh_bound_by = hh_bound(1024)
    hh_bound_ms_n16, _ = hh_bound(16)
    hh_bound_ms_n64, _ = hh_bound(64)
    # The 14+2 GET verify row batch, and a small-path group (16 blocks of
    # a 32 KiB object: 256 rows of 2,731 bytes), each over cold copies.
    hh_shapes = []
    for n, length in ((16, S_RRS), (256, 2731)):
        copies = max(2, -(-64 * MiB // (n * length)))
        rows = rand((copies, n, length))
        turn = itertools.cycle(range(copies))
        ms = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(rows[next(turn)]), 2 * copies)
        bound_ms, bound_by = hh_bound(n, length)
        hh_shapes.append({"shape": [n, length], "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"kernel hh256: [{n},{length}] {ms:.4f} ms (bound {bound_ms:.6f} ms, {bound_by})")
        del rows
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
            "ms_n64": hh_ms_n64, "bound_ms_n64": hh_bound_ms_n64, "shapes": hh_shapes,
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
    counts: the hash kernel's by (N, L) (its third and fourth arguments),
    the RS kernel's by (B, K, R, S) (its sixth to ninth). It also counts the
    calls into the numpy host codec and the kernels' plain versions, which no
    path may make on the card. reset() zeroes every count just before a
    path; read() reads them just after."""

    def __init__(self):
        from minio_tpu_torch.object.codec import HostCodec
        from minio_tpu_torch.ops import highwayhash as np_hh
        from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_ref

        self.kernels = {"rs_gf_apply": rs_cuda.KERNEL, "hh256": highwayhash_cuda.KERNEL}
        self.hh_by_nl: collections.Counter = collections.Counter()
        self.rs_by_bkrs: collections.Counter = collections.Counter()
        self.host_calls: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        hh_launch = highwayhash_cuda.KERNEL.launch
        rs_launch = rs_cuda.KERNEL.launch

        def hh_launch_tallied(*args):
            hh_launch(*args)
            with self._lock:
                self.hh_by_nl[(args[2], args[3])] += 1

        def rs_launch_tallied(*args):
            rs_launch(*args)
            with self._lock:
                self.rs_by_bkrs[(args[5], args[6], args[7], args[8])] += 1

        highwayhash_cuda.KERNEL.launch = hh_launch_tallied
        rs_cuda.KERNEL.launch = rs_launch_tallied
        host = [(HostCodec, n) for n in ("encode", "reconstruct", "reconstruct_batch", "digests_batch", "_digests")]
        host += [(np_hh, "hash256"), (np_hh, "hash256_batch"), (rs_ref, "encode"), (rs_ref, "reconstruct"),
                 (rs_cuda, "plain"), (highwayhash_torch, "hash256_batch")]
        self._restore = []
        for owner, name in host:
            real = getattr(owner, name)

            def counted(*args, _name=f"{owner.__name__}.{name}", _real=real, **kwargs):
                with self._lock:
                    self.host_calls[_name] += 1
                return _real(*args, **kwargs)

            setattr(owner, name, counted)
            self._restore.append((owner, name, real))

    def reset(self) -> None:
        with self._lock:
            for k in self.kernels.values():
                k.launches = 0
            self.hh_by_nl.clear()
            self.rs_by_bkrs.clear()
            self.host_calls.clear()

    def read(self, path: str, need: tuple = ("rs_gf_apply", "hh256")) -> dict:
        """The counts of one path; raises if a kernel in `need` did not
        launch in it, or if the path called the host codec or a plain
        version."""
        with self._lock:
            hh, rs = dict(self.hh_by_nl), dict(self.rs_by_bkrs)
            out = {
                "launches": {name: k.launches for name, k in self.kernels.items()},
                "hh256_by_n_l": dict(sorted(hh.items())),
                "rs_gf_apply_by_b_k_r_s": dict(sorted(rs.items())),
                "host_calls": dict(self.host_calls),
            }
        by_n: collections.Counter = collections.Counter()
        for (n, _), c in hh.items():
            by_n[n] += c
        by_b_r: collections.Counter = collections.Counter()
        by_b_k_r: collections.Counter = collections.Counter()
        for (b, k, r, _), c in rs.items():
            by_b_r[(b, r)] += c
            by_b_k_r[(b, k, r)] += c
        out["hh256_by_n"] = dict(sorted(by_n.items()))
        out["rs_gf_apply_by_b_r"] = dict(sorted(by_b_r.items()))
        for name in need:
            if out["launches"][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
        if out["host_calls"]:
            raise AssertionError(f"the {path} path called the host codec or a plain version: {out['host_calls']}")
        log(f"{path}: launches {json.dumps(out['launches'])}; hh256 by N "
            f"{json.dumps(out['hh256_by_n'])}; rs_gf_apply by (B, K, R) "
            f"{json.dumps({f'B={b},K={k},R={r}': c for (b, k, r), c in sorted(by_b_k_r.items())})}; "
            f"host codec and plain-version calls: 0")
        return out

    def uninstall(self) -> None:
        for k in self.kernels.values():
            k.__dict__.pop("launch", None)
        for owner, name, real in self._restore:
            setattr(owner, name, real)


def _no_host_fallback(codec, path: str) -> None:
    st = codec.stats()
    fallback = {k: st[k] for k in ("host_fallback_blocks", "host_fallback_recon_blocks",
                                   "host_fallback_digest_chunks")}
    if any(fallback.values()):
        raise AssertionError(f"{path}: work went to the host codec: {fallback}")


def _rate(rates: dict | None, key: str, n_objects: int, seconds: float, nbytes: int) -> None:
    """Keep a direct-layer rate for phase 6 to print beside its own."""
    if rates is not None:
        rates[key] = {"objects_per_s": n_objects / seconds, "gib_per_s": nbytes / 2**30 / seconds}


def phase_slice(dev, smi: str, root: str, codec, tally: Tally, big_mib: int = 128, small_mib: int = 16,
                rates: dict | None = None):
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
    _no_host_fallback(codec, "PUT/GET/degraded GET")
    gib_big, gib_small = big_mib / 1024, 8 * small_mib / 1024
    _rate(rates, "put_big", 1, put_big, big_mib * MiB)
    _rate(rates, "get_big", 1, get_big, big_mib * MiB)
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
    _no_host_fallback(codec, "heal")
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
    _no_host_fallback(codec, "heal of a flipped byte")
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


def phase_multipart(smi: str, root: str, eo, codec, tally: Tally, part_mib: int = 8,
                    rates: dict | None = None) -> dict:
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
    _no_host_fallback(codec, "multipart")
    after = codec.stats()
    log("multipart stats moved: " + json.dumps({k: after[k] - before[k] for k in (
        "batches_run", "blocks_encoded", "blocks_padded", "host_fallback_blocks", "device_encode_seconds")}))
    if not oi.etag.endswith("-5") or oi.size != len(data):
        raise AssertionError(f"multipart: {oi}")
    if eo.get_object("bench", "mp")[1] != data:
        raise AssertionError("multipart GET: bytes differ")
    _rate(rates, "multipart", 1, mp_s, len(data))
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


# -- phase 5: erasure sets and server pools ------------------------------------------------

POOL_DRIVES = (32, 16)  # pool 0: 2 sets of 16; pool 1, attached later: 1 set of 16
SET_DRIVES = 16
TENANTS, DAYS = 16, 8


def _size_class(n: int) -> str:
    if n < 4 << 10:
        return "<4KiB"
    if n < 128 << 10:
        return "4-128KiB inline"
    if n < MiB:
        return "128KiB-1MiB small path"
    return ">=1MiB full blocks"


class Traffic:
    """The objects of phase 5, all from one numpy generator: names
    tenant-XX/YYYY-MM-DD/obj-NNNNN over 16 tenants and 8 days, sizes
    log-uniform from 1 KiB to 4 MiB, one object in 8 REDUCED_REDUNDANCY.
    The bytes are one buffer made in bulk; each object is a view of it."""

    def __init__(self, seed: int, n: int, max_size: int = 4 * MiB, stem: str = "obj"):
        rng = np.random.default_rng(seed)
        tenants = rng.integers(0, TENANTS, n)
        days = rng.integers(0, DAYS, n)
        self.names = [f"tenant-{t:02d}/2024-01-{d + 1:02d}/{stem}-{i:05d}"
                      for i, (t, d) in enumerate(zip(tenants, days))]
        self.sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(max_size), n)).astype(np.int64)
        self.rrs = rng.permutation(n) < n // 8
        offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self._buf = memoryview(rng.bytes(int(offsets[-1])))
        self.data = {name: self._buf[offsets[i]:offsets[i + 1]] for i, name in enumerate(self.names)}
        self.storage_class = {name: "REDUCED_REDUNDANCY" if r else "" for name, r in zip(self.names, self.rrs)}
        self.rng = rng


def _pool_drives(root: str, n_sets: int, formats=None) -> tuple:
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    formats = formats or fmt.init_format(n_sets, SET_DRIVES)
    drives = []
    for i, f in enumerate(formats):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    return drives, formats


def _in_threads(fn, items, threads: int) -> list:
    with cf.ThreadPoolExecutor(threads) as ex:
        return list(ex.map(fn, items))


def _list_all(layer, bucket: str, **kwargs) -> tuple[list[str], list[str], int]:
    """Page a V1 listing through with next_marker: (keys, prefixes, pages)."""
    keys, prefixes, marker, pages = [], [], "", 0
    while True:
        res = layer.list_objects(bucket, marker=marker, **kwargs)
        pages += 1
        keys += [o.name for o in res.objects]
        prefixes += res.prefixes
        if not res.is_truncated:
            return keys, prefixes, pages
        marker = res.next_marker


def _version_pages(layer) -> tuple[list, int]:
    """Page list_object_versions of bucket "versions" through with key and
    version markers, 5 entries a page."""
    seen, km, vm, pages = [], "", "", 0
    while True:
        res = layer.list_object_versions("versions", prefix="v/", key_marker=km, version_marker=vm, max_keys=5)
        pages += 1
        seen += [(o.name, o.version_id, o.is_latest, o.delete_marker) for o in res.objects]
        if not res.is_truncated:
            return seen, pages
        km, vm = res.next_key_marker, res.next_version_marker


def _holders(layer, name: str) -> list[tuple[int, int]]:
    """(pool, drive) of every drive holding name's xl.meta."""
    return [
        (p, i)
        for p, sets in enumerate(layer.pools)
        for i, d in enumerate(sets.disks)
        if os.path.exists(os.path.join(d.root, "bench", name, "xl.meta"))
    ]


def _object_files(drive, name: str) -> dict:
    """Every file of an unversioned object's directory on one drive, by
    file name: xl.meta, and part.N under its data directory (whose name is
    a random uuid per PUT)."""
    top = os.path.join(drive.root, "bench", name)
    out = {}
    for dirpath, _, files in os.walk(top):
        for f in files:
            out[f] = _read(os.path.join(dirpath, f))
    return out


def _device_ms(counts: dict, kernels: dict) -> float:
    """A path's device time, estimated from its launches: each at phase 2's
    time for its shape. The hash by row length, interpolated between the
    lengths phase 2 timed (the kernel's time is flat in N to 2,048
    streams), shorter rows
    at the shortest one's time; the RS kernel at the [64, 12+4, 87382]
    encode's time scaled by the bytes it moves, never under the small-path
    batch's time."""
    hh = kernels["hh256"]
    points = sorted([(2731, hh["shapes"][1]["ms"]), (S_RRS, hh["shapes"][0]["ms"]), (S_FULL, hh["ms_n16"])])
    ms = 0.0
    for (_, length), c in counts["hh256_by_n_l"].items():
        for (l0, t0), (l1, t1) in zip(points, points[1:]):
            if length <= l1:
                t = t0 if length <= l0 else t0 + (t1 - t0) * (length - l0) / (l1 - l0)
                break
        else:
            t = points[-1][1] * length / points[-1][0]
        ms += c * t
    rs = kernels["rs_gf_apply"]
    full_bytes = 64 * (K + M) * S_FULL
    floor = min(sh["ms"] for sh in rs["shapes"] if sh["layout"] == "small-path batch")
    for (b, k, r, s_len), c in counts["rs_gf_apply_by_b_k_r_s"].items():
        ms += c * max(floor, rs["ms"] * b * (k + r) * s_len / full_bytes)
    return ms


def _shape_summary(counts: dict) -> dict:
    """Launches by shape class: hh256 by row length (and N), rs_gf_apply
    by (K, R) and whether S is a small-path padded length (a power of two)."""
    hh: collections.Counter = collections.Counter()
    for (_, length), c in counts["hh256_by_n_l"].items():
        if length in (S_FULL, S_RRS):
            hh[f"L={length}"] += c
        else:
            hh["L<=4096" if length <= 4096 else "L 4097-87381"] += c
    rs: collections.Counter = collections.Counter()
    for (_, k, r, s_len), c in counts["rs_gf_apply_by_b_k_r_s"].items():
        if s_len in SMALL_PADDED:
            shape = f"padded S={s_len}"
        else:
            shape = f"S={s_len}" if s_len in (S_FULL, S_RRS) else "S other"
        rs[f"K={k},R={r},{shape}"] += c
    return {"hh256": dict(sorted(hh.items())), "rs_gf_apply": dict(sorted(rs.items()))}


def phase_pools(smi: str, root: str, codec, tally: Tally, kernels: dict, n_objects: int = 2048, threads: int = 16,
                max_size: int = 4 * MiB, seed: int = 5, rates: dict | None = None) -> tuple[dict, SimpleNamespace]:
    """A 48-drive deployment through ServerPools: see the module docstring.
    Returns the paths' counts and the deployment as it stands after the
    heal, for phase 6."""
    from minio_tpu_torch import ErasureSets, ServerPools
    from minio_tpu_torch.object import pools as pools_mod
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions

    t_gen = time.perf_counter()
    traffic = Traffic(seed, n_objects, max_size)
    total_bytes = int(traffic.sizes.sum())
    log(f"pools traffic: {n_objects} objects, {total_bytes / MiB:.1f} MiB, made in "
        f"{time.perf_counter() - t_gen:.2f} s; by size class "
        f"{json.dumps(collections.Counter(_size_class(int(n)) for n in traffic.sizes))}, "
        f"{int(traffic.rrs.sum())} REDUCED_REDUNDANCY")
    drives0, formats0 = _pool_drives(os.path.join(root, "pool0"), POOL_DRIVES[0] // SET_DRIVES)
    layer = ServerPools([ErasureSets.from_drives(drives0, formats0[0], codec=codec, pool_index=0)])
    layer.make_bucket("bench")
    sets0 = layer.pools[0]
    if [len(s.disks) for s in sets0.sets] != [16, 16] or sets0.sets[0].parity != 4 or sets0.sets[0].rrs_parity != 2:
        raise AssertionError("pool 0 is not 2 sets of 12+4 with 14+2 RRS")
    n0 = n_objects * 3 // 4
    first, rest = traffic.names[:n0], traffic.names[n0:]
    paths = {}

    def put(name, data=None):
        return layer.put_object("bench", name, traffic.data[name] if data is None else data,
                                PutObjectOptions(storage_class=traffic.storage_class[name]))

    def rate(label: str, names: list, seconds: float, nbytes: int) -> str:
        return (f"{label}: {len(names)} objects in {seconds:.3f} s, {len(names) / seconds:.1f} objects/s, "
                f"{nbytes / 2**30 / seconds:.4f} GiB/s [{smi}]")

    clock_keys = ("device_encode_seconds", "batches_run", "small_batches_run", "small_blocks_encoded",
                  "device_verify_seconds", "verify_batches_run", "digests_verified",
                  "device_recon_seconds", "recon_batches_run")

    def clock(label: str, before: dict, wall_s: float) -> None:
        """The codec's own clocks over a path (summed over threads: device
        work with its host staging and copies) beside its wall time."""
        after = codec.stats()
        log(f"{label} codec clocks over {wall_s:.3f} s of wall time: "
            + json.dumps({k: round(after[k] - before[k], 4) for k in clock_keys}))

    # 1. PUT into pool 0.
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    _in_threads(put, first, threads)
    put0_s = time.perf_counter() - t0
    paths["pools_put_pool0"] = tally.read("pools: PUT into pool 0")
    _no_host_fallback(codec, "pools: PUT into pool 0")
    bytes0 = sum(len(traffic.data[n]) for n in first)
    log(rate(f"pools PUT into pool 0 ({threads} threads)", first, put0_s, bytes0))
    _rate(rates, "pools_put_pool0", len(first), put0_s, bytes0)
    clock("pools PUT into pool 0", before, put0_s)

    # Bytes against the host codec: a sample of 32 objects of every size
    # class and both storage classes, PUT again into a numpy HostCodec copy
    # of pool 0 (the same formats), must leave the same part files and
    # inline data on every drive.
    by_class = collections.defaultdict(list)
    for name in first:
        by_class[(_size_class(len(traffic.data[name])), traffic.storage_class[name])].append(name)
    sample = []
    for key in sorted(by_class):
        names = sorted(by_class[key], key=lambda n: len(traffic.data[n]))
        sample += names[: max(1, 32 // len(by_class))]
    sample = sample[:32]
    host_drives, _ = _pool_drives(os.path.join(root, "host-pool0"), 2, formats0)
    host_sets = ErasureSets.from_drives(host_drives, formats0[0], codec=HostCodec(), pool_index=0)
    host_sets.make_bucket("bench")
    for name in sample:
        host_sets.put_object("bench", name, traffic.data[name],
                             PutObjectOptions(storage_class=traffic.storage_class[name]))
        for i, (d, h) in enumerate(zip(drives0, host_drives)):
            got, want = _object_files(d, name), _object_files(h, name)
            if {k for k in got if k != "xl.meta"} != {k for k in want if k != "xl.meta"}:
                raise AssertionError(f"reference {name}: drive {i} holds other files than the host codec's")
            for k in got:
                if k != "xl.meta" and got[k] != want[k]:
                    raise AssertionError(f"reference {name}: drive {i} {k} differs from the host codec's")
            if got and d.read_version("bench", name).inline_data != h.read_version("bench", name).inline_data:
                raise AssertionError(f"reference {name}: drive {i} inline data differs from the host codec's")
    shutil.rmtree(os.path.join(root, "host-pool0"))
    covered = collections.Counter(
        f"{_size_class(len(traffic.data[n]))}/{traffic.storage_class[n] or 'STANDARD'}" for n in sample
    )
    log(f"reference check ok: {len(sample)} objects ({json.dumps(dict(sorted(covered.items())))}): "
        f"byte-identical part files and inline data against the numpy host codec")

    # 2. Listing of one pool: exact, in pages of 1,000, with and without a
    # delimiter and a prefix; the second page comes from the metacache.
    want0 = sorted(first)
    walks, hits = sets0.metacache.walks, sets0.metacache.hits
    t0 = time.perf_counter()
    keys, prefixes, pages = _list_all(layer, "bench", max_keys=1000)
    list_s = time.perf_counter() - t0
    if keys != want0 or prefixes:
        raise AssertionError(f"listing of pool 0: {len(keys)} keys, want {len(want0)}")
    if sets0.metacache.walks - walks != 1 or sets0.metacache.hits - hits != pages - 1:
        raise AssertionError(f"metacache: {sets0.metacache.walks - walks} walks and "
                             f"{sets0.metacache.hits - hits} hits over {pages} pages")
    t0 = time.perf_counter()
    keys_warm, _, pages_warm = _list_all(layer, "bench", max_keys=1000)
    list_warm_s = time.perf_counter() - t0
    if keys_warm != want0:
        raise AssertionError("listing of pool 0 from the metacache differs")
    keys, prefixes, _ = _list_all(layer, "bench", delimiter="/", max_keys=1000)
    if keys or prefixes != sorted({n.split("/")[0] + "/" for n in first}):
        raise AssertionError(f"delimiter listing of pool 0: {keys[:3]}, {prefixes}")
    tenant = first[0].split("/")[0] + "/"
    keys, prefixes, _ = _list_all(layer, "bench", prefix=tenant, delimiter="/", max_keys=1000)
    if keys or prefixes != sorted({n[: n.rindex("/") + 1] for n in first if n.startswith(tenant)}):
        raise AssertionError(f"prefix+delimiter listing of pool 0: {prefixes}")
    day = first[0][: first[0].rindex("/") + 1]
    keys, prefixes, _ = _list_all(layer, "bench", prefix=day, max_keys=7)
    if keys != sorted(n for n in first if n.startswith(day)) or prefixes:
        raise AssertionError(f"prefix listing of pool 0 in pages of 7: {len(keys)} keys")
    log(f"listing of pool 0 exact ({len(want0)} keys; delimiter, prefix and prefix+delimiter too): "
        f"{pages} pages in {list_s:.3f} s ({pages / list_s:.2f} pages/s, 1 walk, then metacache hits), "
        f"again from the metacache {pages_warm} pages in {list_warm_s:.4f} s "
        f"({pages_warm / list_warm_s:.1f} pages/s) [{smi}]")

    # list_object_versions over versioned overwrites and a delete marker,
    # paged with key and version markers (one pool: the reference's
    # two-pool merge drops the truncation of a full page).
    layer.make_bucket("versions")
    for v in range(3):
        for i in range(8):
            layer.put_object("versions", f"v/obj-{i}", traffic.rng.bytes(1000 + 997 * i),
                             PutObjectOptions(versioned=True))
    layer.delete_object("versions", "v/obj-3", DeleteObjectOptions(versioned=True))
    seen, vpages = _version_pages(layer)
    if len(seen) != 25 or len(set(seen)) != 25 or [s[0] for s in seen] != sorted(s[0] for s in seen):
        raise AssertionError(f"list_object_versions: {len(seen)} entries over {vpages} pages")
    if [(s[0], s[3]) for s in seen if s[2]] != [(f"v/obj-{i}", i == 3) for i in range(8)]:
        raise AssertionError("list_object_versions: latest flags or the delete marker are wrong")
    log(f"list_object_versions ok: 25 versions (8 keys x 3, 1 delete marker) in {vpages} pages of 5")

    # 3. Attach pool 1 (SUSPENDED, then ACTIVE) and drain pool 0: the other
    # objects and 64 overwrites of pool-0 keys land in pool 1.
    drives1, formats1 = _pool_drives(os.path.join(root, "pool1"), POOL_DRIVES[1] // SET_DRIVES)
    idx = layer.add_pool(ErasureSets.from_drives(drives1, formats1[0], codec=codec, pool_index=1))
    if layer.statuses[idx] != pools_mod.POOL_SUSPENDED:
        raise AssertionError("add_pool: pool 1 is not SUSPENDED")
    for bucket in ("bench", "versions"):
        layer.pools[idx].make_bucket(bucket)
    layer.set_pool_status(idx, pools_mod.POOL_ACTIVE)
    layer.set_pool_status(0, pools_mod.POOL_DRAINING)
    over = sorted(traffic.rng.choice(len(first), size=min(64, len(first) // 8), replace=False))
    overwritten = {first[i]: traffic.rng.bytes(len(traffic.data[first[i]])) for i in over}
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    _in_threads(put, rest, threads)
    _in_threads(lambda name: put(name, overwritten[name]), list(overwritten), threads)
    put1_s = time.perf_counter() - t0
    paths["pools_put_pool1"] = tally.read("pools: PUT into pool 1 and overwrites")
    _no_host_fallback(codec, "pools: PUT into pool 1 and overwrites")
    bytes1 = sum(len(traffic.data[n]) for n in rest) + sum(len(v) for v in overwritten.values())
    log(rate(f"pools PUT into pool 1 + {len(overwritten)} overwrites ({threads} threads)", rest + list(overwritten), put1_s, bytes1))
    _rate(rates, "pools_put_pool1", len(rest) + len(overwritten), put1_s, bytes1)
    clock("pools PUT into pool 1", before, put1_s)
    current = {name: traffic.data[name] for name in traffic.names}
    current.update(overwritten)

    # Placement: every object's xl.meta only on the drives of its hashed set.
    in_pool0, in_pool1 = set(first), set(rest) | set(overwritten)
    for name in traffic.names:
        held = _holders(layer, name)
        want = []
        if name in in_pool0:
            s = sets0.get_set_index(name)
            want += [(0, s * SET_DRIVES + i) for i in range(SET_DRIVES)]
        if name in in_pool1:
            want += [(1, i) for i in range(SET_DRIVES)]
        if held != want:
            raise AssertionError(f"placement of {name}: {held[:4]}..., want {want[:4]}...")
    per_set = collections.Counter(sets0.get_set_index(n) for n in first)
    log(f"placement ok: pool 0 sets hold {dict(sorted(per_set.items()))} objects, pool 1 holds "
        f"{len(rest)} new + {len(overwritten)} overwrites, each only on its hashed set's 16 drives")

    # 4. GET all, byte-exact; an overwritten key reads its new bytes.
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    got = _in_threads(lambda name: layer.get_object("bench", name)[1] == current[name], traffic.names, threads)
    get_s = time.perf_counter() - t0
    paths["pools_get"] = tally.read("pools: GET", need=("hh256",))
    _no_host_fallback(codec, "pools: GET")
    if not all(got):
        raise AssertionError(f"pools GET: {got.count(False)} objects differ")
    log(rate(f"pools GET, byte-exact ({threads} threads)", traffic.names, get_s, sum(len(v) for v in current.values())))
    _rate(rates, "pools_get", len(traffic.names), get_s, sum(len(v) for v in current.values()))
    clock("pools GET", before, get_s)

    # 5. Listing across both pools: exact without a delimiter; the
    # delimiter listing is printed against what is expected, since the
    # reference's multi-pool delimiter merge can skip keys.
    want_all = sorted(traffic.names)
    t0 = time.perf_counter()
    keys, _, pages = _list_all(layer, "bench", max_keys=1000)
    list2_s = time.perf_counter() - t0
    if keys != want_all:
        raise AssertionError(f"two-pool listing: {len(keys)} keys, want {len(want_all)}")
    dkeys, prefixes, dpages = _list_all(layer, "bench", delimiter="/", max_keys=1000)
    want_prefixes = sorted({n.split("/")[0] + "/" for n in traffic.names})
    log(f"two-pool listing exact: {len(keys)} keys in {pages} pages, {list2_s:.3f} s ({pages / list2_s:.2f} pages/s) "
        f"[{smi}]; delimiter listing (not held, see ROADMAP): {len(dkeys)} keys and {len(prefixes)} prefixes "
        f"in {dpages} pages, expected 0 keys and {len(want_prefixes)} prefixes, "
        f"{len(set(want_prefixes) - set(prefixes))} missing")

    seen, vpages = _version_pages(layer)
    log(f"two-pool list_object_versions (not held, see ROADMAP): {len(seen)} of 25 versions in {vpages} pages of 5")

    # 6. Bulk delete of 256 keys (some overwritten: both copies go).
    victims = sorted(str(n) for n in traffic.rng.choice(traffic.names, size=min(256, len(traffic.names) // 4),
                                                         replace=False))
    victims_set = set(victims)
    res = layer.delete_objects("bench", [(n, "") for n in victims])
    if any(e is not None for _, e in res):
        raise AssertionError(f"delete_objects: {[e for _, e in res if e is not None][:3]}")
    keys, _, _ = _list_all(layer, "bench", max_keys=1000)
    if keys != sorted(set(traffic.names) - set(victims)):
        raise AssertionError(f"listing after delete_objects: {len(keys)} keys")
    live = [n for n in traffic.names if n not in victims_set]
    log(f"delete_objects ok: {len(victims)} keys gone from the listing, {len(keys)} left")

    # 7. Degraded GET and heal: the part files and xl.meta of 4 drives of
    # pool 0's set 1 are removed (2 of them for a REDUCED_REDUNDANCY
    # object: 14+2 survives 2 losses, not 4).
    lost_drives = (1, 6, 11, 12)
    set1 = sets0.sets[1].disks
    targets = [n for n in first if sets0.get_set_index(n) == 1 and n not in victims_set and n not in overwritten]
    removed = {}
    for name in targets:
        lost = lost_drives[:2] if traffic.storage_class[name] else lost_drives
        for i in lost:
            fi = set1[i].read_version("bench", name)
            removed[(name, i)] = (_object_files(set1[i], name), _erasure_fields(fi), fi.inline_data)
            shutil.rmtree(os.path.join(set1[i].root, "bench", name))
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    got = _in_threads(lambda name: layer.get_object("bench", name)[1] == current[name], targets, threads)
    dget_s = time.perf_counter() - t0
    paths["pools_degraded_get"] = tally.read("pools: degraded GET")
    _no_host_fallback(codec, "pools: degraded GET")
    if not all(got):
        raise AssertionError(f"pools degraded GET: {got.count(False)} objects differ")
    log(rate(f"pools degraded GET of pool 0's set 1 (4 drives lost; 2 for RRS), byte-exact ({threads} threads)",
             targets, dget_s, sum(len(current[n]) for n in targets)))
    _rate(rates, "pools_degraded_get", len(targets), dget_s, sum(len(current[n]) for n in targets))
    clock("pools degraded GET", before, dget_s)
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    results = _in_threads(lambda name: layer.heal_object("bench", name), targets, threads)
    heal_s = time.perf_counter() - t0
    paths["pools_heal"] = tally.read("pools: heal")
    _no_host_fallback(codec, "pools: heal")
    clock("pools heal", before, heal_s)
    for name, res in zip(targets, results):
        lost = lost_drives[:2] if traffic.storage_class[name] else lost_drives
        if res.disks_healed != len(lost):
            raise AssertionError(f"heal {name}: {res}")
        for i in lost:
            files, fields, inline = removed[(name, i)]
            if _object_files(set1[i], name).keys() != files.keys():
                raise AssertionError(f"heal {name}: drive {i} holds other files")
            for k, v in _object_files(set1[i], name).items():
                if k != "xl.meta" and v != files[k]:
                    raise AssertionError(f"heal {name}: drive {i} {k} differs from the removed file")
            fi = set1[i].read_version("bench", name)
            if _erasure_fields(fi) != fields or fi.inline_data != inline:
                raise AssertionError(f"heal {name}: drive {i} xl.meta erasure fields or inline data differ")
    log(rate(f"pools heal of pool 0's set 1, byte-identical ({threads} threads)", targets, heal_s,
             sum(len(current[n]) for n in targets)))

    # 8. heal_bucket: one drive of pool 1 loses the bucket's directory.
    shutil.rmtree(os.path.join(drives1[5].root, "bench"))
    layer.heal_bucket("bench")
    if not os.path.isdir(os.path.join(drives1[5].root, "bench")):
        raise AssertionError("heal_bucket: the bucket directory was not recreated")
    some = [n for n in live if n in rest][:16]
    if not all(layer.get_object("bench", n)[1] == current[n] for n in some):
        raise AssertionError("GET after heal_bucket: bytes differ")
    log(f"heal_bucket ok: the bucket directory is back, {len(some)} pool-1 objects read byte-exact")

    walls = {"pools_put_pool0": put0_s, "pools_put_pool1": put1_s, "pools_get": get_s,
             "pools_degraded_get": dget_s, "pools_heal": heal_s}
    for path, counts in paths.items():
        summary = _shape_summary(counts)
        dev_ms = _device_ms(counts, kernels)
        log(f"{path}: launches by shape class {json.dumps(summary)}; device time estimated from them "
            f"{dev_ms / 1e3:.3f} s of {walls[path]:.3f} s wall ({100 * dev_ms / 1e3 / walls[path]:.2f}%)")
    rs_shapes = {(k, r, s_len) for counts in paths.values() for (_, k, r, s_len) in counts["rs_gf_apply_by_b_k_r_s"]}
    if (K_RRS, 2, S_RRS) not in rs_shapes:
        raise AssertionError("phase 5 launched no RS encode at K = 14, R = 2")
    if not any(s_len in SMALL_PADDED for (_, _, s_len) in rs_shapes):
        raise AssertionError("phase 5 launched no small-path RS batch")
    hh_lens = {length for counts in paths.values() for (_, length) in counts["hh256_by_n_l"]}
    if S_RRS not in hh_lens:
        raise AssertionError("phase 5 launched no hh256 at 74,899 bytes (1 MiB / 14)")
    state = SimpleNamespace(layer=layer, traffic=traffic, seed=seed, max_size=max_size, first=first,
                            overwritten=set(overwritten), live=live, sets0=sets0)
    return paths, state


# -- the observability planes (phases 6 and 7) -----------------------------------------------

API_CHILD_SPANS = ("auth", "body-read", "response-write")


class Planes:
    """The port's always-on planes around one path: reset() zeroes the stage
    ledger and the copy ledger and notes the degrade counters; read() prints
    the per-stage table (count, p50, p99, wall and cpu sums), the copies per
    payload byte on each hop and the degrade deltas, and holds the checks:
    one api root span per request the client sent, and one codec
    verify-batch record per object frame-parse record."""

    def __init__(self):
        from minio_tpu_torch.control.degrade import GLOBAL_DEGRADE
        from minio_tpu_torch.control.perf import GLOBAL_PERF, summarize
        from minio_tpu_torch.control.profiler import GLOBAL_PROFILER

        self.ledger, self.copy, self.degrade = GLOBAL_PERF.ledger, GLOBAL_PROFILER.copy, GLOBAL_DEGRADE
        self.summarize = summarize
        self._deg0 = GLOBAL_DEGRADE.snapshot()

    def reset(self) -> None:
        self.ledger.reset()
        self.copy.reset()
        self._deg0 = self.degrade.snapshot()

    def degrade_delta(self) -> dict:
        now = self.degrade.snapshot()
        out = {k: now[k] - self._deg0[k] for k in ("hedge_launched", "hedge_wins", "breaker_trips",
                                                    "breaker_closes")}
        for key in ("deadline_aborts", "sheds"):
            out[key] = {k: v - self._deg0[key].get(k, 0) for k, v in now[key].items()
                        if v - self._deg0[key].get(k, 0)}
        return out

    def _settled(self) -> dict:
        """The ledger once a straggling hedged read has landed: its verify
        and frame-parse records close moments after the response."""
        snap = self.ledger.snapshot()
        for _ in range(50):
            time.sleep(0.1)
            again = self.ledger.snapshot()
            if again == snap:
                break
            snap = again
        return snap

    def read(self, path: str, n_requests: int | None, payload_bytes: int, smi: str) -> None:
        summ = self.summarize(self._settled())
        rows = []
        for layer in sorted(summ):
            for stage in sorted(summ[layer]):
                s = summ[layer][stage]
                rows.append({"layer": layer, "stage": stage, "count": s["count"], "p50_ms": s["p50_ms"],
                             "p99_ms": s["p99_ms"], "wall_s": round(s["total_ms"] / 1e3, 4),
                             "cpu_s": round(s["cpu_seconds"], 4)})
        log(f"{path} stage ledger [{smi}]: " + json.dumps(rows))
        hops = self.copy.snapshot()["hops"]
        per_byte = {hop: {"copied": round(h["copied_bytes"] / payload_bytes, 4),
                          "moved": round(h["moved_bytes"] / payload_bytes, 4)}
                    for hop, h in sorted(hops.items())} if payload_bytes else {}
        log(f"{path} copies per payload byte ({payload_bytes} bytes): " + json.dumps(per_byte))
        deg = self.degrade_delta()
        log(f"{path} degrade records: " + json.dumps(deg))
        count = {(r["layer"], r["stage"]): r["count"] for r in rows}
        roots = sum(c for (layer, stage), c in count.items() if layer == "api" and stage not in API_CHILD_SPANS)
        if n_requests is not None and roots != n_requests:
            raise AssertionError(f"{path}: {roots} api root spans, the client sent {n_requests} requests")
        fp, vb = count.get(("object", "frame-parse"), 0), count.get(("codec", "verify-batch"), 0)
        if fp != vb:
            raise AssertionError(f"{path}: {fp} object/frame-parse records, {vb} codec/verify-batch records")


def _trace_tree(records: list, request_id: str) -> dict:
    """One request's span tree from GLOBAL_TRACE records: raises unless the
    trace has exactly one root and every span hangs under it."""
    spans = [r for r in records if r.get("type") == "span" and r.get("trace") == request_id]
    ids = {r["span"] for r in spans}
    roots = [r for r in spans if r["parent"] == ""]
    orphans = [r["name"] for r in spans if r["parent"] and r["parent"] not in ids]
    if len(roots) != 1 or orphans:
        raise AssertionError(f"trace {request_id}: {len(roots)} roots, spans with no parent in the tree {orphans}")
    layers = collections.Counter(r["layer"] for r in spans)
    names = collections.Counter(r["name"] for r in spans)
    return {"root": roots[0]["name"], "spans": len(spans), "layers": dict(layers), "names": dict(names)}


# -- phase 6: the S3 HTTP front -------------------------------------------------------------

HTTP_CREDS = ("chipsmoke", "chip-smoke-secret-key")
HTTP_THREADS = 16
# minio-go's signing defaults: a body up to this size carries its sha256 in
# x-amz-content-sha256; a larger one goes aws-chunked in 64 KiB chunks
# (payloadChunkSize, pkg/signer/request-signature-streaming.go).
SIGNED_BODY_MAX = MiB
STREAM_CHUNK = 64 << 10


def _client_main(conn, endpoint: str) -> None:
    """Phase 6's S3 client, in a spawned process of its own so that its
    signing and hashing do not share the server's GIL. It signs with the
    port's api/auth.sign_request and api/streaming.encode_chunked over
    keep-alive http.client connections (one a thread), holds the expected
    bytes of every object (made from the same seeds as the server side's),
    and answers commands from the pipe until "stop"."""
    import http.client
    import traceback
    import urllib.parse

    from minio_tpu_torch.api import auth, streaming

    host = urllib.parse.urlparse(endpoint).netloc
    creds = auth.Credentials(*HTTP_CREDS)
    objects: dict = {}
    local = threading.local()

    def signed(method: str, path: str, query: list, headers: dict, body) -> tuple[dict, object]:
        h = {k.lower(): v for k, v in headers.items()}
        h["host"] = host
        if len(body) > SIGNED_BODY_MAX:
            h["content-encoding"] = "aws-chunked"
            h["x-amz-decoded-content-length"] = str(len(body))
            h = auth.sign_request(creds, method, path, query, h, None, payload_hash=auth.STREAMING_PAYLOAD)
            seed = h["authorization"].rsplit("Signature=", 1)[1]
            body = streaming.encode_chunked(bytes(body), seed, creds, h["x-amz-date"], "us-east-1",
                                            chunk_size=STREAM_CHUNK)
        else:
            h = auth.sign_request(creds, method, path, query, h, body)
        h.pop("host")
        return h, body

    def send(method: str, path: str, query=(), headers=None, body=b"", sign: bool = True,
             fresh: bool = False, tamper: bool = False) -> tuple[int, dict, bytes, float]:
        query = list(query)
        headers = dict(headers or {})
        if sign:
            headers, body = signed(method, path, query, headers, body)
            if tamper:
                headers["authorization"] = headers["authorization"][:-4] + "0000"
        url = urllib.parse.quote(path) + ("?" + urllib.parse.urlencode(query) if query else "")
        c = None if fresh else getattr(local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(host, timeout=600)
        t0 = time.perf_counter()
        c.request(method, url, body=body, headers=headers)
        r = c.getresponse()
        data = r.read()
        dt = time.perf_counter() - t0
        if fresh or r.will_close:
            c.close()
            if not fresh:
                local.conn = None
        else:
            local.conn = c
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data, dt

    def fan_out(fn, items, threads: int) -> tuple[list, float]:
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(fn, items))
        return out, time.perf_counter() - t0

    def register(seed: int, n: int, max_size: int, stem: str) -> int:
        objects.update(Traffic(seed, n, max_size, stem).data)
        return n

    def register_bytes(name: str, seed: int, nbytes: int) -> int:
        objects[name] = memoryview(np.random.default_rng(seed).bytes(nbytes))
        return nbytes

    def put(names: list, headers: dict, threads: int) -> dict:
        def one(name):
            st, h, body, dt = send("PUT", f"/bench/{name}", headers=headers.get(name), body=objects[name])
            if st != 200:
                raise AssertionError(f"PUT {name}: {st} {body[:300]!r}")
            return dt, h.get("etag", "")
        out, wall = fan_out(one, names, threads)
        return {"latencies": [o[0] for o in out], "etags": [o[1] for o in out], "wall": wall,
                "bytes": sum(len(objects[n]) for n in names)}

    def get(names: list, threads: int) -> dict:
        def one(name):
            st, _, body, dt = send("GET", f"/bench/{name}")
            if st != 200 or body != objects[name]:
                raise AssertionError(f"GET {name}: status {st}, {len(body)} bytes, "
                                     f"want 200 and {len(objects[name])} equal bytes")
            return dt
        lat, wall = fan_out(one, names, threads)
        return {"latencies": lat, "wall": wall, "bytes": sum(len(objects[n]) for n in names)}

    def multipart(name: str, part_size: int, threads: int) -> dict:
        t0 = time.perf_counter()
        st, _, body, dt0 = send("POST", f"/bench/{name}", [("uploads", "")])
        if st != 200:
            raise AssertionError(f"initiate {name}: {st} {body[:300]!r}")
        uid = ET.fromstring(body).findtext("{*}UploadId")
        data = objects[name]
        n_parts = -(-len(data) // part_size)

        def part(n):
            st, h, b, dt = send("PUT", f"/bench/{name}", [("partNumber", str(n)), ("uploadId", uid)],
                                body=data[(n - 1) * part_size: n * part_size])
            if st != 200:
                raise AssertionError(f"part {n} of {name}: {st} {b[:300]!r}")
            return dt, h["etag"]
        out, _ = fan_out(part, range(1, n_parts + 1), threads)
        xml = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                      for n, (_, e) in enumerate(out, 1))
        st, _, body, dt1 = send("POST", f"/bench/{name}", [("uploadId", uid)],
                                body=f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>".encode())
        if st != 200:
            raise AssertionError(f"complete {name}: {st} {body[:300]!r}")
        return {"etag": ET.fromstring(body).findtext("{*}ETag"), "wall": time.perf_counter() - t0,
                "latencies": [dt0, *(o[0] for o in out), dt1], "bytes": len(data), "parts": n_parts}

    def list_v2(prefix: str, max_keys: int) -> dict:
        keys, token, pages = [], "", 0
        while True:
            q = [("list-type", "2"), ("max-keys", str(max_keys)), ("prefix", prefix)]
            if token:
                q.append(("continuation-token", token))
            st, _, body, _ = send("GET", "/bench", q)
            if st != 200:
                raise AssertionError(f"ListObjectsV2: {st} {body[:300]!r}")
            root = ET.fromstring(body)
            keys += [e.findtext("{*}Key") for e in root.findall("{*}Contents")]
            pages += 1
            if root.findtext("{*}IsTruncated") != "true":
                return {"keys": keys, "pages": pages}
            token = root.findtext("{*}NextContinuationToken")

    def ranges(names: list) -> int:
        """One HEAD and three Range GETs (first byte, a 1 MiB window, a
        suffix of 100) of each object, and an If-None-Match GET: 304."""
        checks = 0
        for name in names:
            data, n = objects[name], len(objects[name])
            st, h, _, _ = send("HEAD", f"/bench/{name}")
            if st != 200 or int(h["content-length"]) != n:
                raise AssertionError(f"HEAD {name}: {st} {h}")
            lo = n // 3
            for spec, want, first in (("bytes=0-0", data[:1], 0), (f"bytes={lo}-{lo + MiB - 1}", data[lo:lo + MiB], lo),
                                      ("bytes=-100", data[-100:], n - 100)):
                st, h2, body, _ = send("GET", f"/bench/{name}", headers={"Range": spec})
                rng = f"bytes {first}-{first + len(want) - 1}/{n}"
                if st != 206 or body != want or h2.get("content-range") != rng:
                    raise AssertionError(f"GET {name} {spec}: {st} {h2.get('content-range')} want {rng}")
                checks += 1
            st, _, _, _ = send("GET", f"/bench/{name}", headers={"If-None-Match": h["etag"]})
            if st != 304:
                raise AssertionError(f"GET {name} If-None-Match: {st}, want 304")
            checks += 2
        return checks

    def delete(names: list) -> int:
        xml = "".join(f"<Object><Key>{n}</Key></Object>" for n in names)
        st, _, body, _ = send("POST", "/bench", [("delete", "")], body=f"<Delete>{xml}</Delete>".encode())
        deleted = body.count(b"<Deleted>")
        if st != 200 or deleted != len(names) or b"<Error>" in body:
            raise AssertionError(f"DeleteObjects: {st}, {deleted} deleted of {len(names)}: {body[:300]!r}")
        return deleted

    def request(method: str, path: str, query=(), headers=None, body=b"", sign=True, tamper=False) -> tuple:
        st, h, data, _ = send(method, path, query, headers, body, sign=sign, fresh=True, tamper=tamper)
        return st, h, data[:4096]

    ops = {"register": register, "register_bytes": register_bytes, "put": put, "get": get,
           "multipart": multipart, "list_v2": list_v2, "ranges": ranges, "delete": delete, "request": request}
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            conn.close()
            return
        try:
            conn.send(("ok", ops[msg[0]](*msg[1:])))
        except Exception as e:  # noqa: BLE001 - sent back and raised in the parent
            conn.send(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class HttpClient:
    """The parent's handle on the client process: call(op, *args) runs one
    command there and returns its result, or raises its error here."""

    def __init__(self, endpoint: str):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_client_main, args=(child, endpoint), daemon=True)
        self._proc.start()
        child.close()

    def call(self, op: str, *args):
        self._conn.send((op, *args))
        status, res = self._conn.recv()
        if status != "ok":
            raise AssertionError(f"S3 client {op}: {res}")
        return res

    def close(self) -> None:
        try:
            if self._proc.is_alive():
                with contextlib.suppress(OSError):
                    self._conn.send(("stop",))
            self._proc.join(30)
        finally:
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(10)


def _percentile(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else float("nan")


def phase_http(smi: str, state: SimpleNamespace, codec, tally: Tally, kernels: dict, rates: dict,
               n_put: int = 512, n_get_old: int = 512, big_mib: int = 128, part_mib: int = 8,
               threads: int = HTTP_THREADS, seed: int = 6, degraded_set: int = 0) -> dict:
    """Phase 5's deployment behind the port's S3Server, driven by signed
    HTTP from a client process: see the module docstring."""
    from minio_tpu_torch.api.server import S3Server, ThreadedServer
    from minio_tpu_torch.control.iam import IAMSys
    from minio_tpu_torch.control.pubsub import GLOBAL_TRACE

    layer, old = state.layer, state.traffic
    planes = Planes()
    new = Traffic(seed, n_put, state.max_size, stem="http")
    ts = ThreadedServer(S3Server(layer, IAMSys(*HTTP_CREDS), check_skew=True))
    endpoint = ts.start()
    client = HttpClient(endpoint)
    paths = {}
    clock_keys = ("device_encode_seconds", "device_verify_seconds", "device_recon_seconds",
                  "batches_run", "small_batches_run", "verify_batches_run", "recon_batches_run")

    def report(path: str, res: dict, n_objects: int, before: dict, direct: list) -> None:
        """A path's rate, client latency, codec clocks, launches by shape
        and estimated device time, beside the direct-layer rates."""
        wall, lat = res["wall"], res["latencies"]
        after = codec.stats()
        counts = paths[path]
        dev_ms = _device_ms(counts, kernels)
        side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                         for k in direct if k in rates)
        log(f"{path}: {n_objects} objects in {wall:.3f} s, {n_objects / wall:.1f} objects/s, "
            f"{res['bytes'] / 2**30 / wall:.4f} GiB/s; client latency p50 {_percentile(lat, 50) * 1e3:.1f} ms, "
            f"p99 {_percentile(lat, 99) * 1e3:.1f} ms over {len(lat)} requests"
            + (f"; direct layer, same run: {side}" if side else "") + f" [{smi}]")
        log(f"{path} codec clocks: " + json.dumps({k: round(after[k] - before[k], 4) for k in clock_keys}))
        log(f"{path}: launches by shape class {json.dumps(_shape_summary(counts))}; device time estimated "
            f"from them {dev_ms / 1e3:.3f} s of {wall:.3f} s wall ({100 * dev_ms / 1e3 / wall:.2f}%)")

    try:
        t0 = time.perf_counter()
        client.call("register", seed, n_put, state.max_size, "http")
        client.call("register", state.seed, len(old.names), state.max_size, "obj")
        log(f"http: S3Server at {endpoint}, client process ready in {time.perf_counter() - t0:.2f} s "
            f"({n_put} new objects, {new.sizes.sum() / MiB:.1f} MiB)")

        # 1. http_put: the new objects, one in 8 REDUCED_REDUNDANCY.
        # One signed PUT and one GET of a 4 MiB object with a GLOBAL_TRACE
        # subscriber: each is one span tree keyed by its x-amz-request-id.
        traced = "trace/put-4mib"
        body = np.random.default_rng(seed + 4).bytes(4 * MiB)
        q = GLOBAL_TRACE.subscribe()
        try:
            st_put, h_put, _ = client.call("request", "PUT", f"/bench/{traced}", (), None, body)
            # Lose the part files of the drives holding data rows 1-4, so
            # the GET rebuilds them and its tree has the codec's span too.
            for p_i, d_i in _holders(layer, traced):
                drive = layer.pools[p_i].disks[d_i]
                if drive.read_version("bench", traced).erasure.index <= 4:
                    _remove_parts_of(drive, traced)
            st_get, h_get, head = client.call("request", "GET", f"/bench/{traced}")
            time.sleep(0.5)
        finally:
            GLOBAL_TRACE.unsubscribe(q)
        if (st_put, st_get) != (200, 200) or head != body[:len(head)]:
            raise AssertionError(f"traced PUT/GET: {st_put} {st_get}")
        records = []
        while not q.empty():
            records.append(q.get_nowait())
        # A streamed GET sends its headers before the request id is stamped
        # (as the JAX front does), so its trace is found by its root span:
        # the trace id is the request id either way.
        get_ids = [r["trace"] for r in records if r.get("type") == "span" and r["parent"] == ""
                   and r["name"] == "GetObject" and r.get("path") == f"/bench/{traced}"]
        if len(get_ids) != 1:
            raise AssertionError(f"traced GET: {len(get_ids)} GetObject root spans")
        for label, rid in (("PUT", h_put["x-amz-request-id"]), ("GET", get_ids[0])):
            tree = _trace_tree(records, rid)
            if not {"api", "object", "erasure"} <= set(tree["layers"]):
                raise AssertionError(f"traced {label}: layers {tree['layers']}")
            log(f"http trace {label} 4 MiB (request id {rid}): one tree of {tree['spans']} spans, root "
                f"{tree['root']}, layers {json.dumps(tree['layers'])}, spans {json.dumps(tree['names'])}")

        rrs = {n: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for n in new.names if new.storage_class[n]}
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("put", new.names, rrs, threads)
        planes.read("http_put", len(res["latencies"]), res["bytes"], smi)
        paths["http_put"] = tally.read("http_put")
        _no_host_fallback(codec, "http_put")
        report("http_put", res, n_put, before, ["pools_put_pool1", "pools_put_pool0"])

        # 2. http_get: the new objects and phase 5's survivors in pool 0,
        # byte-exact. (Pool 1's phase-5 objects lost drive 5's copy to
        # phase 5's heal_bucket check, which recreates only the bucket
        # directory: their reads are degraded.)
        first = set(state.first)
        survivors = [n for n in state.live if n in first and n not in state.overwritten]
        olds = survivors[:: max(1, len(survivors) // n_get_old)][:n_get_old]
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("get", new.names + olds, threads)
        planes.read("http_get", len(res["latencies"]), res["bytes"], smi)
        paths["http_get"] = tally.read("http_get", need=("hh256",))
        _no_host_fallback(codec, "http_get")
        report("http_get", res, n_put + len(olds), before, ["pools_get"])
        # A healthy GET rebuilds nothing from the data: a reconstruct is
        # only due where a hedged spare read beat a slow primary (the
        # window then decodes from the spare), at most one group for the
        # window's full blocks and one for its tail.
        rs, wins = paths["http_get"]["launches"]["rs_gf_apply"], planes.degrade_delta()["hedge_wins"]
        if rs > 2 * wins:
            raise AssertionError(f"http_get launched rs_gf_apply {paths['http_get']['rs_gf_apply_by_b_r']} "
                                 f"with {wins} winning hedges")
        if rs:
            log(f"http_get: {rs} rs_gf_apply launches, for {wins} hedged reads that beat their primary")
        same = _in_threads(lambda n: layer.get_object("bench", n)[1] == new.data[n], new.names, threads)
        if not all(same):
            raise AssertionError(f"layer.get_object of HTTP-PUT objects: {same.count(False)} differ")
        log(f"http: every HTTP-PUT object reads back byte-identical through layer.get_object ({n_put})")

        # 3. http_big: one aws-chunked PUT, a multipart upload of 8 MiB parts
        # from 4 threads, both read back.
        big, mpk = "big/http-put", "big/http-multipart"
        client.call("register_bytes", big, seed + 1, big_mib * MiB)
        client.call("register_bytes", mpk, seed + 2, big_mib * MiB)
        before = codec.stats()
        planes.reset()
        tally.reset()
        res_put = client.call("put", [big], {}, 1)
        res_mp = client.call("multipart", mpk, part_mib * MiB, 4)
        res_get = client.call("get", [big, mpk], 1)
        planes.read(
            "http_big", len(res_put["latencies"]) + len(res_mp["latencies"]) + len(res_get["latencies"]),
            4 * big_mib * MiB, smi)
        paths["http_big"] = tally.read("http_big")
        _no_host_fallback(codec, "http_big")
        n_parts = res_mp["parts"]
        if not res_mp["etag"].strip('"').endswith(f"-{n_parts}"):
            raise AssertionError(f"http_big: multipart ETag {res_mp['etag']}, want -{n_parts}")
        res = {"wall": res_put["wall"] + res_mp["wall"] + res_get["wall"], "bytes": 4 * big_mib * MiB,
               "latencies": res_put["latencies"] + res_mp["latencies"] + res_get["latencies"]}
        for label, r, key in (("aws-chunked PUT", res_put, "put_big"), ("multipart", res_mp, "multipart"),
                              ("GET of both", res_get, "get_big")):
            d = rates.get(key)
            log(f"http_big {label}: {r['bytes'] / 2**30 / r['wall']:.4f} GiB/s"
                + (f"; direct layer, same run ({key}): {d['gib_per_s']:.4f} GiB/s" if d else "") + f" [{smi}]")
        report("http_big", res, 4, before, [])
        log(f"http_big: {big_mib} MiB aws-chunked PUT, {n_parts} x {part_mib} MiB multipart (ETag -{n_parts}), "
            f"both GET byte-exact")

        # 4. http_degraded_get: the part files of 4 drives of one set of pool 0
        # removed (2 for a 14+2 object), every object of that set read back.
        sets0 = state.sets0
        disks = sets0.sets[degraded_set].disks
        targets = [n for n in survivors if sets0.get_set_index(n) == degraded_set]
        lost_drives = (2, 5, 9, 14)
        removed = 0
        for name in targets:
            for i in lost_drives[:2] if old.storage_class[name] else lost_drives:
                for dirpath, _, files in os.walk(os.path.join(disks[i].root, "bench", name)):
                    for f in files:
                        if f.startswith("part."):
                            os.remove(os.path.join(dirpath, f))
                            removed += 1
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("get", targets, threads)
        planes.read("http_degraded_get", len(res["latencies"]), res["bytes"], smi)
        paths["http_degraded_get"] = tally.read("http_degraded_get")
        _no_host_fallback(codec, "http_degraded_get")
        report("http_degraded_get", res, len(targets), before, ["pools_degraded_get"])
        log(f"http_degraded_get: {len(targets)} objects of pool 0's set {degraded_set} byte-exact with "
            f"{removed} part files of drives {lost_drives} removed")

        # 5. Checks with no rate of their own.
        by_class = {}
        for n in new.names:
            by_class.setdefault(_size_class(len(new.data[n])), n)
        checks = client.call("ranges", [by_class[c] for c in sorted(by_class)])
        log(f"http: HEAD, three Range GETs and an If-None-Match 304 on one object of each size class "
            f"{sorted(by_class)}: {checks} checks ok")
        listed = client.call("list_v2", "", 1000)
        own, _, _ = _list_all(layer, "bench", max_keys=1000)
        if listed["keys"] != own:
            raise AssertionError(f"ListObjectsV2: {len(listed['keys'])} keys, the layer lists {len(own)}")
        gone = new.names[: min(128, n_put // 4)]
        client.call("delete", gone)
        after_delete = client.call("list_v2", "", 1000)
        if set(gone) & set(after_delete["keys"]) or len(after_delete["keys"]) != len(own) - len(gone):
            raise AssertionError("DeleteObjects: deleted keys are still listed")
        log(f"http: ListObjectsV2 in {listed['pages']} pages of 1,000 equals the layer's listing "
            f"({len(own)} keys); POST ?delete of {len(gone)} keys, then they are gone from the listing")
        key = f"/bench/{new.names[-1]}"
        refusals = {
            "unsigned GET": (client.call("request", "GET", key, (), None, b"", False), 403, "AccessDenied"),
            "tampered signature": (client.call("request", "GET", key, (), None, b"", True, True), 403,
                                   "SignatureDoesNotMatch"),
        }
        late = "tenant-00/2024-01-01/http-deadline"
        planes.reset()
        refusals["expired deadline PUT"] = (client.call(
            "request", "PUT", f"/bench/{late}", (), {"X-Mtpu-Deadline": "0.0005"},
            np.random.default_rng(seed + 3).bytes(512 << 10)), 503, "SlowDownWrite")
        aborts = planes.degrade_delta()["deadline_aborts"]
        if sum(aborts.values()) != 1:
            raise AssertionError(f"the expired-deadline PUT recorded deadline aborts {aborts}, want one")
        log(f"http: the expired-deadline PUT recorded one deadline abort {json.dumps(aborts)}")
        for label, ((st, _, body), want_st, want_code) in refusals.items():
            code = ET.fromstring(body).findtext("Code") if body else ""
            if (st, code) != (want_st, want_code):
                raise AssertionError(f"{label}: {st} {code}, want {want_st} {want_code}")
        if client.call("list_v2", late, 1000)["keys"]:
            raise AssertionError("the PUT refused for its deadline is listed")
        log("http refusals ok: unsigned GET 403 AccessDenied, tampered signature 403 SignatureDoesNotMatch, "
            "X-Mtpu-Deadline 0.0005 PUT 503 SlowDownWrite and not listed")
    finally:
        client.close()
        ts.stop()
    return paths


# -- phase 7: the fault plane on the card ---------------------------------------------------

P7_THREADS = 16
BITROT_DRIVE, BREAKER_DRIVES, P7_OTHERS = 5, (2, 9), (0, 4, 8, 12)
CRASH_SPECS = (
    "put.mid-commit:kill:8",
    "put.mid-commit:kill:13",
    "storage.append-iov.torn:torn-kill",
    "multipart.complete.partial:kill",
)


def _drive_name(i: int) -> str:
    return f"drive{i:02d}"  # zero-padded: a fault's target substring names one drive


def _fault_set(root: str, codec, wrap: bool = True):
    """A 16-drive 12+4 set with a bucket "bench", made under `root` or
    opened there again (the restart); with `wrap`, each drive is the stack
    Node builds, MeteredDrive(HealthGatedDrive(FaultyDisk(LocalDrive)))."""
    from minio_tpu_torch.chaos.disk import FaultyDisk
    from minio_tpu_torch.object.erasure import ErasureObjects
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.breaker import HealthGatedDrive
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.storage.metered import MeteredDrive

    fresh = not os.path.isdir(root)
    drives = []
    for i, f in enumerate(fmt.init_format(1, DRIVES)):
        d = os.path.join(root, _drive_name(i))
        if fresh:
            os.makedirs(d)
            f.save(d)
        drive = LocalDrive(d)
        drives.append(MeteredDrive(HealthGatedDrive(FaultyDisk(drive))) if wrap else drive)
    eo = ErasureObjects(drives, parity=M, codec=codec)
    if fresh:
        eo.make_bucket("bench")
    return eo, drives


def _remove_parts_of(drive, name: str) -> int:
    removed = 0
    for dirpath, _, files in os.walk(os.path.join(drive.root, "bench", name)):
        for f in files:
            if f.startswith("part."):
                os.remove(os.path.join(dirpath, f))
                removed += 1
    return removed


def _remove_parts(drives, indices, name: str) -> int:
    return sum(_remove_parts_of(drives[i], name) for i in indices)


def _crash_payloads(big_mib: int) -> dict:
    rng = np.random.default_rng(70)
    return {"acked": rng.bytes(big_mib * MiB), "victim": rng.bytes(big_mib * MiB + 37),
            "part1": rng.bytes(5 * MiB), "part2": rng.bytes(MiB + 37)}


def _crash_child(root: str, spec: str, device: str, big_mib: int) -> None:
    """A process that dies at a crash point: it PUTs (and so acknowledges)
    one object, arms MTPU_CRASH through chaos.crash.arm_from_env, then PUTs
    the victim (a multipart upload for a multipart point) and must die
    there. Exit code 3 means the point never fired."""
    from minio_tpu_torch.chaos import crash
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    codec = BatchingDeviceCodec(max_batch=64, device=device)
    eo, _ = _fault_set(root, codec, wrap=False)
    data = _crash_payloads(big_mib)
    eo.put_object("bench", "acked", data["acked"])
    os.environ["MTPU_CRASH"] = spec
    crash.arm_from_env()
    if spec.startswith("multipart."):
        mp = eo.multipart
        uid = mp.new_multipart_upload("bench", "victim")
        parts = [(n, mp.put_object_part("bench", "victim", uid, n, data[f"part{n}"]).etag) for n in (1, 2)]
        mp.complete_multipart_upload("bench", "victim", uid, parts)
    else:
        eo.put_object("bench", "victim", data["victim"])
    os._exit(3)


def _debris(root: str) -> list[str]:
    """Stage debris left under a drive: tmp entries, pid-scoped stage files
    and atomic-write .tmp files."""
    out = []
    tmp = os.path.join(root, ".minio_tpu.sys", "tmp")
    if os.path.isdir(tmp):
        out += [os.path.join(tmp, n) for n in os.listdir(tmp)]
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files if ".tmp." in f or re.search(r"\.tmp[0-9a-f]{8}$", f)]
    return out


def phase_crash(root: str, codec, tally: Tally, device: str = "cuda", crash_mib: int = 4) -> dict:
    """7d: four spawned processes die at crash points; the restart scan
    recovers their drives (see the module docstring)."""
    import multiprocessing as mp

    from minio_tpu_torch.storage import recovery
    from minio_tpu_torch.utils import errors

    ctx = mp.get_context("spawn")
    roots = [os.path.join(root, f"crash{j}") for j in range(len(CRASH_SPECS))]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_crash_child, args=(r, spec, device, crash_mib), daemon=True)
             for r, spec in zip(roots, CRASH_SPECS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if codes != [137] * len(procs):
        raise AssertionError(f"7d: crash children exited {codes}, want 137 each")
    log(f"7d: {len(procs)} children died with rc 137 at {list(CRASH_SPECS)} in {time.perf_counter() - t0:.1f} s")
    data = _crash_payloads(crash_mib)
    tally.reset()
    recovery.reset_counters()
    for r, spec in zip(roots, CRASH_SPECS):
        ceo, cdrives = _fault_set(r, codec, wrap=False)
        scans = collections.Counter()
        for d in cdrives:
            scans.update(recovery.recover_drive(d))
        handed = []
        delta = recovery.recover_set(ceo, heal=lambda b, o, v: handed.append((b, o, v)))
        for b, o, v in handed:
            ceo.heal_object(b, o, version_id=v)
        try:
            got = ceo.get_object("bench", "victim")[1]
        except errors.ObjectNotFound:
            got = None
        want = data["part1"] + data["part2"] if spec.startswith("multipart.") else data["victim"]
        if got is not None and got != want:
            raise AssertionError(f"7d {spec}: the victim reads back but differs")
        debris = [p for d in cdrives for p in _debris(d.root)]
        if debris:
            raise AssertionError(f"7d {spec}: debris left after recovery: {debris[:8]}")
        _remove_parts(cdrives, P7_OTHERS, "acked")
        if ceo.get_object("bench", "acked")[1] != data["acked"]:
            raise AssertionError(f"7d {spec}: the acknowledged object differs")
        log(f"7d {spec}: victim {'absent (rolled back)' if got is None else 'byte-exact'}; recover_drive "
            f"{json.dumps({k: v for k, v in scans.items() if v})}; recover_set {json.dumps(delta)}; healed "
            f"{len(handed)}; no debris; the acknowledged object byte-exact with drives {P7_OTHERS} lost")
    counts = tally.read("faults_crash_recovery")
    log(f"7d recovery counters: {json.dumps(recovery.counters())}")
    return counts


def phase_faults(smi: str, root: str, codec, tally: Tally, rates: dict, device: str = "cuda",
                 n_small: int = 128, big_mib: int = 16, n_big: int = 8, rot_mib: int = 4, n_rot: int = 16,
                 crash_mib: int = 4, small_max: int = 4 * MiB, threads: int = P7_THREADS) -> dict:
    """The fault plane on the card: see the module docstring."""
    from minio_tpu_torch.chaos import faults
    from minio_tpu_torch.control.profiler import GLOBAL_PROFILER, thread_role
    from minio_tpu_torch.storage import breaker
    from minio_tpu_torch.utils import errors

    paths = {}
    planes = Planes()
    base = os.path.join(root, "faults")
    eo, drives = _fault_set(base, codec)

    # 7a. The drive stack Node builds.
    rng = np.random.default_rng(71)
    traffic = Traffic(72, n_small, small_max, stem="p7")
    objects = {f"p7/big-{i}": memoryview(rng.bytes(big_mib * MiB)) for i in range(n_big)}
    objects.update(traffic.data)
    names = list(objects)
    nbytes = sum(len(v) for v in objects.values())
    tally.reset()
    planes.reset()
    t0 = time.perf_counter()
    _in_threads(lambda n: eo.put_object("bench", n, objects[n]), names, threads)
    put_s = time.perf_counter() - t0

    def get_all(label: str) -> float:
        t = time.perf_counter()
        same = _in_threads(lambda n: eo.get_object("bench", n)[1] == objects[n], names, threads)
        if not all(same):
            raise AssertionError(f"{label}: {same.count(False)} objects differ")
        return time.perf_counter() - t

    get_s = get_all("7a GET")
    side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                     for k in ("put_big", "get_big", "pools_put_pool0", "pools_get") if k in rates)
    log(f"7a drive stack: PUT {len(names)} objects ({nbytes / MiB:.1f} MiB) {len(names) / put_s:.1f} objects/s, "
        f"{nbytes / 2**30 / put_s:.4f} GiB/s; GET {len(names) / get_s:.1f} objects/s, "
        f"{nbytes / 2**30 / get_s:.4f} GiB/s; direct layer, same run: {side} [{smi}]")
    ewma: dict = {}
    for d in drives:
        for api, rec in d.api_latencies().items():
            ewma.setdefault(api, []).append(rec)
    log("7a metered per-API latency EWMA over 16 drives (ms min/median/max, calls, errors): " + json.dumps({
        api: [round(min(r["ewma_ms"] for r in v), 3), round(float(np.median([r["ewma_ms"] for r in v])), 3),
              round(max(r["ewma_ms"] for r in v), 3), sum(r["count"] for r in v), sum(r["errors"] for r in v)]
        for api, v in sorted(ewma.items())}))
    planes.read("7a drive stack (PUT and GET)", None, nbytes, smi)
    if not GLOBAL_PROFILER.ensure_started():
        raise AssertionError("the continuous profiler did not start (MTPU_PROFILE=0?)")
    try:
        get2_s = get_all("7a GET with the profiler on")
        time.sleep(1.0)  # the GIL probe calibrates on its first ticks
        summary = GLOBAL_PROFILER.summary()
    finally:
        GLOBAL_PROFILER.stop()
    samples = sum(summary["roles"].values()) or 1
    shares = {role: round(n / samples, 4) for role, n in sorted(summary["roles"].items(), key=lambda kv: -kv[1])}
    log(f"7a profiler on: GET {len(names) / get2_s:.1f} objects/s, {nbytes / 2**30 / get2_s:.4f} GiB/s "
        f"(off: {nbytes / 2**30 / get_s:.4f} GiB/s); gil_load {summary['gil_load']}; sampler overhead "
        f"{summary['sampler_overhead_ratio']}; role shares {json.dumps(shares)} [{smi}]")
    roles = {thread_role(n) for n in ("encode-batch-12-4", "encode-batch-small-12-4", "drive-io-lane_0",
                                      "put-stager", "get-stager", "etag-md5", "drive-io_3")}
    if "other" in roles:
        raise AssertionError(f"a port thread name maps to no profiler role: {roles}")
    paths["faults_drive_stack"] = tally.read("faults_drive_stack")

    # 7b. Bitrot on one drive's writes: caught by hh256 on GET, rebuilt by rs_gf_apply.
    rot = {f"p7/rot-{i}": rng.bytes(rot_mib * MiB) for i in range(n_rot)}
    fid = faults.REGISTRY.arm(faults.FaultSpec(kind="bitrot", target=_drive_name(BITROT_DRIVE), seed=73))
    try:
        _in_threads(lambda n: eo.put_object("bench", n, rot[n]), list(rot), threads)
    finally:
        injected = faults.REGISTRY.injected_counts()
        faults.REGISTRY.disarm(fid)
    tally.reset()
    same = _in_threads(lambda n: eo.get_object("bench", n)[1] == rot[n], list(rot), threads)
    if not all(same):
        raise AssertionError(f"7b GET over bitrot: {same.count(False)} objects differ")
    paths["faults_bitrot_get"] = counts = tally.read("faults_bitrot_get")
    log(f"7b bitrot: {json.dumps({f'{k[0]}@{k[1]}': v for k, v in injected.items()})} writes flipped on "
        f"{_drive_name(BITROT_DRIVE)}; {n_rot} GETs byte-exact, rs_gf_apply rebuilt in "
        f"{counts['launches']['rs_gf_apply']} launches")
    tally.reset()
    healed = [eo.heal_object("bench", n) for n in rot]
    removed = sum(_remove_parts(drives, P7_OTHERS, n) for n in rot)
    same = [eo.get_object("bench", n)[1] == rot[n] for n in rot]
    if not all(same):
        raise AssertionError(f"7b GET after heal with drives {P7_OTHERS} lost: {same.count(False)} differ")
    paths["faults_bitrot_heal"] = tally.read("faults_bitrot_heal")
    rewritten = sum(1 for h in healed if h.disks_healed)
    log(f"7b heal rewrote the flipped shard of {rewritten} of {n_rot} objects; GET byte-exact with "
        f"{removed} part files of drives {P7_OTHERS} removed")

    # 7c. Two drives fail every call: their breakers open, PUT and GET go on.
    planes.reset()
    fids = [faults.REGISTRY.arm(faults.FaultSpec(kind="drive-error", target=_drive_name(i), probability=1.0))
            for i in BREAKER_DRIVES]
    more = {f"p7/breaker-{i}": rng.bytes(rot_mib * MiB) for i in range(n_rot)}
    try:
        for i in BREAKER_DRIVES:
            br = drives[i].breaker
            for _ in range(br.error_threshold):
                try:
                    drives[i].disk_info()
                except errors.FaultyDisk:
                    pass
            if br.state != breaker.OPEN or drives[i].is_online():
                raise AssertionError(f"7c: {_drive_name(i)} breaker {br.snapshot()}, online {drives[i].is_online()}")
        tally.reset()
        _in_threads(lambda n: eo.put_object("bench", n, more[n]), list(more), threads)
        check = {**more, **{n: objects[n] for n in names[: 2 * n_rot]}}
        same = _in_threads(lambda n: eo.get_object("bench", n)[1] == check[n], list(check), threads)
        if not all(same):
            raise AssertionError(f"7c GET with two breakers open: {same.count(False)} differ")
        paths["faults_breaker"] = tally.read("faults_breaker")
    finally:
        for f in fids:
            faults.REGISTRY.disarm(f)
    t0 = time.perf_counter()
    while any(drives[i].breaker.state != breaker.CLOSED for i in BREAKER_DRIVES):
        if time.perf_counter() - t0 > drives[0].breaker.max_cooldown * 1.1 + 1:
            raise AssertionError("7c: a breaker did not re-close within max_cooldown: "
                                 + json.dumps([drives[i].breaker.snapshot() for i in BREAKER_DRIVES]))
        time.sleep(0.05)
    closed_s = time.perf_counter() - t0
    deg = planes.degrade_delta()
    log(f"7c breakers: {[_drive_name(i) for i in BREAKER_DRIVES]} opened after "
        f"{drives[BREAKER_DRIVES[0]].breaker.error_threshold} errors each, {len(more)} PUTs and {len(check)} GETs "
        f"byte-exact with both offline, both re-closed by their probe {closed_s:.2f} s after the faults were "
        f"disarmed; degrade records {json.dumps(deg)}; DriveBusy sheds {deg['sheds'].get('drive', 0)}")
    for d in drives:
        d.breaker.close()

    paths["faults_crash_recovery"] = phase_crash(root, codec, tally, device, crash_mib)
    shutil.rmtree(base, ignore_errors=True)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    dev = torch.device("cuda", 0)
    smi = phase_gpu_and_build()
    kernels = phase_kernels(dev)
    log_phase_end("phases 1-2")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    tally = Tally()
    rates: dict = {}
    try:
        eo, drives, payloads, lost, main_counts = phase_slice(dev, smi, root, codec, tally, rates=rates)
        paths = {"put_get_degraded_get": main_counts}
        paths.update(phase_heal(smi, eo, drives, codec, tally, payloads, lost))
        paths.update(phase_multipart(smi, root, eo, codec, tally, rates=rates))
        phase_object_ops(eo, drives)
        paths.update(phase_whole_file(eo, drives, tally))
        log_phase_end("phases 3-4")
        shutil.rmtree(os.path.join(root, "gpu"), ignore_errors=True)
        pool_paths, state = phase_pools(smi, root, codec, tally, kernels, rates=rates)
        paths.update(pool_paths)
        log_phase_end("phase 5")
        paths.update(phase_http(smi, state, codec, tally, kernels, rates))
        log_phase_end("phase 6")
        del state
        for d in ("pool0", "pool1"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        paths.update(phase_faults(smi, root, codec, tally, rates))
        log_phase_end("phase 7")
    finally:
        tally.uninstall()
        codec.close()
        shutil.rmtree(root, ignore_errors=True)
    for name, rec in kernels.items():
        rec["launches"] = main_counts["launches"][name]
        rec["launches_by_path"] = {path: c["launches"][name] for path, c in paths.items()}
    for path in (p for p in paths if p.startswith("pools")):
        summary = _shape_summary(paths[path])
        for name in kernels:
            kernels[name][f"launches_by_class_{path}"] = summary[name]
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
