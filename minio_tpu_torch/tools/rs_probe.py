"""Registers, SASS and time by batch of the Reed-Solomon kernel on one NVIDIA GPU.

    python3 -m minio_tpu_torch.tools.rs_probe [--sass FILE]

1. Compiles csrc/rs_gf.cu alone with ``nvcc -Xptxas -v`` and prints what
   ptxas says of each kernel in it: registers, shared memory, spill stores
   and loads.
2. Builds the package's kernels (ops/cuda_build.py), disassembles the
   library with ``cuobjdump -sass`` and counts the RS kernel's instructions
   by opcode and width: global loads and stores (LDG.E.128 against
   LDG.E.U8, STG.E.128 against the narrow STG of the edge granules), LDS
   (table lookups), PRMT (the byte transposes and funnel-shift partners),
   SHFL (the neighbour exchange) and LDL/STL (local memory). With
   ``--sass FILE`` it also writes the kernel's SASS to FILE.
3. Checks the kernel against its plain version (the fused encode layout,
   and R = 1..4 rows on rows 1..15 bytes past a 16-byte boundary), then
   times it on that layout, [B, 12+4, 87382] data rows -> parity rows, for B
   in 1..64 (the batcher's buckets): device time from a CUDA graph of
   launches (CUDA events around its replay), rotating over copies that
   together exceed the 50 MB L2 so each launch reads cold rows. Beside it, a
   torch device copy of as many bytes as the B = 64 encode moves.

The last line of standard output is one JSON object with those numbers.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build, rs_cuda, rs_matrix
from .hh256_probe import _SASS_OPCODE, kernel_sass

K, M = 12, 4
SHARD_CHUNK = 87_382  # the shard chunk of a 1 MiB block at 12 data shards
BATCHES = (1, 2, 4, 8, 16, 32, 64)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
KERNEL_NAME = "rs_gf_apply_kernel"
SOURCE = cuda_build.CSRC_DIR / "rs_gf.cu"
_PTXAS_FUNCTION = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
WIDTHS = ("LDGSTS", "LDG.E.128", "LDG.E.64", "LDG.E", "LDG.E.U16", "LDG.E.U8", "STG.E.128", "STG.E.64",
          "STG.E", "STG.E.U16", "STG.E.U8", "LDS", "PRMT", "SHFL", "LDL", "STL")
_WIDTH_SUFFIXES = ("128", "64", "U16", "S16", "U8", "S8")


def ptxas_report() -> dict:
    """ptxas -v of csrc/rs_gf.cu: {kernel: {registers, smem, spill_stores, spill_loads}}."""
    from torch.utils.cpp_extension import CUDA_HOME

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-c", str(SOURCE), "-o", str(out_dir / "rs_gf.o")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    report, name = {}, None
    for line in log.splitlines():
        if m := _PTXAS_FUNCTION.search(line):
            name = m.group(1)
            report[name] = {}
        elif name is not None:
            if m := _PTXAS_USED.search(line):
                report[name]["registers"] = int(m.group(1))
                if s := _PTXAS_SMEM.search(line):
                    report[name]["smem"] = int(s.group(1))
            if m := _PTXAS_SPILL.search(line):
                report[name]["spill_stores"], report[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
    return report


def sass_widths(lines: list[str]) -> dict:
    """Instruction counts by opcode, with global loads and stores keyed by
    their width (LDG.E.128.CONSTANT counts as LDG.E.128, a 32-bit LDG.E.STRONG
    as LDG.E). LDGSTS, the cp.async copy, is keyed by its own name."""
    full: collections.Counter = collections.Counter()
    for line in lines:
        m = _SASS_OPCODE.search(line)
        if m and "@!PT " not in line:  # never-executed padding (e.g. dummy LDS beside LDGSTS)
            full[m.group(1)] += 1
    widths = dict.fromkeys(WIDTHS, 0)
    for op, n in full.items():
        parts = op.split(".")
        if parts[0] in ("LDG", "STG"):
            width = next((p for p in parts[1:] if p in _WIDTH_SUFFIXES), None)
            key = f"{parts[0]}.E.{width}" if width else f"{parts[0]}.E"
        else:
            key = parts[0]
        if key in widths:
            widths[key] += n
    return {"total": sum(full.values()), **widths, "by_opcode": dict(sorted(full.items()))}


def check(dev: torch.device) -> None:
    """The kernel against its plain version: the fused encode layout at
    B = 1 and 16, and R = 1..4 rows on input and output rows 1..15 bytes
    past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(6)
    parity = rs_matrix.parity_matrix(K, M)

    def rand(n):
        return torch.randint(0, 256, n, dtype=torch.uint8, generator=gen).to(dev)

    for b in (1, 16):
        shards = rand((b, K + M, SHARD_CHUNK))
        rs_cuda.apply(shards[:, :K], parity, out=shards[:, K:])
        if not torch.equal(shards[:, K:], rs_cuda.plain(shards[:, :K], parity)):
            raise AssertionError(f"rs_gf_apply disagrees with its plain version at B = {b}")
    present = tuple(i not in (0, 5, 12, 15) for i in range(K + M))
    for s in (17, 4095, SHARD_CHUNK):
        xbuf, obuf = rand((16 + 2 * K * s,)), rand((16 + 2 * M * s,))
        for off in range(1, 16):
            r = 1 + off % 4
            coeffs = rs_matrix.reconstruct_rows(K, M, present, (0, 5, 12, 15)[:r])
            xv = xbuf[off : off + 2 * K * s].view(2, K, s)
            ov = obuf[(7 * off + 3) % 16 :][: 2 * r * s].view(2, r, s)
            rs_cuda.apply(xv, coeffs, out=ov)
            if not torch.equal(ov, rs_cuda.plain(xv, coeffs)):
                raise AssertionError(f"rs_gf_apply disagrees with its plain version: S {s}, offset {off}, R {r}")


def graph_ms(calls: list, reps: int) -> float:
    """Device ms of one call, from a CUDA graph of reps rounds over `calls`
    (so host launch overhead stays out of the reading)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for c in calls:
                c()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def sweep_ms(dev: torch.device, reps: int = 10) -> dict:
    """Device ms of one fused-layout encode launch at [B, 12, 87382] for each
    B, rotating over copies that together exceed the L2."""
    gen = torch.Generator().manual_seed(5)
    parity = rs_matrix.parity_matrix(K, M)
    out = {}
    for b in BATCHES:
        copies = max(2, -(-(64 << 20) // (b * (K + M) * SHARD_CHUNK)))
        bufs = [torch.randint(0, 256, (b, K + M, SHARD_CHUNK), dtype=torch.uint8, generator=gen).to(dev)
                for _ in range(copies)]
        calls = [lambda t=t: rs_cuda.apply(t[:, :K], parity, out=t[:, K:]) for t in bufs]
        out[b] = {"ms": graph_ms(calls, reps), "bound_ms": b * (K + M) * SHARD_CHUNK / HBM_BYTES_PER_S * 1e3}
        del bufs, calls
    return out


def copy_ms(dev: torch.device) -> dict:
    """Device ms of one torch copy that reads and writes as many bytes as the
    B = 64 encode moves in all (a yardstick of the card's rate for mixed
    reads and writes; not used by the port)."""
    n = 64 * (K + M) * SHARD_CHUNK // 2
    bufs = [torch.empty(2 * n, dtype=torch.uint8, device=dev) for _ in range(2)]
    calls = [lambda t=t: t[n:].copy_(t[:n]) for t in bufs]
    return {"bytes": 2 * n, "ms": graph_ms(calls, 10)}


def main() -> int:
    if not torch.cuda.is_available():
        print("rs_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas = ptxas_report()
    for name, rep in ptxas.items():
        print(f"ptxas {name}: {json.dumps(rep)}", flush=True)
    library = cuda_build.build_all()
    lines = kernel_sass(library, KERNEL_NAME)
    sass = sass_widths(lines)
    if len(sys.argv) > 2 and sys.argv[1] == "--sass":
        Path(sys.argv[2]).write_text("\n".join(lines) + "\n")
    print(f"{KERNEL_NAME} SASS: {json.dumps({k: v for k, v in sass.items() if k != 'by_opcode'})}", flush=True)
    check(dev)
    sweep = sweep_ms(dev)
    print("rs_gf_apply encode ms by B at [B, 12, 87382], fused layout: "
          + ", ".join(f"{b}: {r['ms']:.4f} (bound {r['bound_ms']:.4f})" for b, r in sweep.items()) + f" [{smi}]")
    copy = copy_ms(dev)
    print(f"device copy of the B = 64 encode's bytes ({copy['bytes']} read + written): {copy['ms']:.4f} ms [{smi}]")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "ptxas": ptxas,
                      "sass": sass, "encode_ms_by_b": sweep, "copy": copy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
