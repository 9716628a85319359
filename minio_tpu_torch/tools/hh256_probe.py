"""Chain floor and SASS of the HighwayHash-256 kernel on one NVIDIA GPU.

    python3 -m minio_tpu_torch.tools.hh256_probe [--sass FILE]

1. Builds the package's kernels (ops/cuda_build.py) and, beside them, the
   chain probe tools/hh256_chain.cu with ``-Xptxas -v``, which prints the
   registers, shared memory and spills of every kernel in it, hh256_kernel
   included (the probe includes csrc/highwayhash.cu).
2. Runs the probe: one warp applies the kernel's packet update to lanes held
   in registers, with clock64() and %globaltimer around the loop. It prints
   the cycles per packet of one lane-pair thread's dependent chain, the SM
   clock those readings imply, and the chain floor at the production shard
   chunk: (L // 32 + 1 tail + 10 permute) packets x cycles / clock.
3. Disassembles the kernel library with ``cuobjdump -sass`` and counts
   hh256_kernel's instructions by opcode: PRMT (the zipper's byte permutes),
   SHF, LOP3, IMAD.WIDE, IADD3, LDS, LDGSTS (cp.async), and LDL/STL (local
   memory, i.e. spills or dynamically indexed arrays). With ``--sass FILE``
   it also writes hh256_kernel's SASS to FILE.
4. Times hh256 (CUDA events) at [N, 87382] for N from 1 to 4,096 streams:
   one block serves 16 streams, so up to 132 x 16 = 2,112 streams each
   block has an SM of its own.

The last line of standard output is one JSON object with those numbers.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build

PROBE_SOURCE = Path(__file__).resolve().parent / "hh256_chain.cu"
PROBE_BUILD_DIR = cuda_build.BUILD_DIR / "probe"
SHARD_CHUNK = 87_382  # the shard chunk of a 1 MiB block at 12 data shards
PACKETS_PER_TRIP = 16  # kUnroll in tools/hh256_chain.cu
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def build_probe() -> ctypes.CDLL:
    from torch.utils.cpp_extension import load

    PROBE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="hh256_chain_probe",
        sources=[str(PROBE_SOURCE)],
        build_directory=str(PROBE_BUILD_DIR),
        extra_cuda_cflags=cuda_build.NVCC_FLAGS + ["-Xptxas=-v"],
        is_python_module=False,
        verbose=True,
    )
    lib = ctypes.CDLL(str(path))
    lib.hh256_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.hh256_chain_launch.restype = ctypes.c_int
    return lib


def chain_cycles(lib: ctypes.CDLL, chunks: int) -> dict:
    """Cycles and nanoseconds per packet of the update chain, median over the warp."""
    dev = torch.device("cuda", 0)
    seed = torch.from_numpy(np.random.default_rng(4).integers(0, 2**63, 32 * 10, dtype=np.int64)).to(dev)
    out = torch.zeros(32 * 3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):  # the first run warms the clocks and the instruction cache
        rc = lib.hh256_chain_launch(seed.data_ptr(), out.data_ptr(), chunks, stream)
        if rc:
            raise RuntimeError(f"hh256_chain_launch: CUDA error {rc}")
        torch.cuda.synchronize()
    got = out.view(32, 3).cpu().numpy()
    packets = chunks * PACKETS_PER_TRIP
    cycles = float(np.median(got[:, 0])) / packets
    ns = float(np.median(got[:, 1])) / packets
    return {"packets": packets, "cycles_per_packet": cycles, "ns_per_packet": ns, "clock_ghz": cycles / ns}


def kernel_sass(library: Path, kernel: str = "hh256_kernel") -> list[str]:
    """The SASS lines of one kernel in a built library (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True,
    ).stdout
    lines, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        if inside:
            lines.append(line)
    return lines


def sass_counts(lines: list[str]) -> dict:
    counts: collections.Counter = collections.Counter()
    for line in lines:
        m = _SASS_OPCODE.search(line)
        if m:
            op = m.group(1)
            counts[op if op.startswith("IMAD.WIDE") else op.split(".")[0]] += 1
    keep = ("PRMT", "SHF", "LOP3", "IMAD.WIDE.U32", "IADD3", "LDS", "LDGSTS", "LDL", "STL", "SHFL", "BAR")
    return {"total": sum(counts.values()), **{k: counts.get(k, 0) for k in keep}}


def sweep_ms(ns=(1, 16, 64, 256, 1024, 2048, 4096), iters: int = 10) -> dict:
    """hh256 kernel ms at [N, SHARD_CHUNK] for each N (CUDA events)."""
    from ..ops import highwayhash_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    out = {}
    for n in ns:
        x = torch.randint(0, 256, (n, SHARD_CHUNK), dtype=torch.uint8, generator=gen).to(dev)
        highwayhash_cuda.hash256_batch(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            highwayhash_cuda.hash256_batch(x)
        end.record()
        torch.cuda.synchronize()
        out[n] = start.elapsed_time(end) / iters
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("hh256_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    library = cuda_build.build_all()
    lib = build_probe()
    packets = SHARD_CHUNK // 32 + 1 + 10
    short = chain_cycles(lib, -(-packets // PACKETS_PER_TRIP))
    long = chain_cycles(lib, 100 * -(-packets // PACKETS_PER_TRIP))
    floor_ms = packets * long["cycles_per_packet"] / (long["clock_ghz"] * 1e9) * 1e3
    lines = kernel_sass(library)
    sass = sass_counts(lines)
    if len(sys.argv) > 2 and sys.argv[1] == "--sass":
        Path(sys.argv[2]).write_text("\n".join(lines) + "\n")
    print(f"chain: {long['cycles_per_packet']:.2f} cycles/packet over {long['packets']} packets "
          f"({short['cycles_per_packet']:.2f} over {short['packets']}), SM clock {long['clock_ghz']:.3f} GHz "
          f"-> chain floor {floor_ms:.4f} ms for {packets} packets [{smi}]")
    print(f"hh256_kernel SASS: {json.dumps(sass)}")
    sweep = sweep_ms()
    print("hh256 ms by N at L = 87,382: " + ", ".join(f"{n}: {ms:.4f}" for n, ms in sweep.items()) + f" [{smi}]")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "smi": smi, "chain": long, "chain_short": short,
        "floor_packets": packets, "chain_floor_ms": floor_ms, "sass_hh256_kernel": sass,
        "hh256_ms_by_n": sweep,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
