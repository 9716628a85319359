"""Phases 5 and 6 of chip_smoke.py at two sizes, in one process on one NVIDIA GPU.

    python3 -m minio_tpu_torch.tools.smoke_cuts [--phase5-only]

Run from the root of a checkout, where chip_smoke.py sits. It builds and
times the kernels (chip_smoke.py's phases 1 and 2), then runs phase 5 (the
48-drive two-pool deployment) and phase 6 (the same deployment behind the
S3 front) at the sizes chip_smoke.py runs (768 objects, 256 GETs of old
objects) and at the sizes they had before phase 5 was cut to make room for
phase 11 (1,024 and 256), in turns (now, before, before, now: the first
run of a process pays its warm-up), on one codec, and prints each run's
seconds beside the card's name and power limit. With --phase5-only it runs
phase 5 alone at both sizes. Every check of the phases holds at both
sizes. Exits non-zero without a CUDA device. (Phase 10's cuts, from 2,048
objects and 512 GETs, were timed by this tool at those sizes.)
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

SIZES = (("now", 768, 256), ("before the cut", 1024, 256))
ORDER = (0, 1, 1, 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_cuts: no CUDA device", file=sys.stderr)
        return 1
    phase5_only = "--phase5-only" in sys.argv[1:]
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from ..parallel.batching import BatchingDeviceCodec

    dev = torch.device("cuda", 0)
    smi = cs.phase_gpu_and_build()
    kernels = cs.phase_kernels(dev)
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    tally = cs.Tally()
    out: dict = {}
    try:
        for label, n_objects, n_get_old in (SIZES[i] for i in ORDER):
            root = tempfile.mkdtemp(prefix="smoke_cuts_")
            try:
                rates: dict = {}
                t = time.perf_counter()
                _, state = cs.phase_pools(smi, root, codec, tally, kernels, n_objects=n_objects, rates=rates)
                phase5_s = time.perf_counter() - t
                phase6_s = None
                if not phase5_only:
                    t = time.perf_counter()
                    cs.phase_http(smi, state, codec, tally, kernels, rates, n_get_old=n_get_old)
                    phase6_s = time.perf_counter() - t
            finally:
                shutil.rmtree(root, ignore_errors=True)
            out.setdefault(label, []).append(
                {"n_objects": n_objects, "n_get_old": n_get_old, "phase5_s": phase5_s, "phase6_s": phase6_s})
            p6 = "not run" if phase6_s is None else f"{phase6_s:.1f} s"
            print(f"{label}: phase 5 ({n_objects} objects) {phase5_s:.1f} s, phase 6 ({n_get_old} old GETs) "
                  f"{p6} [{smi}]", flush=True)
    finally:
        tally.uninstall()
        codec.close()
    print(json.dumps({"card": smi, "sizes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
