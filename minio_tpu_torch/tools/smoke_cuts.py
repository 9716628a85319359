"""Phases 5 and 6 (or 8a, 8b, 9b, 10 or 15) of chip_smoke.py at two sizes, in one process on one NVIDIA GPU.

    python3 -m minio_tpu_torch.tools.smoke_cuts [--phase5-only | --phase6-old-gets | --phase8a | --phase8b |
                                                 --phase9b | --phase10 | --phase15]

Run from the root of a checkout, where chip_smoke.py sits. It builds and
times the kernels (chip_smoke.py's phases 1 and 2), then runs phase 5 (the
48-drive two-pool deployment) and phase 6 (the same deployment behind the
S3 front) at two sizes in turns (now, before, before, now: the first run of
a process pays its warm-up), on one codec, and prints each run's seconds
beside the card's name and power limit. By default the sizes are the cut
that kept the script with phase 15 under 1,000 s: phase 5 at 256 objects
now and 512 before, phase 6 at 128 new objects and 64 GETs of phase 5's
survivors now, 256 and 128 before. With --phase5-only it runs phase 5
alone at those two sizes. With --phase6-old-gets it times phase 6's cut
that made room for phase 12: 768 objects and 256 new ones both times,
phase 6's GETs of phase 5's survivors at 128 then and 256 before. Every check of the
phases holds at every size. With --phase8b it times phase 8b (the CLI
deployment of 48 drives: boot, PUT, GET, SIGTERM, restart, crash and
recovery boot) at 32 objects now and 64 before the cut that made room
for phase 14 (64 and 128 for the cut that made room for phase 13). With
--phase10 it times phase 10 (four CLI server processes over one 16-drive
set: PUT, GET, a node killed and healed, the cluster speedtest) at 64
objects now and 128 before the cut that made room for phase 14. With
--phase8a (a Node in process with its probe: PUT, GET, degraded GET, admin
heal, an MRF heal) and --phase9b (the CLI deployment at MTPU_WORKERS = 1,
2 and 4, with 9c's SIGKILL and respawn at 64 PUTs both times) it times
those at 32 objects now and 64 before the cuts that also made room for
phase 14. With --phase15 it times phase 15 (Select over a 12+4 set, the FS
server and the gateways) with its CSV access log at 16 MiB now and 32 MiB
before the cut that kept the whole script under 1,000 s. Exits non-zero
without a CUDA device. (The cuts for phases 10
and 11, from 2,048 to 1,024 and 768 objects and from
512 to 256 old GETs, were timed by this tool at those sizes.)
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

# (label, phase 5's objects, phase 6's GETs of phase 5's survivors, phase 6's new objects)
SIZES = (("now", 256, 64, 128), ("before the cut", 512, 128, 256))
OLD_GET_SIZES = (("now", 768, 128, 256), ("before the cut", 768, 256, 256))
PHASE8B_SIZES = (("now", 32), ("before the cut", 64))
PHASE10_SIZES = (("now", 64), ("before the cut", 128))
PHASE8A_9B_SIZES = (("now", 32), ("before the cut", 64))
PHASE15_SIZES = (("now", 16), ("before the cut", 32))  # the CSV's MiB
ORDER = (0, 1, 1, 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_cuts: no CUDA device", file=sys.stderr)
        return 1
    phase5_only = "--phase5-only" in sys.argv[1:]
    sizes = OLD_GET_SIZES if "--phase6-old-gets" in sys.argv[1:] else SIZES
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from ..parallel.batching import BatchingDeviceCodec

    dev = torch.device("cuda", 0)
    smi = cs.phase_gpu_and_build()
    if "--phase8b" in sys.argv[1:]:
        return _one_phase(cs, smi, "8b", PHASE8B_SIZES, lambda root, n: cs.phase_boot_cli(smi, root, {}, n_objects=n))
    if "--phase10" in sys.argv[1:]:
        return _one_phase(cs, smi, "10", PHASE10_SIZES, lambda root, n: cs.phase_cluster(smi, root, n_objects=n))
    if "--phase9b" in sys.argv[1:]:
        return _one_phase(cs, smi, "9b", PHASE8A_9B_SIZES, lambda root, n: cs.phase_prefork(smi, root, n_objects=n))
    if "--phase15" in sys.argv[1:]:
        codec = BatchingDeviceCodec(max_batch=64, device=dev)
        tally = cs.Tally()
        try:
            return _one_phase(cs, smi, "15", PHASE15_SIZES,
                              lambda root, n: cs.phase_select(smi, root, codec, tally, csv_mib=n), unit="MiB of CSV")
        finally:
            tally.uninstall()
            codec.close()
    if "--phase8a" in sys.argv[1:]:
        tally = cs.Tally()
        try:
            return _one_phase(cs, smi, "8a", PHASE8A_9B_SIZES,
                              lambda root, n: cs.phase_boot_node(smi, root, tally, {}, n_objects=n))
        finally:
            tally.uninstall()
    kernels = cs.phase_kernels(dev)
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    tally = cs.Tally()
    out: dict = {}
    try:
        for label, n_objects, n_get_old, n_put in (sizes[i] for i in ORDER):
            root = tempfile.mkdtemp(prefix="smoke_cuts_")
            try:
                rates: dict = {}
                t = time.perf_counter()
                _, state = cs.phase_pools(smi, root, codec, tally, kernels, n_objects=n_objects, rates=rates)
                phase5_s = time.perf_counter() - t
                phase6_s = None
                if not phase5_only:
                    t = time.perf_counter()
                    cs.phase_http(smi, state, codec, tally, kernels, rates, n_put=n_put, n_get_old=n_get_old)
                    phase6_s = time.perf_counter() - t
            finally:
                shutil.rmtree(root, ignore_errors=True)
            out.setdefault(label, []).append(
                {"n_objects": n_objects, "n_get_old": n_get_old, "n_put": n_put, "phase5_s": phase5_s,
                 "phase6_s": phase6_s})
            p6 = "not run" if phase6_s is None else f"{phase6_s:.1f} s"
            print(f"{label}: phase 5 ({n_objects} objects) {phase5_s:.1f} s, phase 6 ({n_put} new objects, "
                  f"{n_get_old} old GETs) "
                  f"{p6} [{smi}]", flush=True)
    finally:
        tally.uninstall()
        codec.close()
    print(json.dumps({"card": smi, "sizes": out}))
    return 0


def _one_phase(cs, smi: str, phase: str, sizes: tuple, run, unit: str = "objects") -> int:
    """One phase at `sizes` in turns, run(root, n) on a fresh root each
    time (n objects, or n of `unit`); every check of the phase holds."""
    out: dict = {}
    for label, n_objects in (sizes[i] for i in ORDER):
        root = tempfile.mkdtemp(prefix="smoke_cuts_")
        try:
            t = time.perf_counter()
            run(root, n_objects)
            seconds = time.perf_counter() - t
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out.setdefault(label, []).append({"n_objects": n_objects, f"phase{phase}_s": seconds})
        print(f"{label}: phase {phase} ({n_objects} {unit}) {seconds:.1f} s [{smi}]", flush=True)
    print(json.dumps({"card": smi, "sizes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
