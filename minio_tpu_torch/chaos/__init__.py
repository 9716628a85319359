"""Deterministic fault-injection plane.

The robustness analogue of the observability layer: seeded, scoped fault
schedules that wrap the existing StorageAPI / REST seams without forking
them, so the degraded-mode machinery (quorum writes, MRF re-drive, heal
sequences, dsync refresh loss) can be exercised on demand and failures
reproduce exactly under a fixed seed.

Layout:
  faults.py -- FaultSpec + FaultRegistry (the decision engine + budgets)
  disk.py   -- FaultyDisk, a StorageAPI decorator layered under MeteredDrive
  crash.py  -- CrashSpec + CrashRegistry: named process-death points on the
               commit path (kind "crash" on the same admin API)

Everything is disarmed by default; the only cost on the hot path is one
attribute-is-None check per call.
"""

from .crash import CRASH_KIND, KNOWN_POINTS, CrashRegistry, CrashSpec
from .crash import REGISTRY as CRASH_REGISTRY
from .faults import REGISTRY, FaultRegistry, FaultSpec

__all__ = [
    "REGISTRY",
    "FaultRegistry",
    "FaultSpec",
    "CRASH_KIND",
    "CRASH_REGISTRY",
    "CrashRegistry",
    "CrashSpec",
    "KNOWN_POINTS",
]
