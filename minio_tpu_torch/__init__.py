"""minio_tpu_torch: the erasure object store on PyTorch and CUDA.

A port of the JAX package ``minio_tpu`` to one NVIDIA H100: the same
object layer -- server pools of erasure sets (object/pools.py ServerPools,
object/sets.py ErasureSets, listing through object/metacache.py) over one
erasure set's operations (object/erasure.py: PUT, GET, heal, deletes,
metadata, buckets; object/multipart.py) -- the same batching codec
(parallel/batching.py) and the same on-disk bytes, with the
two device kernels -- Reed-Solomon GF(2^8) coding and HighwayHash-256 --
written by hand in CUDA C++ for sm_90a (csrc/). Entry points run on "cuda"
unless the caller passes device="cpu", where the kernels' plain torch
versions run instead.

The package imports torch, numpy and the standard library only; it keeps
its own copies of the host modules it needs. ``python -m minio_tpu_torch
server <drives>`` boots a server (cli.py).
"""

__version__ = "0.5.0"  # the JAX package's release this port tracks

__all__ = ["ErasureSets", "ServerPools"]


def __getattr__(name: str):
    # Resolved on first use, so that `python -m minio_tpu_torch._probe_child`
    # and the CLI import torch only when they reach for it.
    if name == "ErasureSets":
        from .object.sets import ErasureSets

        return ErasureSets
    if name == "ServerPools":
        from .object.pools import ServerPools

        return ServerPools
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
