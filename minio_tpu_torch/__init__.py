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
its own copies of the host modules it needs.
"""

from .object.pools import ServerPools
from .object.sets import ErasureSets

__all__ = ["ErasureSets", "ServerPools"]
