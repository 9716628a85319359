"""Time the plain HighwayHash-256 (ops/highwayhash_torch.py) on the CPU.

    python3 minio_tpu_torch/tools/plain_hash_time.py [--rows N] [--length L] [--repeat R]

Run from the root of a checkout: it imports that checkout's package (the
working directory goes first on sys.path), so the same file times two
checkouts on one machine, e.g. `cd <parent checkout> && python3
<this checkout>/minio_tpu_torch/tools/plain_hash_time.py`. Hashes N seeded
rows of L bytes (default one 70 KiB row, one shard of a 140 KiB object) R
times and prints each call's seconds and the first digest's leading bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--length", type=int, default=70 * 1024)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from minio_tpu_torch.ops import highwayhash_torch

    data = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (args.rows, args.length), dtype=np.uint8))
    for _ in range(args.repeat):
        t = time.perf_counter()
        digest = highwayhash_torch.hash256_batch(data)
        print(f"{highwayhash_torch.__file__}: [{args.rows}, {args.length}] {time.perf_counter() - t:.4f} s, "
              f"digest[0][:8] {digest[0, :8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
