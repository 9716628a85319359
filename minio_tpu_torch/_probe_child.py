"""Device-probe child: bounded CUDA init and one launch of each kernel.

Run as ``python -m minio_tpu_torch._probe_child <timeout_s> [cuda|cpu]`` in a
fresh process. Prints a transcript on stdout/stderr that the parent
(runtime.probe_device) keeps even on timeout, so a wedged device init or a
kernel build that hangs leaves evidence instead of a bare "timeout" (the
reference hard-fails boot self-tests loudly, cmd/server-main.go:434-436).

What it does, in order:
  * prints the env vars that steer CUDA and torch (CUDA_*, TORCH_*, NVIDIA_*);
  * arms ``faulthandler.dump_traceback_later`` at 85% of the timeout, so a
    wedged frame is dumped to stderr while the parent still listens;
  * imports torch and, on ``cuda``, checks ``torch.cuda.is_available()``,
    loads the kernel library (ops/cuda_build.library(), which builds into
    _build/ on first use) and launches each kernel once: rs_gf_apply on the
    boot golden's input (bytes 0..255 as 4 rows of 64, parity 2) and hh256
    on bytes 0..63. Each result is held against the kernel's plain torch
    version and against the boot goldens (ops/goldens.py).

The last stdout line is ``PROBE_OK gpu <device_name>`` and the exit code 0.
With ``cpu`` the child checks the plain versions against the goldens and
prints ``PROBE_OK cpu cpu``: a verdict that is not ok (runtime.ProbeResult).
Any mismatch or error exits non-zero with the reason.
"""

from __future__ import annotations

import faulthandler
import hashlib
import os
import sys
import time


def _fail(reason: str) -> int:
    print(f"[probe] FAILED: {reason}", flush=True)
    return 1


def main() -> int:
    t0 = time.time()
    timeout_s = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    if device not in ("cuda", "cpu"):
        return _fail(f"unknown device {device!r} (cuda or cpu)")
    env_keys = sorted(k for k in os.environ if k.startswith(("CUDA_", "TORCH_", "NVIDIA_")))
    print("[probe] env: " + " ".join(f"{k}={os.environ[k]}" for k in env_keys), flush=True)

    # Dump the wedged stack while the parent is still listening.
    faulthandler.dump_traceback_later(max(5.0, timeout_s * 0.85), repeat=False, file=sys.stderr)

    import numpy as np  # noqa: PLC0415 - after the diagnostics on purpose
    import torch  # noqa: PLC0415

    from .ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_matrix
    from .ops.goldens import HH_GOLDEN, RS_GOLDEN

    print(f"[probe] import torch ok {time.time() - t0:.1f}s v{torch.__version__}", flush=True)
    if device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA device: torch.cuda.is_available() is false")
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(dev)
        print(f"[probe] device ok {time.time() - t0:.1f}s n={torch.cuda.device_count()} {name}", flush=True)
        from .ops import cuda_build

        cuda_build.library()
        print(f"[probe] kernel library ok {time.time() - t0:.1f}s", flush=True)
    else:
        dev = torch.device("cpu")
        name = "cpu"

    data = torch.frombuffer(bytearray(range(256)), dtype=torch.uint8).reshape(1, 4, 64)
    coeffs = rs_matrix.parity_matrix(4, 2)
    parity = rs_cuda.apply(data.to(dev), coeffs)
    if device == "cuda":
        torch.cuda.synchronize(dev)
    parity = parity.cpu()
    plain = rs_cuda.plain(data, coeffs)
    if not torch.equal(parity, plain):
        return _fail("rs_gf_apply differs from its plain version on the boot golden's input")
    enc = np.concatenate([data[0].numpy(), parity[0].numpy()])
    if hashlib.sha256(enc.tobytes()).hexdigest() != RS_GOLDEN:
        return _fail("Reed-Solomon self-test: the parity differs from the boot golden")
    print(f"[probe] rs_gf_apply ok {time.time() - t0:.1f}s", flush=True)

    row = torch.frombuffer(bytearray(range(64)), dtype=torch.uint8).reshape(1, 64)
    digest = highwayhash_cuda.hash256_batch(row.to(dev)).cpu()
    if not torch.equal(digest, highwayhash_torch.hash256_batch(row)):
        return _fail("hh256 differs from its plain version on bytes 0..63")
    if digest[0].numpy().tobytes().hex() != HH_GOLDEN:
        return _fail("HighwayHash-256 self-test: the digest differs from the boot golden")
    print(f"[probe] hh256 ok {time.time() - t0:.1f}s", flush=True)

    faulthandler.cancel_dump_traceback_later()
    if device == "cuda":
        print(f"PROBE_OK gpu {name.replace(' ', '_')}", flush=True)
    else:
        print("PROBE_OK cpu cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
