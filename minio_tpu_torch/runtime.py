"""Data-plane runtime: install the block codec the server serves with.

The reference's hot path always runs its fast codec (AVX2 reedsolomon,
cmd/erasure-coding.go:63). Here the decision happens once at boot: every
PutObject, GET verify, degraded GET and heal block goes through the
cross-request batching codec (parallel/batching.py), whose kernels run on
the card. There is no host fallback: when the card cannot be probed, no
codec is installed and the install raises, so boot fails. The numpy
``HostCodec`` serves only when the caller names it
(``MINIO_TPU_CODEC=host``), and the plain torch versions of the kernels only
when the caller asks for ``device="cpu"``.

Device init is probed in a bounded subprocess first (``_probe_child.py``:
CUDA init, the kernel library, one launch of each kernel held against its
plain version and the boot goldens), because a wedged driver or a kernel
build that hangs must never wedge server boot. The probe
 * runs exactly once per process (cached -- repeated Node builds / tests
   must not fork probe swarms),
 * is spawned in its own session and killed as a process group on timeout
   (no orphaned children holding the device),
 * keeps the child's stdout/stderr tail -- including an in-child
   faulthandler dump of the wedged stack -- so a timeout carries evidence.

Env:
    MINIO_TPU_CODEC = auto | device | host   (default auto)
    MINIO_TPU_DEVICE_PROBE_S                 probe timeout, default 60
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess
import sys
import tempfile
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING

from .control.sanitizer import san_lock

if TYPE_CHECKING:
    from .object.codec import BlockCodec


def _codec_mod():
    # Imported on use: the CLI spawns the probe child before it imports
    # torch (object/codec.py does), so that the two overlap.
    from .object import codec

    return codec


@dataclass
class ProbeResult:
    """Outcome of one bounded device-init probe."""

    platform: str | None  # "gpu" on success, "cpu" for a CPU probe, None on failure
    device_kind: str | None = None
    error: str | None = None  # short reason on failure
    detail: str = ""  # stdout+stderr tail (env line, faulthandler dump)

    @property
    def ok(self) -> bool:
        return self.platform not in (None, "cpu")


_live_probe_pgids: set[int] = set()
_probe_lock = san_lock("runtime._probe_lock")
_probe_once_lock = san_lock("runtime._probe_once_lock")  # single-flight: at most one child at a time
_probe_cache: ProbeResult | None = None
_atexit_registered = False


def _reap_live_probes() -> None:
    """Kill any probe process groups still alive at interpreter exit."""
    with _probe_lock:
        pgids = list(_live_probe_pgids)
        _live_probe_pgids.clear()
    for pgid in pgids:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass


def _tail(text: str, limit: int = 4000) -> str:
    return text[-limit:] if len(text) > limit else text


def probe_device(timeout_s: float) -> ProbeResult:
    """Bounded, evidence-preserving, non-leaking probe of the card.

    The child (``minio_tpu_torch._probe_child``) prints the env that steers
    CUDA and arms a faulthandler dump before importing torch, so on timeout
    the captured tail pinpoints the wedge. The child runs in its own
    session; on timeout its whole process group is SIGKILLed, and an atexit
    hook reaps any probe that outlives us (e.g. a daemon-thread caller
    exiting mid-probe).
    """
    global _probe_cache, _atexit_registered
    # Single-flight: concurrent callers must not fork a probe swarm -- the
    # second caller waits and gets the first's cached result.
    with _probe_once_lock:
        with _probe_lock:
            if _probe_cache is not None:
                return _probe_cache
            if not _atexit_registered:
                atexit.register(_reap_live_probes)
                _atexit_registered = True
        return _probe_uncached(timeout_s)


def probe_status() -> ProbeResult | None:
    """The cached probe outcome WITHOUT triggering a probe (the admin perf
    route reads this: a request must never fork a device-init subprocess).
    None until a probe has run."""
    with _probe_lock:
        return _probe_cache


def start_probe(probe_timeout_s: float | None = None) -> None:
    """Spawn the probe child now, on a daemon thread, so that its CUDA init
    overlaps the caller's own imports; a later install_data_plane_codec()
    waits for this verdict (probe_device is single-flight and cached)."""
    if probe_timeout_s is None:
        probe_timeout_s = float(os.environ.get("MINIO_TPU_DEVICE_PROBE_S", "60"))
    # mtpulint: disable=unjoined-thread -- bounded one-shot probe whose
    # timeout caps its life.
    threading.Thread(target=probe_device, args=(probe_timeout_s,), daemon=True, name="codec-probe").start()


def _probe_uncached(timeout_s: float, device: str = "cuda") -> ProbeResult:
    """One probe child on "cuda", or on "cpu" (the plain versions only: a
    verdict that is not ok, for tests)."""
    global _probe_cache
    out_f = tempfile.TemporaryFile(mode="w+b")
    err_f = tempfile.TemporaryFile(mode="w+b")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch._probe_child", str(timeout_s), device],
            stdout=out_f,
            stderr=err_f,
            start_new_session=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
    except OSError as e:
        out_f.close()
        err_f.close()
        result = ProbeResult(None, error=f"spawn failed: {e}")
        with _probe_lock:
            _probe_cache = result
        return result

    pgid = proc.pid  # start_new_session=True -> child leads its own pgrp
    with _probe_lock:
        _live_probe_pgids.add(pgid)
    try:
        try:
            proc.wait(timeout=timeout_s)
            timed_out = False
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                os.killpg(pgid, signal.SIGKILL)
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
    finally:
        with _probe_lock:
            _live_probe_pgids.discard(pgid)

    out_f.seek(0)
    err_f.seek(0)
    # SIGKILL can truncate mid-multibyte-sequence, and driver logs aren't
    # guaranteed UTF-8 -- never let decoding errors mask the evidence.
    stdout = out_f.read().decode("utf-8", errors="replace")
    stderr = err_f.read().decode("utf-8", errors="replace")
    out_f.close()
    err_f.close()
    detail = _tail(stdout + ("\n--- stderr ---\n" + stderr if stderr else ""))

    if timed_out:
        result = ProbeResult(
            None, error=f"device init wedged past {timeout_s:.0f}s (killed pg)", detail=detail
        )
    else:
        ok_line = next(
            (ln for ln in reversed(stdout.splitlines()) if ln.startswith("PROBE_OK ")), None
        )
        if proc.returncode == 0 and ok_line:
            parts = ok_line.split()
            result = ProbeResult(parts[1], parts[2] if len(parts) > 2 else None, detail=detail)
        else:
            failed = next(
                (ln for ln in reversed(stdout.splitlines()) if ln.startswith("[probe] FAILED: ")), None
            )
            reason = f": {failed[len('[probe] FAILED: '):]}" if failed else ""
            result = ProbeResult(None, error=f"probe exit={proc.returncode}{reason}", detail=detail)
    with _probe_lock:
        _probe_cache = result
    return result


def _make_batching(device="cuda"):
    from .control.logging import GLOBAL_LOGGER
    from .parallel.batching import BatchingDeviceCodec

    codec = BatchingDeviceCodec(device=device)
    if codec.device.type != "cuda":
        return codec  # the plain versions have nothing to warm

    # Load the kernel library and make the CUDA context off the serving
    # path: a cold first PutObject should not pay them.
    def _warm():
        try:
            codec.encode([b"\0" * codec.block_size], 12, 4)
        except Exception as e:  # noqa: BLE001 - logged; the first request raises the same
            GLOBAL_LOGGER.error(f"codec warm-up failed: {e}", exc=e)

    # mtpulint: disable=unjoined-thread -- bounded one-shot: encodes a single
    # block and exits on its own; joining would re-serialize boot on it.
    threading.Thread(target=_warm, daemon=True, name="codec-warmup").start()
    return codec


def probe_summary() -> dict:
    """Probe state for the admin perf route, under the JAX runtime's keys.
    Never probes. The verdict is taken once per process and never
    re-probed, so it has no transitions and no recovery posture."""
    st = probe_status()
    return {
        "done": st is not None,
        "ok": bool(st.ok) if st is not None else False,
        "platform": st.platform if st is not None else None,
        "cached": False,
        "transition": None,
        "transition_counts": {"fallback": 0, "recovery": 0},
        "recovery": {"interval_s": 0.0, "armed": False, "reprobes": 0},
    }


def install_data_plane_codec(
    mode: str | None = None,
    probe_timeout_s: float | None = None,
    device="cuda",
) -> BlockCodec:
    """Pick + install the process-wide codec; returns it.

    ``host``: the numpy HostCodec, only because the caller named it.
    ``device``: the batching codec on ``device`` (raises without a card on
    "cuda"). ``auto``: on "cpu", the batching codec with the kernels' plain
    versions and no probe (the caller asked for the CPU); on "cuda", the
    batching codec if the probe's verdict is ok. A failed verdict installs
    nothing and raises RuntimeError with the probe's error and transcript."""
    codec_mod = _codec_mod()
    mode = (mode or os.environ.get("MINIO_TPU_CODEC", "auto")).lower()
    if probe_timeout_s is None:
        probe_timeout_s = float(os.environ.get("MINIO_TPU_DEVICE_PROBE_S", "60"))
    if mode == "host":
        codec: BlockCodec = codec_mod.HostCodec()
    elif mode == "device" or str(device).startswith("cpu"):
        codec = _make_batching(device)
    else:
        result = probe_device(probe_timeout_s)
        if not result.ok:
            why = result.error or f"probe verdict platform={result.platform} (not a card)"
            raise RuntimeError(f"device probe failed: {why}\n{_tail(result.detail, 2000)}")
        codec = _make_batching(device)
    codec_mod.set_default_codec(codec)
    return codec


def shutdown_data_plane(codec: BlockCodec | None = None) -> None:
    """Close the batching codec (if installed); safe to call many times."""
    codec_mod = _codec_mod()
    targets = {id(codec): codec, id(codec_mod._default): codec_mod._default}
    for c in targets.values():
        close = getattr(c, "close", None)
        if close is not None:
            close()
