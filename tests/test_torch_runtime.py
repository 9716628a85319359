"""The port's data-plane runtime (minio_tpu_torch/runtime.py) and its probe
child, against the JAX package's runtime where the two must agree.

The port has no host fallback: ``auto`` installs the batching codec only on
an ok verdict from the probe child, which launches both CUDA kernels. On
this host (no card) the ok verdicts come from a stubbed probe, and the
batching codec it installs is made on "cpu" (the kernels' plain versions);
the real probe child runs here both ways (``cpu``: a verdict that is not ok;
``cuda``: no card, non-zero exit). The card-only cases are marked ``cuda``.
Comparisons with the JAX package are exact: the probe summary's keys, and
the whole summary for the same verdict. The child's outcomes that the card
cannot be made to give on demand (a wedge, a crash, a stray exit code) come
from a stand-in interpreter: a shell script in place of ``sys.executable``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu import runtime as jax_runtime
from minio_tpu_torch import runtime
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.codec import HostCodec
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _close_port_nodes():
    yield
    Node.close_all()
    runtime.shutdown_data_plane()


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Each case starts with no installed codec and no verdict, and leaves
    none behind."""
    prev = codec_mod._default
    codec_mod.set_default_codec(None)
    monkeypatch.setattr(runtime, "_probe_cache", None)
    monkeypatch.delenv("MINIO_TPU_CODEC", raising=False)
    yield
    runtime.shutdown_data_plane()
    codec_mod.set_default_codec(prev)


@pytest.fixture
def cpu_batching(monkeypatch):
    """Make the codec an ok verdict installs on "cpu": there is no card here,
    and BatchingDeviceCodec(device="cuda") raises without one."""
    made = []

    def make(device="cuda"):
        made.append(device)
        return BatchingDeviceCodec(device="cpu")

    monkeypatch.setattr(runtime, "_make_batching", make)
    return made


def _verdict(platform, error=None):
    return lambda t: runtime.ProbeResult(platform, error=error)


def test_install_host_mode_only_when_named():
    codec = runtime.install_data_plane_codec(mode="host")
    assert isinstance(codec, HostCodec)
    assert codec_mod.default_codec() is codec


@pytest.mark.parametrize("mode", ["auto", "device"])
def test_install_on_cpu_runs_the_plain_versions_without_a_probe(monkeypatch, mode):
    def no_probe(t):
        raise AssertionError("device='cpu' must not probe")

    monkeypatch.setattr(runtime, "probe_device", no_probe)
    codec = runtime.install_data_plane_codec(mode=mode, device="cpu")
    assert isinstance(codec, BatchingDeviceCodec) and codec.device.type == "cpu"
    assert codec_mod.default_codec() is codec
    rng = np.random.default_rng(3)
    block = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    assert codec.encode([block], 2, 2) == HostCodec().encode([block], 2, 2)


def test_install_device_mode_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        runtime.install_data_plane_codec(mode="device")
    assert codec_mod._default is None


@pytest.mark.parametrize(
    "verdict",
    [runtime.ProbeResult(None, error="probe exit=1: no CUDA device"), runtime.ProbeResult("cpu", "cpu")],
    ids=["failed", "cpu"],
)
def test_auto_without_an_ok_verdict_installs_nothing_and_raises(monkeypatch, verdict):
    monkeypatch.setattr(runtime, "probe_device", lambda t: verdict)
    with pytest.raises(RuntimeError, match="device probe failed") as exc:
        runtime.install_data_plane_codec(mode="auto")
    assert (verdict.error or "platform=cpu") in str(exc.value)
    assert codec_mod._default is None


def test_ok_verdict_installs_the_batching_codec(monkeypatch, cpu_batching):
    monkeypatch.setattr(runtime, "probe_device", _verdict("gpu"))
    codec = runtime.install_data_plane_codec(mode="auto")
    assert isinstance(codec, BatchingDeviceCodec)
    assert codec_mod.default_codec() is codec
    assert cpu_batching == ["cuda"]


def test_start_probe_then_install_waits_for_its_verdict(monkeypatch, cpu_batching):
    """serve() spawns the probe before its own imports; the install that
    follows waits for that one child's verdict instead of spawning another."""
    calls, release = [], threading.Event()

    def one_child(timeout_s, device="cuda"):
        calls.append(device)
        release.wait(10)
        runtime._probe_cache = runtime.ProbeResult("gpu")
        return runtime._probe_cache

    monkeypatch.setattr(runtime, "_probe_uncached", one_child)
    runtime.start_probe(30)
    _wait_until = time.monotonic() + 5
    while not calls and time.monotonic() < _wait_until:
        time.sleep(0.01)
    threading.Timer(0.2, release.set).start()
    codec = runtime.install_data_plane_codec(mode="auto")
    assert isinstance(codec, BatchingDeviceCodec)
    assert calls == ["cuda"]


@pytest.mark.parametrize("callers", [2, 8])
def test_probe_device_is_single_flight_and_cached(monkeypatch, callers):
    """Concurrent callers share one child; later callers get its verdict."""
    calls, release = [], threading.Event()

    def one_child(timeout_s, device="cuda"):
        calls.append(device)
        release.wait(10)
        runtime._probe_cache = runtime.ProbeResult("gpu", "H100")
        return runtime._probe_cache

    monkeypatch.setattr(runtime, "_probe_uncached", one_child)
    got = []
    threads = [threading.Thread(target=lambda: got.append(runtime.probe_device(30))) for _ in range(callers)]
    for t in threads:
        t.start()
    threading.Timer(0.2, release.set).start()
    for t in threads:
        t.join(15)
    assert calls == ["cuda"]
    assert len(got) == callers and all(r is got[0] for r in got)
    assert runtime.probe_device(30) is got[0] and calls == ["cuda"]


def test_probe_status_never_probes(monkeypatch):
    def must_not_probe(timeout_s, device="cuda"):
        raise AssertionError("probe_status spawned a child")

    monkeypatch.setattr(runtime, "_probe_uncached", must_not_probe)
    assert runtime.probe_status() is None
    verdict = runtime.ProbeResult(None, error="x")
    monkeypatch.setattr(runtime, "_probe_cache", verdict)
    assert runtime.probe_status() is verdict


# A stand-in interpreter for the probe child: ignores its arguments and acts
# out one outcome. ``PROBE_PIDFILE`` receives the pid of a grandchild it leaves
# running, so the wedge case can check that the whole process group died.
CHILDREN = {
    "ok": ('echo "[probe] env: CUDA_HOME=/x"; echo "PROBE_OK gpu NVIDIA_H100_80GB_HBM3"',
           ("gpu", "NVIDIA_H100_80GB_HBM3", None)),
    "failed": ('echo "[probe] env: "; echo "[probe] FAILED: no CUDA device: torch.cuda.is_available() is false";'
               " exit 1",
               (None, None, "probe exit=1: no CUDA device: torch.cuda.is_available() is false")),
    "ok-line-bad-exit": ('echo "PROBE_OK gpu X"; exit 3', (None, None, "probe exit=3")),
    "crash": ('echo "[probe] env: "; echo "Fatal Python error: Segmentation fault" >&2; kill -SEGV $$',
              (None, None, "probe exit=-11")),
    "wedged": ('echo "[probe] env: WEDGE=1"; sleep 60 & echo $! > "$PROBE_PIDFILE"; sleep 60',
               (None, None, "device init wedged past 1s (killed pg)")),
}


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("case", sorted(CHILDREN))
def test_probe_child_outcomes_become_verdicts(tmp_path, monkeypatch, case):
    script, (platform, kind, error) = CHILDREN[case]
    fake = tmp_path / "fake-python"
    fake.write_text("#!/bin/sh\n" + script + "\n")
    fake.chmod(0o755)
    pidfile = tmp_path / "grandchild.pid"
    monkeypatch.setenv("PROBE_PIDFILE", str(pidfile))
    monkeypatch.setattr(sys, "executable", str(fake))
    t0 = time.monotonic()
    result = runtime._probe_uncached(1.0 if case == "wedged" else 30.0)
    assert (result.platform, result.device_kind, result.error) == (platform, kind, error)
    assert result.ok == (case == "ok")
    assert runtime.probe_status() is result
    assert runtime._live_probe_pgids == set()
    if case == "crash":
        assert "Segmentation fault" in result.detail and "--- stderr ---" in result.detail
    if case == "wedged":
        assert "[probe] env: WEDGE=1" in result.detail
        assert time.monotonic() - t0 < 15
        grandchild = int(pidfile.read_text())
        deadline = time.monotonic() + 5
        while not _gone(grandchild):
            assert time.monotonic() < deadline, "the probe's process group outlived the timeout"
            time.sleep(0.05)


def test_atexit_reaps_a_probe_still_running():
    proc = subprocess.Popen(["sleep", "60"], start_new_session=True)
    with runtime._probe_lock:
        runtime._live_probe_pgids.add(proc.pid)
    runtime._reap_live_probes()
    assert proc.wait(5) == -signal.SIGKILL
    assert runtime._live_probe_pgids == set()


def test_shutdown_closes_the_installed_codec_and_is_idempotent():
    codec = runtime.install_data_plane_codec(mode="auto", device="cpu")
    runtime.shutdown_data_plane(codec)
    assert codec._stop.is_set()
    runtime.shutdown_data_plane(codec)
    runtime.shutdown_data_plane()


def test_probe_summary_has_the_jax_keys(monkeypatch):
    monkeypatch.setenv("MTPU_PROBE_RECOVERY_S", "0")
    port, jax = runtime.probe_summary(), jax_runtime.probe_summary()
    assert set(port) == set(jax)
    assert set(port["recovery"]) == set(jax["recovery"])
    assert set(port["transition_counts"]) == set(jax["transition_counts"])
    assert port["recovery"]["interval_s"] == 0.0


@pytest.mark.parametrize(
    "verdict", [None, ("gpu", "H100"), (None, None, "wedged"), ("cpu", "cpu")],
    ids=["no-verdict", "ok", "failed", "cpu"],
)
def test_probe_summary_equals_the_jax_one(monkeypatch, verdict):
    """The port takes one verdict a process and never re-probes: its summary
    is JAX's for the same verdict with no transition and no re-probe."""
    monkeypatch.delenv("MTPU_PROBE_CACHE", raising=False)
    monkeypatch.setenv("MTPU_PROBE_RECOVERY_S", "0")
    for name, value in (("_last_transition", None), ("_recovery_probes", 0), ("_reprobe_thread", None),
                        ("_transition_counts", {"fallback": 0, "recovery": 0})):
        monkeypatch.setattr(jax_runtime, name, value)
    monkeypatch.setattr(jax_runtime, "_probe_cache", verdict and jax_runtime.ProbeResult(*verdict))
    monkeypatch.setattr(runtime, "_probe_cache", verdict and runtime.ProbeResult(*verdict))
    assert runtime.probe_summary() == jax_runtime.probe_summary()


def test_probe_child_on_cpu_is_not_an_ok_verdict():
    result = runtime._probe_uncached(120, "cpu")
    assert result.platform == "cpu" and result.device_kind == "cpu"
    assert not result.ok and result.error is None
    assert "[probe] env:" in result.detail
    assert "[probe] rs_gf_apply ok" in result.detail and "[probe] hh256 ok" in result.detail


def test_probe_child_on_cuda_without_a_card_fails_with_the_transcript():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    result = runtime._probe_uncached(120, "cuda")
    assert not result.ok and result.platform is None
    assert "probe exit=1" in result.error and "no CUDA device" in result.error
    assert "[probe] env:" in result.detail


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_probe_child_on_the_card_launches_both_kernels(cuda_device):
    result = runtime._probe_uncached(300, "cuda")
    assert result.ok and result.platform == "gpu", result.detail
    assert "[probe] rs_gf_apply ok" in result.detail and "[probe] hh256 ok" in result.detail


@pytest.mark.cuda
def test_auto_on_the_card_installs_the_batching_codec(cuda_device):
    codec = runtime.install_data_plane_codec(mode="auto", probe_timeout_s=300)
    assert isinstance(codec, BatchingDeviceCodec) and codec.device.type == "cuda"
    assert runtime.probe_status().platform == "gpu"


@pytest.mark.cuda
def test_two_processes_build_the_library_into_an_empty_build_dir(tmp_path, cuda_device):
    """The probe child and the server both load the kernel library; on a
    fresh tree both may build it at once. cpp_extension.load's file lock in
    the build directory serializes them."""
    code = (
        "import sys, pathlib\n"
        "from minio_tpu_torch.ops import cuda_build\n"
        f"cuda_build.BUILD_DIR = pathlib.Path({str(tmp_path / 'build')!r})\n"
        "cuda_build.library()\n"
        "from minio_tpu_torch._probe_child import main\n"
        "sys.argv = ['probe', '300', 'cuda']\n"
        "sys.exit(main())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().splitlines()[-1].startswith("PROBE_OK gpu ") for o in outs), outs
