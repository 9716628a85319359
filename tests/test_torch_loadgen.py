"""The workload harness of minio_tpu_torch on the CPU (loadgen/ and the
`python -m minio_tpu_torch.tools.loadgen` entry point), held against the JAX
package's.

The cases of tests/test_loadgen.py run on the port: the file is executed with
its `minio_tpu.` imports pointed at `minio_tpu_torch.`, and its smoke cluster
built on device="cpu" (the kernels' plain versions); every other line is the
JAX file's. Then the two packages meet: every shipped scenario parses to the
same Scenario and gives the same op list and op_sequence_hash in both;
build_report and render_prometheus give the same output from the same phase
results; scenarios/smoke.yaml runs end to end on each package's in-process
cluster and the two reports have the same keys and passing verdicts (a
GET racing a DELETE of the same key may burn the GET budget, as the
scenario notes); and the entry point exits 0 when every verdict held (1
when one did not) with the report on its last line on --device cpu, and
2 on cuda without a card. Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import minio_tpu.loadgen as jax_lg
import minio_tpu_torch.loadgen as port_lg
from minio_tpu.loadgen import runner as jax_runner
from minio_tpu.loadgen import target as jax_target
from minio_tpu.loadgen.cluster import InProcessCluster as JaxCluster
from minio_tpu_torch import runtime
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.loadgen import runner as port_runner
from minio_tpu_torch.loadgen import target as port_target
from minio_tpu_torch.loadgen.cluster import InProcessCluster
from minio_tpu_torch.tools.loadgen import verdict_failures

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
SCENARIOS = sorted((REPO / "scenarios").glob("*.yaml"))
PKGS = {"jax": (jax_lg, jax_runner), "port": (port_lg, port_runner)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def rerun_on_port(name: str, subs: list[tuple[str, str, int]], namespace: dict, preset: dict | None = None):
    """Execute tests/<name>.py with each (old, new, count) substitution made
    (each `old` must occur exactly `count` times) and put its test classes,
    test functions and fixtures into `namespace`, so that pytest collects
    them as this file's cases. `preset` seeds the module's globals (names
    whose import line a substitution removed). Returns the module."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new, count in subs:
        assert src.count(old) == count, (name, old, src.count(old))
        src = src.replace(old, new)
    assert "minio_tpu." not in src.replace("minio_tpu_torch.", ""), name
    mod = types.ModuleType(f"tests.{name}__port")
    mod.__file__ = str(path)
    mod.__dict__.update(preset or {})
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for key, val in vars(mod).items():
        fixture = hasattr(val, "_pytestfixturefunction") or type(val).__name__ == "FixtureFunctionDefinition"
        if key.startswith(("Test", "test_")) or fixture:
            namespace[key] = val
    return mod


_PORT_CASES = rerun_on_port(
    "test_loadgen",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 6),
        (
            "InProcessCluster(str(tmp_path), n_nodes=2, drives_per_node=4)",
            'InProcessCluster(str(tmp_path), n_nodes=2, drives_per_node=4, device="cpu")',
            1,
        ),
    ],
    globals(),
)


def test_the_jax_cases_run_on_the_port():
    """All 44 cases of tests/test_loadgen.py were collected here, against the
    port's modules."""
    cases = [
        (cls, m)
        for cls, obj in vars(_PORT_CASES).items()
        if cls.startswith("Test") and isinstance(obj, type)
        for m in vars(obj)
        if m.startswith("test_")
    ]
    assert len(cases) == 44
    assert _PORT_CASES.build_report is port_lg.build_report
    assert _PORT_CASES.PhaseResult is port_runner.PhaseResult


def test_import_checks_cover_loadgen_and_the_caches():
    port = REPO / "minio_tpu_torch"
    files = sorted(port.rglob("*.py"))
    for rel in (
        "loadgen/__init__.py", "loadgen/spec.py", "loadgen/generators.py", "loadgen/target.py",
        "loadgen/runner.py", "loadgen/report.py", "loadgen/cluster.py", "tools/loadgen.py",
        "object/memcache.py", "object/cache.py",
    ):
        assert port / rel in files, rel
    assert sorted(port_lg.__all__) == sorted(jax_lg.__all__)


# -- scenarios, op sequences and reports, package against package --------------------------------


@pytest.mark.parametrize("path", SCENARIOS, ids=[p.stem for p in SCENARIOS])
def test_shipped_scenario_parses_and_replays_equal(path):
    """Same Scenario, and per phase the same op list (the runner's count: the
    op budget, else the duration cap) and op_sequence_hash, in both."""
    jax_sc = jax_lg.load_scenario(str(path))
    port_sc = port_lg.load_scenario(str(path))
    assert dataclasses.asdict(port_sc) == dataclasses.asdict(jax_sc)
    assert port_runner._DURATION_OP_CAP == jax_runner._DURATION_OP_CAP
    for jp, pp in zip(jax_sc.phases, port_sc.phases, strict=True):
        count = pp.ops or port_runner._DURATION_OP_CAP
        j_ops = jax_lg.generate_ops(jax_sc, jp, count)
        p_ops = port_lg.generate_ops(port_sc, pp, count)
        assert [tuple(o) for o in p_ops] == [tuple(o) for o in j_ops], pp.name
        assert port_lg.op_sequence_hash(p_ops) == jax_lg.op_sequence_hash(j_ops)


def test_spec_errors_are_typed_alike(tmp_path):
    """A bad document fails with the same SpecError path and message."""
    bad = {"name": "b", "phases": [{"name": "p", "mix": {"FROB": 1.0}, "ops": 1}]}
    json_path = tmp_path / "bad.json"
    json_path.write_text(json.dumps(bad))
    for load in (lambda m: m.parse_scenario(bad), lambda m: m.load_scenario(str(json_path)),
                 lambda m: m.load_scenario(str(tmp_path / "missing.yaml"))):
        got = []
        for mod in (jax_lg, port_lg):
            with pytest.raises(mod.SpecError) as ei:
                load(mod)
            got.append((ei.value.path, str(ei.value)))
        assert got[0] == got[1]


def _results(lg, runner_mod, sc):
    """The same phase results in one package: kinds, ledger observations,
    timeline, chaos windows and cache deltas of every phase of `sc`."""
    out = []
    for i, ph in enumerate(sc.phases):
        pr = runner_mod.PhaseResult(name=ph.name, concurrency=ph.concurrency, wall_s=1.5 + i,
                                    op_hash=lg.op_sequence_hash(lg.generate_ops(sc, ph, ph.ops or 50)))
        pr.kinds = {
            "GET": {"ok": 90 + 10 * i, "bytes": (90 + 10 * i) << 18,
                    "errors": {"5xx:SlowDownRead": 1, "4xx:NoSuchKey": i}},
            "PUT": {"ok": 12, "bytes": 12 << 12, "errors": {}},
        }
        pr.executed = pr.generated = sum(r["ok"] + sum(r["errors"].values()) for r in pr.kinds.values())
        for k, d in enumerate([0.0012, 0.004, 0.02, 0.3, 0.0007] * (4 + i)):
            pr.ledger.record("loadgen", "GET" if k % 3 else "PUT", d * (1 + i), 0.0001)
        pr.timeline = {0: {"ops": 60, "errors": 1}, 1: {"ops": 40 + i, "errors": i}}
        pr.chaos_windows = [{"at_s": 0.5, "for_s": 1.0, "fault": {"kind": "drive-error"}, "fault_id": "f1"}]
        pr.cache = runner_mod._cache_delta(
            {"hits": 10, "misses": 40, "fills": 40, "evictions": 0, "invalidations": 0, "singleflight_waits": 0},
            {"hits": 10 + 700 * i + 20, "misses": 40 + 60 - 20 * i, "fills": 100, "evictions": 3,
             "invalidations": 1, "singleflight_waits": 4 + i, "bytes": 1 << 25, "entries": 96},
        )
        out.append(pr)
    return out


@pytest.mark.parametrize("name", ["hot_get_storm", "smoke", "put_scaling", "crash_during_put"])
def test_build_report_and_exposition_equal(name):
    """build_report (ops, SLO, phases, cache_slo, compare, acked object loss)
    and render_prometheus give the same output in both packages."""
    reports, texts = [], []
    for lg, runner_mod in PKGS.values():
        sc = lg.load_scenario(str(REPO / "scenarios" / f"{name}.yaml"))
        rep = lg.build_report(
            sc, _results(lg, runner_mod, sc), stage_breakdown={"api": {"GetObject": {"count": 3}}},
            degrade={"sheds": {"api": 1}}, probe_cached=False,
            cache={"hits": 700, "misses": 164, "hit_ratio": 0.81, "bytes": 1 << 25},
        )
        reports.append(rep)
        texts.append(lg.render_prometheus(rep))
    assert reports[1] == reports[0]
    assert texts[1] == texts[0]
    assert verdict_failures(reports[1]) == verdict_failures(reports[0])


def _verdicts_held(report: dict) -> None:
    """Every verdict of a smoke.yaml report holds, but for the one miss the
    scenario itself names: a GET racing a DELETE of the same hot key is
    answered 503 SlowDownRead (neither package locks a GET against a
    delete), and on a loaded machine more of them overlap, so a few can
    burn an SLO row's error budget. Such a row must keep its p99, and its
    errors must be those answers (or a DELETE's 404) and nothing else."""
    failed = verdict_failures(report)
    if not failed:
        return
    assert failed == ["SLO VIOLATED (see report.slo)"], failed
    for op, row in report["slo"].items():
        if not row.get("ok", True):
            assert row["p99_ok"], (op, row)
            errors = report["ops"][op]["errors"]
            assert set(errors) <= {"5xx:SlowDownRead", "5xx:SlowDownWrite", "4xx:NoSuchKey"}, (op, errors)


def _keys(doc, depth: int = 2):
    """The report's key tree to `depth`, less the rows whose names depend on
    the run (per-phase timelines and per-class error counts)."""
    if not isinstance(doc, dict) or depth == 0:
        return type(doc).__name__
    return {k: _keys(v, depth - 1) for k, v in doc.items() if k not in ("errors", "timeline")}


def test_smoke_scenario_on_both_clusters(tmp_path):
    """scenarios/smoke.yaml end to end on the port's InProcessCluster
    (device="cpu") and on the JAX package's: the reports have the same keys
    (ops, SLO rows, phases) and every verdict passes in both."""
    reports = {}
    for name, lg, make_cluster, admin_cls, target_cls in (
        ("jax", jax_lg, lambda d: JaxCluster(d, 2, 4), jax_target.InProcessAdmin, jax_target.S3Target),
        ("port", port_lg, lambda d: InProcessCluster(d, 2, 4, device="cpu"), port_target.InProcessAdmin,
         port_target.S3Target),
    ):
        sc = lg.load_scenario(str(REPO / "scenarios" / "smoke.yaml"))
        cluster = make_cluster(str(tmp_path / name))
        try:
            target = target_cls(cluster.urls, cluster.root_user, cluster.root_password)
            reports[name] = lg.ScenarioRunner(sc, target, admin_cls(cluster)).run()
        finally:
            cluster.stop()
    jax_rep, port_rep = reports["jax"], reports["port"]
    assert port_rep["loadgen_report"] == 1
    assert sorted(port_rep) == sorted(jax_rep)
    assert set(port_rep["slo"]) == set(jax_rep["slo"]) == {"GET", "PUT"}
    for op in set(port_rep["ops"]) & set(jax_rep["ops"]):
        assert _keys(port_rep["ops"][op]) == _keys(jax_rep["ops"][op]), op
    for op in port_rep["slo"]:
        assert sorted(port_rep["slo"][op]) == sorted(jax_rep["slo"][op]), op
    assert _keys(port_rep["phases"]) == _keys(jax_rep["phases"])
    assert port_rep["phases"]["smoke"]["op_sequence_sha256"] == jax_rep["phases"]["smoke"]["op_sequence_sha256"]
    assert port_rep["phases"]["smoke"]["executed"] == 80
    _verdicts_held(port_rep)
    _verdicts_held(jax_rep)
    assert "api" in port_rep["stage_breakdown"] and "sheds" in port_rep["degrade"]


def test_cluster_codec_is_the_callers_or_its_own(tmp_path):
    """Every node of a cluster serves one codec: the caller's, which stop()
    leaves open, or one built on `device`, which stop() closes; without a
    card and without device="cpu" the cluster raises before any node."""
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    mine = BatchingDeviceCodec(device="cpu")
    try:
        cluster = InProcessCluster(str(tmp_path / "a"), 2, 2, codec=mine)
        try:
            assert all(n.codec is mine for n in cluster.nodes)
        finally:
            cluster.stop()
        assert not mine._stop.is_set()
    finally:
        mine.close()
    cluster = InProcessCluster(str(tmp_path / "b"), 2, 2, device="cpu")
    own = cluster.codec
    try:
        assert own.device.type == "cpu"
        assert all(n.codec is own for n in cluster.nodes)
    finally:
        cluster.stop()
    assert own._stop.is_set() and codec_mod._default is not own
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            InProcessCluster(str(tmp_path / "c"), 2, 2)
        assert not os.path.exists(tmp_path / "c")


# -- the entry point -----------------------------------------------------------------------------


def _tool(*args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("MTPU_MEMCACHE")}
    return subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.tools.loadgen", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )


def test_tool_runs_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    prom = tmp_path / "report.prom"
    r = _tool("scenarios/smoke.yaml", "--device", "cpu", "--out", str(out), "--metrics-out", str(prom))
    report = json.loads(r.stdout.strip().splitlines()[-1])
    # Exit 0 when every verdict held, 1 when one did not (tools/loadgen.py's codes).
    assert r.returncode == (1 if verdict_failures(report) else 0), r.stderr[-3000:]
    _verdicts_held(report)
    assert report["loadgen_report"] == 1 and report["scenario"] == "smoke"
    assert report["phases"]["smoke"]["executed"] == 80
    assert json.loads(out.read_text()) == report
    assert prom.read_text() == port_lg.render_prometheus(report)
    assert "building in-process cluster on cpu" in r.stderr


def test_tool_exit_codes_without_a_card(tmp_path):
    """Exit 2 for a spec it cannot read, and for device cuda with no card
    (naming the missing card); nothing is printed on stdout."""
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    r = _tool(str(bad), "--device", "cpu")
    assert (r.returncode, r.stdout) == (2, "") and "bad spec" in r.stderr
    if torch.cuda.is_available():
        return
    r = _tool("scenarios/smoke.yaml")
    assert (r.returncode, r.stdout) == (2, ""), r.stderr[-2000:]
    assert "no CUDA card" in r.stderr


@pytest.mark.cuda
def test_cuda_smoke_scenario_launches_both_kernels(tmp_path, cuda_device):
    """smoke.yaml on a cluster whose one codec runs on the card: the
    prepopulate and the phase launch both kernels, and every verdict holds."""
    from minio_tpu_torch.ops import highwayhash_cuda, rs_cuda
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    codec = BatchingDeviceCodec(device=cuda_device)
    rs0, hh0 = rs_cuda.KERNEL.launches, highwayhash_cuda.KERNEL.launches
    try:
        sc = port_lg.load_scenario(str(REPO / "scenarios" / "smoke.yaml"))
        cluster = InProcessCluster(str(tmp_path), 2, 4, codec=codec)
        try:
            target = port_target.S3Target(cluster.urls, cluster.root_user, cluster.root_password)
            report = port_lg.ScenarioRunner(sc, target, port_target.InProcessAdmin(cluster)).run()
        finally:
            cluster.stop()
    finally:
        codec.close()
    assert verdict_failures(report) == []
    assert rs_cuda.KERNEL.launches > rs0 and highwayhash_cuda.KERNEL.launches > hh0


def teardown_module(module):
    Node.close_all()
    runtime.shutdown_data_plane()
