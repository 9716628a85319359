"""Scenario-driven workload replayer + SLO harness (ROADMAP item 5).

The "warp" analogue: declarative scenario specs (op mix, zipfian hot-set,
size distributions, concurrency ramp, optional mid-run chaos) replayed
against a real multi-node cluster -- in-process (tests, CI) or a live
endpoint -- with every op recorded into the control/perf.py bucket scheme
and a BENCH-style JSON report of per-op tails, throughput, error-budget
burn, stage breakdown, and degradation counters.

Layering: spec (parse + validate) -> generators (deterministic op
sequences) -> target (signed S3 ops + admin surfaces) -> cluster
(in-process multi-node harness) -> runner (drive it) -> report (judge it).
"""

from .generators import SizeDistribution, ZipfianGenerator, generate_ops, op_sequence_hash
from .report import build_report, evaluate_slo, render_prometheus
from .runner import ScenarioRunner
from .spec import Phase, Scenario, SpecError, load_scenario, parse_scenario

__all__ = [
    "Phase",
    "Scenario",
    "ScenarioRunner",
    "SizeDistribution",
    "SpecError",
    "ZipfianGenerator",
    "build_report",
    "evaluate_slo",
    "generate_ops",
    "load_scenario",
    "op_sequence_hash",
    "parse_scenario",
    "render_prometheus",
]
