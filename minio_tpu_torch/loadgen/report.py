"""Report assembly + SLO judgment + Prometheus rendering for loadgen runs.

The report is the artifact the whole harness exists to produce: one JSON
object (BENCH-style -- tools/perf_gate.py consumes the same single-object
contract) that says what was driven, how the tails looked, where the time
went (cluster stage breakdown), what degraded (hedge/breaker/shed
counters), and whether the scenario's declared SLOs held.

Error-budget burn follows SRE convention: burn = observed error rate /
budgeted error rate. burn <= 1.0 means the run fit its budget; 2.0 means
it burned twice what the SLO allows. Latency SLOs compare the merged p99
per op against the spec's `p99_ms` target.
"""

from __future__ import annotations

from .runner import PhaseResult
from .spec import Scenario

# JSON has no Infinity: burn against a zero budget reports this sentinel.
BURN_CAP = 1e9


def _phase_ops(pr: PhaseResult) -> dict:
    """Per-kind stats for one phase: counts + tails + throughput."""
    from ..control.perf import summarize

    rows = summarize(pr.ledger.snapshot()).get("loadgen", {})
    out: dict = {}
    for kind, counters in sorted(pr.kinds.items()):
        row = dict(rows.get(kind, {}))
        errors = sum(counters["errors"].values())
        total = counters["ok"] + errors
        row.update(
            ok=counters["ok"],
            errors=dict(counters["errors"]),
            error_rate=round(errors / total, 6) if total else 0.0,
            bytes=counters["bytes"],
            ops_per_s=round(total / pr.wall_s, 3) if pr.wall_s else 0.0,
            bytes_per_s=round(counters["bytes"] / pr.wall_s, 1) if pr.wall_s else 0.0,
        )
        out[kind] = row
    return out


def _merged_ops(results: list[PhaseResult]) -> dict:
    """Run-wide per-kind stats: phase ledgers merged bucket-wise."""
    from ..control.perf import merge_snapshots, summarize

    merged = summarize(
        merge_snapshots([pr.ledger.snapshot() for pr in results])
    ).get("loadgen", {})
    wall = sum(pr.wall_s for pr in results)
    out: dict = {}
    kinds = sorted({k for pr in results for k in pr.kinds})
    for kind in kinds:
        ok = sum(pr.kinds.get(kind, {}).get("ok", 0) for pr in results)
        nbytes = sum(pr.kinds.get(kind, {}).get("bytes", 0) for pr in results)
        errors: dict[str, int] = {}
        for pr in results:
            for cls, n in pr.kinds.get(kind, {}).get("errors", {}).items():
                errors[cls] = errors.get(cls, 0) + n
        nerr = sum(errors.values())
        total = ok + nerr
        row = dict(merged.get(kind, {}))
        row.update(
            ok=ok,
            errors=errors,
            error_rate=round(nerr / total, 6) if total else 0.0,
            bytes=nbytes,
            ops_per_s=round(total / wall, 3) if wall else 0.0,
            bytes_per_s=round(nbytes / wall, 1) if wall else 0.0,
        )
        out[kind] = row
    return out


def evaluate_slo(scenario: Scenario, merged_ops: dict) -> dict:
    """Judge the run against the spec's declared per-op SLOs.

    Budget burn counts only server-attributable failures (transport + 5xx):
    a 4xx is the workload's shape (racing deletes yield NoSuchKey), not a
    broken promise by the store. The exception is `client_errors_burn: true`
    on the target: a scenario that never deletes and GETs only prepopulated
    keys declares that a NoSuchKey IS a broken promise (an acked object was
    lost), so 4xx burn too."""
    out: dict = {}
    for op, target in sorted(scenario.slo.items()):
        row = merged_ops.get(op)
        if row is None:
            out[op] = {"skipped": "op not exercised by any phase"}
            continue
        server_errors = sum(
            n for cls, n in row.get("errors", {}).items()
            if target.client_errors_burn or not cls.startswith("4xx")
        )
        total = row.get("ok", 0) + sum(row.get("errors", {}).values())
        err_rate = server_errors / total if total else 0.0
        if target.error_budget > 0:
            burn = min(err_rate / target.error_budget, BURN_CAP)
        else:
            burn = 0.0 if server_errors == 0 else BURN_CAP
        p99 = float(row.get("p99_ms", 0.0))
        p99_ok = target.p99_ms <= 0 or p99 <= target.p99_ms
        out[op] = {
            "p99_ms": p99,
            "target_p99_ms": target.p99_ms,
            "p99_ok": p99_ok,
            "error_rate": round(err_rate, 6),
            "error_budget": target.error_budget,
            "budget_burn": round(burn, 3),
            "burn_ok": burn <= 1.0,
            "ok": p99_ok and burn <= 1.0,
        }
    return out


def _evaluate_compare(
    scenario: Scenario, phases: dict
) -> dict | list | None:
    """Cross-phase ratio check(s): the historical single block (dict in,
    dict out) or a sweep (list in, list out -- e.g. put_scaling's one
    ratio per concurrency rung)."""
    cmp = scenario.compare
    if not cmp:
        return None
    if isinstance(cmp, list):
        return [_evaluate_one(c, phases) for c in cmp]
    return _evaluate_one(cmp, phases)


def _evaluate_one(cmp: dict, phases: dict) -> dict:
    op = str(cmp.get("op", "PUT")).upper()
    metric = str(cmp.get("metric", "bytes_per_s"))
    min_ratio = float(cmp.get("min_ratio", 1.0))
    va = phases.get(cmp["a"], {}).get("ops", {}).get(op, {}).get(metric, 0.0)
    vb = phases.get(cmp["b"], {}).get("ops", {}).get(op, {}).get(metric, 0.0)
    ratio = round(float(va) / float(vb), 3) if vb else 0.0
    return {
        "a": cmp["a"],
        "b": cmp["b"],
        "op": op,
        "metric": metric,
        "value_a": va,
        "value_b": vb,
        "ratio": ratio,
        "min_ratio": min_ratio,
        "reproduced": bool(vb) and ratio >= min_ratio,
    }


def evaluate_cache(scenario: Scenario, cache: dict, phases: dict) -> dict | None:
    """Judge the memcache hit ratio against the spec's `cache` block.

    The judged ratio is one phase's counter DELTA when the block names a
    phase (a cold sweep legitimately misses; only the hot storm is held to
    the promise), else the run-cumulative ratio. A spec that declares the
    gate but ran against a cluster without the tier fails loudly -- a
    hot-read scenario silently measuring the uncached path is the worst
    outcome."""
    gate = scenario.cache
    if gate is None:
        return None
    phase_name = gate.get("phase") or ""
    if phase_name:
        row = phases.get(phase_name, {}).get("cache", {})
    else:
        row = cache
    if not row:
        return {
            "min_hit_ratio": gate["min_hit_ratio"],
            "phase": phase_name,
            "error": "no memcache counters (tier disabled? MTPU_MEMCACHE_MB)",
            "ok": False,
        }
    ratio = float(row.get("hit_ratio", 0.0))
    return {
        "min_hit_ratio": gate["min_hit_ratio"],
        "phase": phase_name,
        "hit_ratio": ratio,
        "ok": ratio >= gate["min_hit_ratio"],
    }


def build_report(
    scenario: Scenario,
    results: list[PhaseResult],
    stage_breakdown: dict,
    degrade: dict,
    probe_cached: bool = False,
    lock_profile: dict | None = None,
    profile: dict | None = None,
    cache: dict | None = None,
) -> dict:
    phases: dict = {}
    for pr in results:
        phases[pr.name] = {
            "wall_s": round(pr.wall_s, 3),
            "concurrency": pr.concurrency,
            "executed": pr.executed,
            "generated": pr.generated,
            "truncated": pr.truncated,
            "op_sequence_sha256": pr.op_hash,
            "ops": _phase_ops(pr),
            "timeline": [
                {"t_s": sec, **counts} for sec, counts in sorted(pr.timeline.items())
            ],
            "chaos_windows": pr.chaos_windows,
        }
        if pr.cache:
            phases[pr.name]["cache"] = pr.cache
    merged = _merged_ops(results)
    report = {
        "loadgen_report": 1,
        "scenario": scenario.name,
        "description": scenario.description,
        "seed": scenario.seed,
        "probe_cached": probe_cached,
        "ops": merged,
        "slo": evaluate_slo(scenario, merged),
        "phases": phases,
        "stage_breakdown": stage_breakdown,
        "degrade": degrade,
    }
    if lock_profile:
        # Only present when the run was sanitized (MTPU_TSAN=1): per-lock
        # acquisition counts, contention, and hold/wait time over the phases.
        report["lock_profile"] = lock_profile
    if profile:
        # Only when the scenario asked for it (profile: true / --profile):
        # the continuous-profiling summary -- gil_load, top role-aggregated
        # stacks, sampler overhead, and the per-hop copy ledger -- so the
        # report names the bottleneck, not just the tails.
        report["profile"] = profile
    if cache:
        report["cache"] = dict(cache)
    cache_slo = evaluate_cache(scenario, cache or {}, phases)
    if cache_slo is not None:
        report["cache_slo"] = cache_slo
    cmp = _evaluate_compare(scenario, phases)
    if cmp is not None:
        report["compare"] = cmp
    if scenario.get_miss_is_loss:
        # The crash-consistency verdict: the spec promised every GET-able
        # key was prepopulated and nothing deletes, so a NoSuchKey means an
        # acked object vanished -- the one thing a crash plane must never
        # allow, however clean the tails look.
        misses = sum(
            n
            for cls, n in merged.get("GET", {}).get("errors", {}).items()
            if cls == "4xx:NoSuchKey"
        )
        report["acked_object_loss"] = {"get_miss_count": misses, "ok": misses == 0}
    return report


# -- Prometheus exposition -----------------------------------------------------

_QUANTS = ("p50_ms", "p95_ms", "p99_ms", "p999_ms", "max_ms")


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(report: dict) -> str:
    """The run as minio_tpu_loadgen_* series (tools/metrics_lint.py-clean),
    for pushing a CI run's outcome at a gateway/textfile collector."""
    sc = _esc(str(report.get("scenario", "")))
    lines: list[str] = []

    lines.append(
        "# HELP minio_tpu_loadgen_ops_total Ops executed by the load generator."
    )
    lines.append("# TYPE minio_tpu_loadgen_ops_total counter")
    for op, row in sorted(report.get("ops", {}).items()):
        opl = _esc(op)
        lines.append(
            f'minio_tpu_loadgen_ops_total{{scenario="{sc}",op="{opl}",result="ok"}} '
            f"{row.get('ok', 0)}"
        )
        nerr = sum(row.get("errors", {}).values())
        lines.append(
            f'minio_tpu_loadgen_ops_total{{scenario="{sc}",op="{opl}",result="error"}} '
            f"{nerr}"
        )

    lines.append(
        "# HELP minio_tpu_loadgen_latency_ms Per-op latency quantiles "
        "(bucket-scheme estimates, milliseconds)."
    )
    lines.append("# TYPE minio_tpu_loadgen_latency_ms gauge")
    for op, row in sorted(report.get("ops", {}).items()):
        for q in _QUANTS:
            if q in row:
                lines.append(
                    f'minio_tpu_loadgen_latency_ms{{scenario="{sc}",op="{_esc(op)}",'
                    f'quantile="{q[:-3]}"}} {row[q]}'
                )

    lines.append(
        "# HELP minio_tpu_loadgen_throughput_bytes_per_second Payload throughput per op."
    )
    lines.append("# TYPE minio_tpu_loadgen_throughput_bytes_per_second gauge")
    for op, row in sorted(report.get("ops", {}).items()):
        lines.append(
            "minio_tpu_loadgen_throughput_bytes_per_second"
            f'{{scenario="{sc}",op="{_esc(op)}"}} {row.get("bytes_per_s", 0.0)}'
        )

    lines.append(
        "# HELP minio_tpu_loadgen_slo_burn Error-budget burn per op "
        "(1.0 = exactly on budget)."
    )
    lines.append("# TYPE minio_tpu_loadgen_slo_burn gauge")
    for op, row in sorted(report.get("slo", {}).items()):
        if "budget_burn" in row:
            lines.append(
                f'minio_tpu_loadgen_slo_burn{{scenario="{sc}",op="{_esc(op)}"}} '
                f"{row['budget_burn']}"
            )

    cache = report.get("cache") or {}
    if cache:
        lines.append(
            "# HELP minio_tpu_loadgen_cache_hit_ratio Run-cumulative memcache "
            "hit ratio of the driven cluster."
        )
        lines.append("# TYPE minio_tpu_loadgen_cache_hit_ratio gauge")
        lines.append(
            f'minio_tpu_loadgen_cache_hit_ratio{{scenario="{sc}"}} '
            f"{cache.get('hit_ratio', 0.0)}"
        )
    return "\n".join(lines) + "\n"
