"""Run a loadgen scenario against the port: an in-process cluster or a live endpoint.

Usage:
    python -m minio_tpu_torch.tools.loadgen scenarios/hot_get_storm.yaml
    python -m minio_tpu_torch.tools.loadgen SPEC --device cpu
    python -m minio_tpu_torch.tools.loadgen SPEC --endpoint http://host:9000 \\
        --access-key AK --secret-key SK
    python -m minio_tpu_torch.tools.loadgen SPEC --out report.json --metrics-out report.prom

Without --endpoint, a real multi-node cluster of minio_tpu_torch nodes (shape
from the spec's `cluster` block, overridable with --nodes/--drives) is built
in-process on temp-dir drives, driven, and torn down. Every node serves one
codec built on --device: "cuda" (the default) is the batching codec on the
card, behind the device probe; "cpu" runs the kernels' plain versions. The
final stdout line is the whole report as ONE JSON object; --out additionally
writes it pretty-printed.

Exit 0: ran and every declared SLO held. Exit 1: ran but an SLO was
violated (or the compare block failed to reproduce). Exit 2: could not
run (bad spec, no card for --device cuda, cluster failed to build).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def _log(msg: str) -> None:
    print(f"loadgen: {msg}", file=sys.stderr)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("spec", help="scenario YAML/JSON path")
    ap.add_argument("--endpoint", action="append", default=[],
                    help="live S3 endpoint URL (repeatable for multi-node)")
    ap.add_argument("--access-key", default="")
    ap.add_argument("--secret-key", default="")
    ap.add_argument("--nodes", type=int, default=0, help="override spec cluster.nodes")
    ap.add_argument("--drives", type=int, default=0,
                    help="override spec cluster.drives_per_node")
    ap.add_argument("--seed", type=int, default=None, help="override spec seed")
    ap.add_argument("--profile", action="store_true",
                    help="arm the continuous profiling plane and embed its "
                         "summary (gil_load, role stacks, copy ledger) in "
                         "the report (same as `profile: true` in the spec)")
    ap.add_argument("--out", default="", help="write pretty report JSON here")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus exposition of the report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the in-process cluster's codec device (default cuda)")
    args = ap.parse_args(argv)

    # Sample trace-span publication so high concurrency doesn't flood the
    # hub/slow-ring (the perf ledger still sees every request).
    os.environ.setdefault("MTPU_TRACE_SAMPLE", "0.1")

    from ..loadgen.runner import ScenarioRunner
    from ..loadgen.spec import SpecError, load_scenario
    from ..loadgen.target import EndpointAdmin, InProcessAdmin, S3Target

    try:
        scenario = load_scenario(args.spec)
    except SpecError as e:
        _log(f"bad spec: {e}")
        return 2
    if args.seed is not None:
        scenario.seed = args.seed
    if args.nodes:
        scenario.nodes = args.nodes
    if args.drives:
        scenario.drives_per_node = args.drives
    if args.profile:
        scenario.profile = True

    cluster = None
    workdir = ""
    try:
        if args.endpoint:
            if not args.access_key or not args.secret_key:
                _log("--endpoint needs --access-key and --secret-key")
                return 2
            target = S3Target(args.endpoint, args.access_key, args.secret_key)
            admin = EndpointAdmin(target)
            _log(f"target: live endpoint(s) {args.endpoint}")
        else:
            from ..loadgen.cluster import InProcessCluster

            # Spec-declared env knobs (e.g. MTPU_MEMCACHE_MB for the hot-read
            # tier) must be live before the nodes build. setdefault: the
            # operator's explicit environment wins over the spec.
            for k, v in scenario.env.items():
                os.environ.setdefault(k, v)
            workdir = tempfile.mkdtemp(prefix="mtpu-loadgen-")
            _log(
                f"building in-process cluster on {args.device}: {scenario.nodes} nodes x "
                f"{scenario.drives_per_node} drives x {scenario.pools} pool(s) "
                f"under {workdir}"
            )
            try:
                cluster = InProcessCluster(
                    workdir, scenario.nodes, scenario.drives_per_node,
                    pools=scenario.pools, device=args.device,
                )
            except RuntimeError as e:
                _log(str(e))
                return 2
            target = S3Target(cluster.urls, cluster.root_user, cluster.root_password)
            admin = InProcessAdmin(cluster)

        report = ScenarioRunner(scenario, target, admin, log=_log).run()
    finally:
        if cluster is not None:
            cluster.stop()
        if workdir:
            shutil.rmtree(workdir, ignore_errors=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        _log(f"report written to {args.out}")
    if args.metrics_out:
        from ..loadgen.report import render_prometheus

        with open(args.metrics_out, "w") as f:
            f.write(render_prometheus(report))
        _log(f"metrics written to {args.metrics_out}")

    print(json.dumps(report, sort_keys=True))

    failed = verdict_failures(report)
    for why in failed:
        _log(why)
    return 1 if failed else 0


def verdict_failures(report: dict) -> list[str]:
    """Every verdict of the report that failed, as one line each ([] when all
    held): the SLO rows, the compare blocks, acked-object loss, the cache
    hit-ratio promise and the pool drain gate."""
    out = []
    if not all(row.get("ok", True) for row in report.get("slo", {}).values()):
        out.append("SLO VIOLATED (see report.slo)")
    cmp = report.get("compare")
    cmp_blocks = cmp if isinstance(cmp, list) else [cmp] if isinstance(cmp, dict) else []
    if not all(b.get("reproduced", True) for b in cmp_blocks):
        out.append("compare block did not reproduce (see report.compare)")
    loss = report.get("acked_object_loss")
    if isinstance(loss, dict) and not loss.get("ok", True):
        out.append(
            f"ACKED OBJECT LOSS: {loss.get('get_miss_count')} GET(s) hit "
            "NoSuchKey on a prepopulated, never-deleted key"
        )
    cache_slo = report.get("cache_slo")
    if isinstance(cache_slo, dict) and not cache_slo.get("ok", True):
        out.append("cache hit-ratio promise missed (see report.cache_slo)")
    pools_blk = report.get("pools")
    if isinstance(pools_blk, dict) and not pools_blk.get("ok", True):
        out.append(
            f"pool(s) {pools_blk.get('require_drained')} did not drain within "
            f"{pools_blk.get('max_drain_s')}s (see report.pools)"
        )
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
