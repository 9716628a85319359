"""Scenario spec: declarative YAML/JSON workload descriptions, validated
into typed objects with typed errors.

A scenario is the unit of replay AND the unit of SLO accounting: the spec
declares both the traffic (phases of op mixes over a keyspace) and the
promise it is judged against (per-op p99 targets + error budgets). Bad
specs fail fast with SpecError carrying the offending path -- a loadgen
run that silently reinterprets a typo'd field measures the wrong thing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

OP_KINDS = ("GET", "PUT", "DELETE", "LIST", "MULTIPART", "SELECT")

_SIZE_KINDS = ("fixed", "uniform", "lognormal", "choice")


class SpecError(ValueError):
    """A scenario spec failed validation; `path` names the bad field."""

    def __init__(self, path: str, message: str):
        self.path = path
        super().__init__(f"{path}: {message}")


def _require(doc: dict, path: str, key: str, types, default=None, required=False):
    if key not in doc:
        if required:
            raise SpecError(f"{path}.{key}", "required field missing")
        return default
    v = doc[key]
    if not isinstance(v, types) or isinstance(v, bool) and bool not in (
        types if isinstance(types, tuple) else (types,)
    ):
        want = "/".join(
            t.__name__ for t in (types if isinstance(types, tuple) else (types,))
        )
        raise SpecError(f"{path}.{key}", f"expected {want}, got {type(v).__name__}")
    return v


def _number(doc: dict, path: str, key: str, default=None, required=False, minimum=None):
    v = _require(doc, path, key, (int, float), default=default, required=required)
    if v is not None and minimum is not None and v < minimum:
        raise SpecError(f"{path}.{key}", f"must be >= {minimum}, got {v}")
    return v


@dataclass
class SloTarget:
    p99_ms: float = 0.0       # 0 = no latency target declared
    error_budget: float = 1.0  # allowed error fraction; 1.0 = anything goes
    client_errors_burn: bool = False  # 4xx burn budget too (no-delete
    #                                   scenarios: a NoSuchKey = data loss)


@dataclass
class ChaosWindow:
    at_s: float           # offset from phase start when the fault arms
    for_s: float          # how long it stays armed (0 for one-shot admin ops)
    fault: dict | None = None  # chaos/faults.py FaultSpec.from_dict payload
    admin: dict | None = None  # one-shot admin op instead of a fault, e.g.
    #                            {"op": "decommission", "pool": 0}: fired
    #                            once at at_s, never disarmed (exactly one
    #                            of fault/admin per window)


@dataclass
class Phase:
    name: str
    mix: dict[str, float]          # op kind -> weight (normalized)
    concurrency: int = 4
    ramp_s: float = 0.0            # worker start stagger across this window
    ops: int = 0                   # op count budget (0 = duration-bounded)
    duration_s: float = 0.0        # wall budget (0 = op-count-bounded)
    sizes: dict | None = None      # per-phase override of scenario sizes
    zipf_theta: float | None = None  # per-phase key-skew override (a cache
    #                                  scenario drives a uniform cold sweep
    #                                  then a zipfian hot storm)
    chaos: list[ChaosWindow] = field(default_factory=list)


@dataclass
class Scenario:
    name: str
    description: str = ""
    seed: int = 1
    bucket: str = "loadgen"
    nodes: int = 4                 # in-process cluster shape (ignored for live)
    drives_per_node: int = 4
    pools: int = 1                 # server pools in the in-process cluster
    pools_gate: dict | None = None  # {"require_drained": [pool...],
    #                                  "max_drain_s": s}: after the phases,
    #                                  wait for those pools to reach
    #                                  'decommissioned' and gate the run on it
    keys: int = 256                # keyspace size
    prefix: str = "lg/"
    prepopulate: int = 128         # objects PUT before the clock starts
    zipf_theta: float = 0.99       # 0 = uniform key popularity
    sizes: dict = field(default_factory=lambda: {"kind": "fixed", "bytes": 4096})
    multipart_parts: int = 3
    multipart_part_size: int = 5 << 20
    list_max_keys: int = 100
    slo: dict[str, SloTarget] = field(default_factory=dict)
    phases: list[Phase] = field(default_factory=list)
    compare: dict | None = None    # {"a": phase, "b": phase, "op": kind,
    #                                 "metric": ..., "min_ratio": r}
    cache: dict | None = None      # {"min_hit_ratio": r, "phase": name?}:
    #                                 judge the memcache hit ratio (of one
    #                                 phase's delta, or the whole run)
    flight: dict | None = None     # {"phase": name, "max_wait_s": s}: gate
    #                                 the run on the flight recorder -- the
    #                                 named (faulted) phase must auto-capture
    #                                 a bundle on EVERY node whose window
    #                                 overlaps that phase, and the healthy
    #                                 phases must produce none
    env: dict = field(default_factory=dict)  # env knobs the in-process
    #                                 cluster is built under (e.g.
    #                                 MTPU_MEMCACHE_MB); ignored for live
    get_miss_is_loss: bool = False  # scenario never deletes + GETs only
    #                                 prepopulated keys: a GET NoSuchKey is
    #                                 an acked object lost, a hard verdict
    profile: bool = False          # embed the continuous-profiling summary
    #                                (gil_load, role stacks, copy ledger)


def _parse_sizes(doc, path: str) -> dict:
    doc = dict(doc)
    kind = _require(doc, path, "kind", str, default="fixed")
    if kind not in _SIZE_KINDS:
        raise SpecError(f"{path}.kind", f"unknown size kind {kind!r} (want one of {_SIZE_KINDS})")
    doc["kind"] = kind
    if kind == "fixed":
        _number(doc, path, "bytes", required=True, minimum=0)
    elif kind == "uniform":
        lo = _number(doc, path, "min", required=True, minimum=0)
        hi = _number(doc, path, "max", required=True, minimum=0)
        if hi < lo:
            raise SpecError(f"{path}.max", f"max {hi} < min {lo}")
    elif kind == "lognormal":
        _number(doc, path, "mean", required=True, minimum=1)
        _number(doc, path, "sigma", default=1.0, minimum=0)
    else:  # choice
        choices = _require(doc, path, "choices", list, required=True)
        if not choices:
            raise SpecError(f"{path}.choices", "must not be empty")
        for i, c in enumerate(choices):
            if not isinstance(c, dict):
                raise SpecError(f"{path}.choices[{i}]", "expected object")
            _number(c, f"{path}.choices[{i}]", "bytes", required=True, minimum=0)
            _number(c, f"{path}.choices[{i}]", "weight", default=1.0, minimum=0)
    return doc


def _parse_mix(doc, path: str) -> dict[str, float]:
    if not isinstance(doc, dict) or not doc:
        raise SpecError(path, "mix must be a non-empty object of op -> weight")
    mix: dict[str, float] = {}
    for op, w in doc.items():
        opu = str(op).upper()
        if opu not in OP_KINDS:
            raise SpecError(f"{path}.{op}", f"unknown op kind (want one of {OP_KINDS})")
        if not isinstance(w, (int, float)) or isinstance(w, bool) or w < 0:
            raise SpecError(f"{path}.{op}", f"weight must be a number >= 0, got {w!r}")
        mix[opu] = float(w)
    total = sum(mix.values())
    if total <= 0:
        raise SpecError(path, "mix weights sum to zero")
    return {op: w / total for op, w in mix.items()}


def _parse_phase(doc, path: str) -> Phase:
    if not isinstance(doc, dict):
        raise SpecError(path, "phase must be an object")
    name = _require(doc, path, "name", str, required=True)
    mix = _parse_mix(doc.get("mix"), f"{path}.mix")
    ph = Phase(
        name=name,
        mix=mix,
        concurrency=int(_number(doc, path, "concurrency", default=4, minimum=1)),
        ramp_s=float(_number(doc, path, "ramp_s", default=0.0, minimum=0)),
        ops=int(_number(doc, path, "ops", default=0, minimum=0)),
        duration_s=float(_number(doc, path, "duration_s", default=0.0, minimum=0)),
    )
    if "sizes" in doc:
        ph.sizes = _parse_sizes(
            _require(doc, path, "sizes", dict, required=True), f"{path}.sizes"
        )
    if "zipf_theta" in doc:
        theta = float(_number(doc, path, "zipf_theta", required=True, minimum=0))
        if theta >= 1.0:
            raise SpecError(f"{path}.zipf_theta", f"must be < 1.0, got {theta}")
        ph.zipf_theta = theta
    if not ph.ops and not ph.duration_s:
        raise SpecError(path, "phase needs ops or duration_s (both zero)")
    for i, cw in enumerate(doc.get("chaos") or []):
        cpath = f"{path}.chaos[{i}]"
        if not isinstance(cw, dict):
            raise SpecError(cpath, "chaos window must be an object")
        fault = _require(cw, cpath, "fault", dict, default=None)
        admin = _require(cw, cpath, "admin", dict, default=None)
        if (fault is None) == (admin is None):
            raise SpecError(cpath, "chaos window needs exactly one of fault/admin")
        if fault is not None and "kind" not in fault:
            raise SpecError(f"{cpath}.fault", "fault spec needs a 'kind'")
        if admin is not None and "op" not in admin:
            raise SpecError(f"{cpath}.admin", "admin op needs an 'op'")
        ph.chaos.append(
            ChaosWindow(
                at_s=float(_number(cw, cpath, "at_s", default=0.0, minimum=0)),
                for_s=float(
                    _number(cw, cpath, "for_s",
                            required=fault is not None, default=0.0, minimum=0)
                ),
                fault=dict(fault) if fault is not None else None,
                admin=dict(admin) if admin is not None else None,
            )
        )
    return ph


def _parse_slo(doc, path: str) -> dict[str, SloTarget]:
    out: dict[str, SloTarget] = {}
    if doc is None:
        return out
    if not isinstance(doc, dict):
        raise SpecError(path, "slo must be an object of op -> targets")
    for op, t in doc.items():
        opu = str(op).upper()
        if opu not in OP_KINDS:
            raise SpecError(f"{path}.{op}", f"unknown op kind (want one of {OP_KINDS})")
        if not isinstance(t, dict):
            raise SpecError(f"{path}.{op}", "expected object with p99_ms/error_budget")
        budget = _number(t, f"{path}.{op}", "error_budget", default=1.0, minimum=0)
        if budget > 1.0:
            raise SpecError(f"{path}.{op}.error_budget", f"must be <= 1.0, got {budget}")
        out[opu] = SloTarget(
            p99_ms=float(_number(t, f"{path}.{op}", "p99_ms", default=0.0, minimum=0)),
            error_budget=float(budget),
            client_errors_burn=bool(
                _require(t, f"{path}.{op}", "client_errors_burn", bool, default=False)
            ),
        )
    return out


def parse_scenario(doc: dict) -> Scenario:
    """Validate a decoded spec document into a Scenario (raises SpecError)."""
    if not isinstance(doc, dict):
        raise SpecError("$", "scenario must be an object")
    name = _require(doc, "$", "name", str, required=True)
    ks = _require(doc, "$", "keyspace", dict, default={})
    cluster = _require(doc, "$", "cluster", dict, default={})
    sc = Scenario(
        name=name,
        description=_require(doc, "$", "description", str, default=""),
        seed=int(_number(doc, "$", "seed", default=1)),
        bucket=_require(doc, "$", "bucket", str, default="loadgen"),
        nodes=int(_number(cluster, "$.cluster", "nodes", default=4, minimum=1)),
        drives_per_node=int(
            _number(cluster, "$.cluster", "drives_per_node", default=4, minimum=1)
        ),
        pools=int(_number(cluster, "$.cluster", "pools", default=1, minimum=1)),
        keys=int(_number(ks, "$.keyspace", "keys", default=256, minimum=1)),
        prefix=_require(ks, "$.keyspace", "prefix", str, default="lg/"),
        prepopulate=int(_number(ks, "$.keyspace", "prepopulate", default=128, minimum=0)),
        zipf_theta=float(_number(ks, "$.keyspace", "zipf_theta", default=0.99, minimum=0)),
        sizes=_parse_sizes(_require(doc, "$", "sizes", dict, default={"kind": "fixed", "bytes": 4096}), "$.sizes"),
        slo=_parse_slo(doc.get("slo"), "$.slo"),
        compare=_require(doc, "$", "compare", (dict, list), default=None),
        profile=bool(_require(doc, "$", "profile", bool, default=False)),
        get_miss_is_loss=bool(
            _require(doc, "$", "get_miss_is_loss", bool, default=False)
        ),
    )
    if sc.get_miss_is_loss:
        if sc.prepopulate < sc.keys:
            raise SpecError(
                "$.keyspace.prepopulate",
                "get_miss_is_loss needs every GET-able key prepopulated "
                f"(prepopulate {sc.prepopulate} < keys {sc.keys})",
            )
        for i, p in enumerate(doc.get("phases") or []):
            if isinstance(p, dict) and "DELETE" in {
                str(k).upper() for k in (p.get("mix") or {})
            }:
                raise SpecError(
                    f"$.phases[{i}].mix",
                    "get_miss_is_loss scenarios must not DELETE: a racing "
                    "delete makes every GET miss ambiguous",
                )
    mp = _require(doc, "$", "multipart", dict, default={})
    sc.multipart_parts = int(_number(mp, "$.multipart", "parts", default=3, minimum=1))
    sc.multipart_part_size = int(
        _number(mp, "$.multipart", "part_size", default=5 << 20, minimum=1)
    )
    sc.list_max_keys = int(_number(doc, "$", "list_max_keys", default=100, minimum=1))
    if sc.prepopulate > sc.keys:
        raise SpecError("$.keyspace.prepopulate", f"exceeds keyspace keys ({sc.keys})")
    phases = _require(doc, "$", "phases", list, required=True)
    if not phases:
        raise SpecError("$.phases", "must not be empty")
    sc.phases = [_parse_phase(p, f"$.phases[{i}]") for i, p in enumerate(phases)]
    names = [p.name for p in sc.phases]
    if len(set(names)) != len(names):
        raise SpecError("$.phases", f"duplicate phase names: {names}")
    env = _require(doc, "$", "env", dict, default={})
    for k, v in env.items():
        if not isinstance(v, (str, int, float)) or isinstance(v, bool):
            raise SpecError(f"$.env.{k}", f"expected string/number, got {type(v).__name__}")
        sc.env[str(k)] = str(v)
    pg = _require(doc, "$", "pools", dict, default=None)
    if pg is not None:
        req = _require(pg, "$.pools", "require_drained", list, default=[])
        drained: list[int] = []
        for i, p in enumerate(req):
            if not isinstance(p, int) or isinstance(p, bool) or not 0 <= p < sc.pools:
                raise SpecError(
                    f"$.pools.require_drained[{i}]",
                    f"expected pool index 0..{sc.pools - 1}, got {p!r}",
                )
            drained.append(p)
        sc.pools_gate = {
            "require_drained": drained,
            "max_drain_s": float(
                _number(pg, "$.pools", "max_drain_s", default=120.0, minimum=0)
            ),
        }
    cache = _require(doc, "$", "cache", dict, default=None)
    if cache is not None:
        ratio = _number(cache, "$.cache", "min_hit_ratio", required=True, minimum=0)
        if ratio > 1.0:
            raise SpecError("$.cache.min_hit_ratio", f"must be <= 1.0, got {ratio}")
        phase_name = _require(cache, "$.cache", "phase", str, default="")
        if phase_name and phase_name not in names:
            raise SpecError("$.cache.phase", f"unknown phase {phase_name!r}")
        sc.cache = {"min_hit_ratio": float(ratio), "phase": phase_name}
    fl = _require(doc, "$", "flight", dict, default=None)
    if fl is not None:
        phase_name = _require(fl, "$.flight", "phase", str, required=True)
        if phase_name not in names:
            raise SpecError("$.flight.phase", f"unknown phase {phase_name!r}")
        sc.flight = {
            "phase": phase_name,
            "max_wait_s": float(
                _number(fl, "$.flight", "max_wait_s", default=15.0, minimum=0)
            ),
        }
    if sc.compare is not None:
        # One block (dict, the historical shape) or a list of blocks (e.g.
        # a concurrency sweep asserting one ratio per rung).
        is_list = isinstance(sc.compare, list)
        blocks = sc.compare if is_list else [sc.compare]
        if not blocks:
            raise SpecError("$.compare", "must not be empty")
        for bi, blk in enumerate(blocks):
            loc = f"$.compare[{bi}]" if is_list else "$.compare"
            if not isinstance(blk, dict):
                raise SpecError(loc, "compare entry must be an object")
            for k in ("a", "b"):
                pn = _require(blk, loc, k, str, required=True)
                if pn not in names:
                    raise SpecError(f"{loc}.{k}", f"unknown phase {pn!r}")
            _number(blk, loc, "min_ratio", default=1.0, minimum=0)
    return sc


def load_scenario(path: str) -> Scenario:
    """Load + validate a YAML or JSON scenario file."""
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        raise SpecError("$", f"cannot read {path}: {e}") from e
    doc = None
    if path.endswith(".json"):
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError as e:
            raise SpecError("$", f"invalid JSON: {e}") from e
    else:
        try:
            import yaml
        except ImportError as e:  # environment without pyyaml: JSON still works
            raise SpecError("$", "pyyaml unavailable; use a .json spec") from e
        try:
            doc = yaml.safe_load(raw)
        except yaml.YAMLError as e:
            raise SpecError("$", f"invalid YAML: {e}") from e
    return parse_scenario(doc)
