"""The flight recorder of minio_tpu_torch on the CPU (control/flight.py),
held against the JAX package's.

Each package gets a FlightRecorder over its own directory, a fresh PerfSys
and DegradeStats, and the same inputs under a pinned clock: root spans, one
second of GET traffic with errors and a slow request, then shed, breaker and
deadline-abort counts. The triggers are fixed by those inputs (no wall-clock
window): the same reasons fire at the same polls, the cooldown suppresses
the same poll, and the incidents, the bundle files (names and JSON, less the
capture time and the process-wide profiler summary, compared by keys), the
listings, the retention and the counters are equal. A peer's incident is
filed under the peer's tag in both. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import pytest

from minio_tpu.control import degrade as jax_degrade
from minio_tpu.control import flight as jax_flight
from minio_tpu.control import perf as jax_perf
from minio_tpu_torch.control import degrade, flight, perf

PKGS = {"jax": (jax_flight, jax_perf, jax_degrade), "port": (flight, perf, degrade)}
NOW = 1_760_000_100.0
PEER = "http://10.0.0.2:9000"


def _scenario(mod, perf_mod, deg_mod, d: str, monkeypatch) -> dict:
    clock = {"t": NOW - 5}
    monkeypatch.setattr(time, "time", lambda: clock["t"])
    fl = mod.FlightRecorder(dir=d, window_s=30, cooldown_s=60, retain=3, err_rate=0.5, min_ops=5, p99_ms=200,
                            perf=perf_mod.PerfSys(), degrade=deg_mod.DegradeStats())
    fl.register_node("http://10.0.0.1:9000")
    for i in range(6):
        clock["t"] = NOW - 5 + i * 0.5
        span = SimpleNamespace(name="s3.GetObject", layer="api", trace_id=f"trace-{i}")
        fl.record_span(span, 0.001 * (i + 1), error="NoSuchKey" if i % 2 else None)
    for i in range(10):
        fl.perf.timeseries.record("get", 0.6 if i == 0 else 0.002, ok=i >= 6, nbytes=100, now=NOW - 1)
    out: dict = {"fired": [], "incidents": []}
    clock["t"] = NOW
    out["fired"].append(fl.check_triggers(NOW))  # error-spike and p99; the degrade baseline
    fl._last_sec_checked = 0  # judge the same second again, through poll_once
    fl._deg_prev = None
    out["incidents"].append(fl.poll_once(NOW))
    fl.degrade.record_shed("api")
    fl.degrade.record_breaker(True)
    for _ in range(3):
        fl.degrade.record_deadline_abort("shard-read")
    clock["t"] = NOW + 1
    out["incidents"].append(fl.poll_once(NOW + 1))  # fires, muted by the cooldown
    for i in range(3):
        clock["t"] = NOW + 100 + i
        out["incidents"].append(fl.trigger("manual", detail={"via": "test", "n": i}, now=NOW + 100 + i))
        os.utime(os.path.join(d, f"flight-{out['incidents'][-1]['incident']}__http-10.0.0.1-9000.json"),
                 (NOW + 100 + i, NOW + 100 + i))
    clock["t"] = NOW + 200
    out["peer"] = fl.capture({"incident": "20251009T000000-manual-9", "reason": "manual", "t0": NOW - 30,
                              "t1": NOW, "origin": PEER}, node=PEER)
    out["peer_again"] = fl.capture({"incident": "20251009T000000-manual-9", "t1": NOW}, node=PEER)
    out["files"] = sorted(os.listdir(d))
    out["bundles"] = {f: json.load(open(os.path.join(d, f))) for f in out["files"]}
    out["list"] = fl.list()
    out["get_incident"] = fl.get(out["incidents"][0]["incident"])
    out["get_missing"] = fl.get("nope")
    st = fl.stats()
    st.pop("dir")
    out["stats"] = st
    monkeypatch.undo()
    return out


@pytest.fixture()
def runs(tmp_path, monkeypatch):
    return {name: _scenario(*mods, str(tmp_path / name), monkeypatch) for name, mods in PKGS.items()}


def _strip(bundle: dict) -> dict:
    b = dict(bundle)
    assert isinstance(b.pop("captured_at"), float)
    b.pop("profiler")
    return b


def test_triggers_fire_the_same_reasons(runs):
    assert runs["port"]["fired"] == runs["jax"]["fired"]
    assert [r for r, _ in runs["port"]["fired"][0]] == ["error-spike", "p99"]


def test_incidents_equal(runs):
    assert runs["port"]["incidents"] == runs["jax"]["incidents"]
    inc = runs["port"]["incidents"]
    assert inc[0]["reason"] == "error-spike" and inc[0]["detail"]["also"] == ["p99"]
    assert inc[1] is None  # the cooldown mutes the degrade edges a second later
    assert [i["reason"] for i in inc[2:]] == ["manual"] * 3


def test_bundle_files_and_json_equal(runs):
    j, p = runs["jax"], runs["port"]
    assert p["files"] == j["files"]
    assert len([f for f in p["files"] if f.endswith("__http-10.0.0.1-9000.json")]) == 3  # retain 3 per node
    assert f"flight-20251009T000000-manual-9__{flight._safe_tag(PEER)}.json" in p["files"]
    for f in p["files"]:
        assert _strip(p["bundles"][f]) == _strip(j["bundles"][f]), f
        assert set(p["bundles"][f]["profiler"]) == set(j["bundles"][f]["profiler"])


def test_bundle_holds_the_window_spans_and_series(runs):
    p = runs["port"]
    (first,) = [b for b in p["bundles"].values() if b["reason"] == "manual" and b["detail"].get("n") == 2]
    assert first["window"] == {"t0": NOW + 102 - 30, "t1": NOW + 102}
    peer = p["bundles"][f"flight-20251009T000000-manual-9__{flight._safe_tag(PEER)}.json"]
    assert peer["node"] == PEER and [s["trace"] for s in peer["spans"]] == [f"trace-{i}" for i in range(6)]
    assert peer["timeseries"]["series"][0]["classes"]["get"]["count"] == 10
    assert p["peer"] == peer["id"] and p["peer_again"] is None


@pytest.mark.parametrize("what", ["list", "get_incident", "get_missing", "stats"])
def test_store_reads_and_counters_equal(runs, what):
    j, p = runs["jax"][what], runs["port"][what]
    if what == "get_incident":
        j, p = _strip(j), _strip(p)
    assert p == j
    if what == "stats":
        assert p["bundles_written"] == 5 and p["bundles_pruned"] == 1 and p["suppressed"] == 1
        assert p["triggers"] == {"error-spike": 1, "manual": 3}
