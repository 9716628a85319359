"""The Prometheus exposition of minio_tpu_torch on the CPU (control/metrics.py),
held against the JAX package's.

Both packages' `MetricsSys` record the same requests, see the same stub
codec counters and render in a fresh interpreter, so that no earlier test's
process-wide counters leak in: the series names are the JAX names less
exactly the two device-probe series the port does not have (ROADMAP.md,
Departures: the recovery re-probe was not ported), and the request and codec
series carry the same values. `LastMinuteLatency` and `merge_node_texts`
give the same results for the same inputs. A scrape with no codec installed
builds none and loads no host library; a scrape after real batches on a
`BatchingDeviceCodec(device="cpu")` equals that codec's `stats()`, key for
key. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from minio_tpu.control import metrics as jax_metrics
from minio_tpu_torch.control import metrics as port_metrics
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.ops import native
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

# The JAX series the port leaves out (control/metrics.py _render_codec).
DEPARTURES = {"minio_tpu_device_probe_transitions_total", "minio_tpu_device_probe_recovery_interval_seconds"}
SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")

_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    import numpy as np
    os.environ["JAX_PLATFORMS"] = "cpu"
    from minio_tpu.control import metrics as jax_metrics
    from minio_tpu.object import codec as jax_codec
    from minio_tpu_torch.control import metrics as port_metrics
    from minio_tpu_torch.object import codec as port_codec

    STATS = json.loads(sys.argv[1])

    class Stub:
        def stats(self):
            return dict(STATS)

        def queue_depths(self):
            return {"12x4": 3, "14x2-small": 1}

    rng = np.random.default_rng(51)
    calls = [(api, float(rng.random() * 3), bool(rng.random() < 0.8), int(rng.integers(0, 1 << 20)),
              int(rng.integers(0, 1 << 20)))
             for api in ("PutObject", "GetObject", "DeleteObject", "ListObjectsV2") for _ in range(5)]
    out = {}
    for name, mod, cmod in (("jax", jax_metrics, jax_codec), ("port", port_metrics, port_codec)):
        cmod._default = Stub()
        m = mod.MetricsSys()
        for method, status in (("GET", 200), ("PUT", 200), ("GET", 404), ("DELETE", 204)):
            m.record_http(method, status)
        for c in calls:
            m.record_api(*c)
        m.record_encode(16, 123456789)
        out[name] = m.render_node()
    print(json.dumps(out))
""")

STUB_STATS = {
    "blocks_encoded": 1200, "batches_run": 75, "blocks_padded": 1280, "blocks_reconstructed": 48,
    "recon_batches_run": 6, "digests_verified": 4096, "verify_batches_run": 256, "small_blocks_encoded": 90,
    "small_batches_run": 9, "small_blocks_padded": 96, "double_buffered_batches": 11, "mesh_devices": 1,
    "chip_blocks": [1200], "host_fallback_blocks": 0, "host_fallback_recon_blocks": 0,
    "host_fallback_digest_chunks": 0, "device_encode_seconds": 0.1234567, "device_recon_seconds": 0.0213,
    "device_verify_seconds": 1.5,
}


def _series(text: str) -> dict[str, dict[str, str]]:
    """{name: {labels: value}} of every sample line."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = SAMPLE.match(line)
        assert m, line
        out.setdefault(m.group(1), {})[m.group(2) or ""] = m.group(3)
    return out


@pytest.fixture(scope="module")
def rendered():
    r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(STUB_STATS)], capture_output=True, text=True,
                       timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    return {k: _series(v) for k, v in doc.items()}


def test_series_names_are_the_jax_names_less_the_two_probe_series(rendered):
    jax_names, port_names = set(rendered["jax"]), set(rendered["port"])
    assert port_names == jax_names - DEPARTURES
    assert "minio_tpu_device_probe_recovery_interval_seconds" in jax_names  # the JAX node always renders it


PREFIXES = ("minio_tpu_s3_", "minio_tpu_codec_", "minio_tpu_encode_")


@pytest.mark.parametrize("prefix", PREFIXES)
def test_the_same_counters_render_the_same_values(rendered, prefix):
    j = {k: v for k, v in rendered["jax"].items() if k.startswith(prefix)}
    p = {k: v for k, v in rendered["port"].items() if k.startswith(prefix)}
    assert p == j and p


def test_codec_series_are_the_stub_counters(rendered):
    s = rendered["port"]
    assert s["minio_tpu_codec_encode_batches_total"] == {"": "75"}
    assert s["minio_tpu_codec_verify_batches_total"] == {"": "256"}
    assert s["minio_tpu_codec_device_seconds_total"]['{kernel="encode"}'] == "0.123457"
    assert s["minio_tpu_codec_queue_depth"] == {'{geometry="12x4"}': "3", '{geometry="14x2-small"}': "1"}
    assert set(s["minio_tpu_codec_host_fallback_total"].values()) == {"0"}


def test_last_minute_latency_equal(monkeypatch):
    rng = np.random.default_rng(52)
    adds = [(1_760_000_000 + int(t), float(s)) for t, s in zip(np.sort(rng.integers(0, 120, 40)), rng.random(40))]
    got = {}
    for name, mod in (("jax", jax_metrics), ("port", port_metrics)):
        clock = {"t": 0}
        monkeypatch.setattr(mod.time, "time", lambda: clock["t"])
        lm = mod.LastMinuteLatency()
        trace = []
        for t, s in adds:
            clock["t"] = t
            lm.add(s)
            trace.append(lm.stats())
        got[name] = trace
        monkeypatch.undo()
    assert got["port"] == got["jax"]


def test_merge_node_texts_equal():
    texts = [
        ("http://a:9000", '# HELP x_total X.\n# TYPE x_total counter\nx_total 3\ny{k="v"} 1.5\n', True),
        ("http://b:9000", '# HELP x_total X.\n# TYPE x_total counter\nx_total 4\n', True),
        ("http://c\"9000", "", False),
    ]
    assert port_metrics.merge_node_texts(texts) == jax_metrics.merge_node_texts(texts)


def test_a_scrape_installs_no_codec_and_loads_no_host_library(monkeypatch):
    monkeypatch.setattr(codec_mod, "_default", None)
    before = native.status()
    text = port_metrics.MetricsSys().render_node()
    assert codec_mod._default is None
    assert native.status() == before
    assert "minio_tpu_codec_" not in text
    assert "minio_tpu_native_codec_available" in text and "numpy fallback" not in text
    assert not DEPARTURES & set(_series(text))


def test_scrape_equals_the_codec_stats_after_real_batches(monkeypatch):
    codec = BatchingDeviceCodec(device="cpu")
    try:
        monkeypatch.setattr(codec_mod, "_default", codec)
        rng = np.random.default_rng(53)
        blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (3000, 999)]
        codec.encode(blocks, 3, 1)
        codec.digests_batch([rng.integers(0, 256, 600, dtype=np.uint8).tobytes() for _ in range(3)])
        text = port_metrics.MetricsSys().render_node()
        st = codec.stats()
        s = _series(text)
        for series, key in (("blocks_encoded_total", "blocks_encoded"), ("encode_batches_total", "batches_run"),
                            ("recon_batches_total", "recon_batches_run"),
                            ("verify_batches_total", "verify_batches_run"),
                            ("digests_verified_total", "digests_verified"),
                            ("small_batches_total", "small_batches_run")):
            assert s[f"minio_tpu_codec_{series}"] == {"": str(st[key])}, series
        assert st["small_batches_run"] >= 1
    finally:
        codec.close()
