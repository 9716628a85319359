"""The observability plane of minio_tpu_torch on the CPU, held against the JAX
package.

Pure functions (exact): StageLedger snapshots, bucket_index, quantile,
summarize, merge_snapshots, OpsTimeSeries (an injected clock), the
SlowRequestCapture ring and op_class, fed the same numpy-seeded inputs.

A scripted erasure run: one 8-drive 6+2 set per package on the same
format.json, minio_tpu_torch's ErasureObjects on its BatchingDeviceCodec
(device="cpu") and the JAX package's on its HostCodec without the native
library (so its encode spans are ``erasure.encode``, as the batching codec's
are). The script: a small PUT, a 3 MiB PUT, a GET, a degraded GET (two
drives' part files removed), a two-part multipart upload and a heal, each
under a test root span, with a GLOBAL_TRACE subscriber in each package,
in a fresh interpreter (see _erasure_main). Compared, with the stated
exceptions:
  * the multiset of (name, layer, parent name, attributes) of every span,
    apart from the timings, the random ids and ``host=True`` (the JAX host
    codec marks its spans so). The one span only the port opens is the
    batching codec's ``erasure.reconstruct`` (the JAX batching codec opens
    it too; its host codec without the native library does not): each is
    held against a spy on the JAX codec's reconstruct_batch, which records
    the span current at each call;
  * the ledger counts per (layer, stage), apart from the codec's own
    records (layer ``codec``; the port records every codec call, the JAX
    package only its device calls) and ``erasure.reconstruct``;
  * the copy-ledger hops, bytes and op counts, exact;
  * the degrade records of three expired deadlines (PUT, GET, multipart
    part), exact. Hedging is timing-driven, so the hedge floor is raised in
    both packages for the script (no hedge fires in either).

Through both S3 fronts (2 sets x 4 drives, as tests/test_torch_s3_api.py
builds them), a script of 20 signed requests: the root spans (name, status,
method, path), the api spans (auth, body-read, response-write) under each,
and the ops/s ring's counts per op class must be equal.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import subprocess
import sys

import numpy as np
import pytest

from minio_tpu.control import perf as jax_perf
from minio_tpu.control import tracing as jax_tracing
from minio_tpu.control.degrade import GLOBAL_DEGRADE as JAX_DEGRADE
from minio_tpu.control.profiler import GLOBAL_PROFILER as JAX_PROFILER
from minio_tpu.control.pubsub import GLOBAL_TRACE as JAX_TRACE
from minio_tpu.object import erasure as jax_erasure
from minio_tpu.object import multipart as jax_multipart
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu.utils import deadline as jax_deadline
from minio_tpu_torch.control import perf, tracing
from minio_tpu_torch.control.degrade import GLOBAL_DEGRADE
from minio_tpu_torch.control.profiler import GLOBAL_PROFILER
from minio_tpu_torch.control.pubsub import GLOBAL_TRACE
from minio_tpu_torch.object import erasure
from minio_tpu_torch.object import multipart
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import deadline
from tests.test_torch_s3_api import JAX as JAX_FRONT
from tests.test_torch_s3_api import PORT as PORT_FRONT
from tests.test_torch_s3_api import ROOT, SET_DRIVES, SETS, Client, _stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVES, PARITY = 8, 2
BUCKET = "bkt"
# Record keys that carry timings or random ids.
_VOLATILE = {"type", "time", "trace", "span", "parent", "duration_ms", "name", "layer", "host"}


# -- pure functions --------------------------------------------------------------------


def _seconds(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(2e-7), np.log(300.0), n))


def test_bucket_index_matches():
    for s in list(_seconds(1, 4000)) + [0.0, 1e-6, 2e-6, 1.0, 1e9]:
        assert perf.bucket_index(float(s)) == jax_perf.bucket_index(float(s))


def _ledgers(seed: int):
    rng = np.random.default_rng(seed)
    port, ref = perf.StageLedger(), jax_perf.StageLedger()
    keys = [("object", "frame-parse"), ("codec", "encode-batch"), ("storage", "drive-sync"), ("api", "PutObject")]
    for s, c, k in zip(_seconds(seed, 3000), rng.uniform(0, 1, 3000), rng.integers(0, len(keys), 3000)):
        for led in (port, ref):
            led.record(*keys[k], float(s), float(s * c))
    return port, ref


@pytest.mark.parametrize("seed", [3, 4])
def test_stage_ledger_summarize_and_quantile_match(seed):
    port, ref = _ledgers(seed)
    snap, jsnap = port.snapshot(), ref.snapshot()
    assert snap == jsnap
    assert perf.summarize(snap) == jax_perf.summarize(jsnap)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        counts = [int(x) for x in rng.integers(0, 5, perf.N_BUCKETS + 1) * (rng.random(perf.N_BUCKETS + 1) < 0.3)]
        for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert perf.quantile(counts, q) == jax_perf.quantile(counts, q)
        assert perf.bucket_max(counts) == jax_perf.bucket_max(counts)


def test_merge_snapshots_matches():
    a, ja = _ledgers(5)
    b, jb = _ledgers(6)
    skew = {"buckets_us": [1.0], "stages": {"x": {"y": {"counts": [1], "sum": 1.0}}}}
    assert perf.merge_snapshots([a.snapshot(), b.snapshot(), skew]) == jax_perf.merge_snapshots(
        [ja.snapshot(), jb.snapshot(), skew]
    )


def test_ops_timeseries_matches():
    rng = np.random.default_rng(8)
    port, ref = perf.OpsTimeSeries(window_s=30), jax_perf.OpsTimeSeries(window_s=30)
    apis = ["PutObject", "GetObject", "HeadObject", "ListObjectsV2", "DeleteObject",
            "CompleteMultipartUpload", "Unknown"]
    t = 1_000_000.0
    for _ in range(2000):
        t += float(rng.exponential(0.05))
        api = apis[int(rng.integers(0, len(apis)))]
        args = (perf.op_class(api), float(_seconds(int(rng.integers(0, 1 << 30)), 1)[0]))
        kw = dict(ok=bool(rng.random() < 0.9), nbytes=int(rng.integers(0, 1 << 20)), now=t)
        port.record(*args, **kw)
        ref.record(jax_perf.op_class(api), args[1], **kw)
    assert port.snapshot(now=t) == ref.snapshot(now=t)
    assert port.rates(horizon_s=20, now=t) == ref.rates(horizon_s=20, now=t)
    assert perf.summarize_timeseries(port.snapshot(now=t)) == jax_perf.summarize_timeseries(ref.snapshot(now=t))


def test_op_class_matches():
    names = ["PutObject", "PostPolicy", "CompleteMultipartUpload", "NewMultipartUpload", "CopyObject",
             "UploadPart", "GetObject", "HeadBucket", "SelectObjectContent", "DeleteObjects",
             "AbortMultipartUpload", "RemoveX", "ListBuckets", "ListObjectsV2", "Options", ""]
    assert [perf.op_class(n) for n in names] == [jax_perf.op_class(n) for n in names]


def test_port_thread_names_map_to_the_same_roles():
    """The port's worker threads carry the JAX package's names, so the
    continuous profiler files their samples under the same roles."""
    from minio_tpu.control.profiler import thread_role as jax_role
    from minio_tpu_torch.control.profiler import thread_role

    names = ["encode-batch-12-4", "encode-batch-small-12-4", "drive-io-lane_0", "drive-io_7", "put-stager",
             "get-stager", "etag-md5", "breaker-probe:/d/drive02", "MainThread"]
    roles = [thread_role(n) for n in names]
    assert roles == [jax_role(n) for n in names]
    assert "other" not in roles


def test_slow_request_capture_matches():
    rng = np.random.default_rng(10)
    caps = (perf.SlowRequestCapture(budget_s=0.5, max_traces=4, max_bytes=1 << 20, max_spans_per_trace=6),
            jax_perf.SlowRequestCapture(budget_s=0.5, max_traces=4, max_bytes=1 << 20, max_spans_per_trace=6))
    for t in range(40):
        tid = f"T{t}"
        spans = int(rng.integers(0, 10))
        root_s = float(rng.uniform(0, 1.2))
        for cap in caps:
            cap.begin_trace(tid)
            for i in range(spans):
                cap.observe({"trace": tid, "name": f"s{i}", "layer": "object"}, False, 0.01)
            cap.observe({"trace": tid, "name": "root", "layer": "api"}, True, root_s)
    lists = [[{k: v for k, v in e.items() if k != "time"} for e in cap.list()] for cap in caps]
    assert lists[0] == lists[1] and lists[0]
    assert caps[0].stats() == caps[1].stats()


# -- a scripted erasure run ------------------------------------------------------------


def _drives(root, fmt_mod, drive_cls):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(drive_cls(d))
    return drives


def _drain(q) -> list[dict]:
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def _span_keys(records: list[dict]) -> collections.Counter:
    spans = [r for r in records if r.get("type") == "span"]
    names = {r["span"]: r["name"] for r in spans}
    return collections.Counter(
        (
            r["name"], r["layer"], names.get(r["parent"], ""),
            tuple(sorted((k, repr(v)) for k, v in r.items() if k not in _VOLATILE)),
        )
        for r in spans
    )


def _remove_part_files(drives, indices, key):
    for i in indices:
        obj = os.path.join(drives[i].root, BUCKET, key)
        data_dir = next(n for n in os.listdir(obj) if n != "xl.meta")
        os.remove(os.path.join(obj, data_dir, "part.1"))


def _script(eo, trc, drives, payloads):
    """The scripted run; every step under a test root span."""
    steps = []

    def step(name, fn):
        with trc.root_span(name, "test", f"T-{name}"):
            steps.append(fn())

    step("put-small", lambda: eo.put_object(BUCKET, "small", payloads["small"]).size)
    step("put-big", lambda: eo.put_object(BUCKET, "big", payloads["big"]).size)
    step("get", lambda: eo.get_object(BUCKET, "big")[1] == payloads["big"])
    _remove_part_files(drives, (0, 4), "big")
    step("get-degraded", lambda: eo.get_object(BUCKET, "big")[1] == payloads["big"])

    def mp():
        uid = eo.multipart.new_multipart_upload(BUCKET, "mp")
        parts = [(n, eo.multipart.put_object_part(BUCKET, "mp", uid, n, payloads[f"part{n}"]).etag)
                 for n in (1, 2)]
        return eo.multipart.complete_multipart_upload(BUCKET, "mp", uid, parts).size

    step("multipart", mp)
    step("heal", lambda: eo.heal_object(BUCKET, "big").disks_healed)
    return steps


def _script_expired(eo, trc, dl_mod, payloads):
    """Three operations under an expired deadline. The aborted GET leaves
    its shard reads running in the pool, so this part runs after the ledger
    and copy-ledger snapshots are taken."""
    steps = []

    def step(name, fn):
        with trc.root_span(name, "test", f"T-{name}"):
            steps.append(fn())

    def expired(fn):
        with dl_mod.scope(1e-9):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - the abort is the point
                return type(e).__name__
        return None

    step("put-expired", lambda: expired(lambda: eo.put_object(BUCKET, "late", payloads["big"])))
    step("get-expired", lambda: expired(lambda: eo.get_object(BUCKET, "big")))

    def mp_expired():
        uid = eo.multipart.new_multipart_upload(BUCKET, "late-mp")
        return expired(lambda: eo.multipart.put_object_part(BUCKET, "late-mp", uid, 1, payloads["part1"]))

    step("part-expired", mp_expired)
    return steps


def _erasure_main(root: str, out_path: str) -> None:
    """The scripted run in both packages, in a process of its own: other
    tests in a worker's process leave background threads (a JAX node's
    scanner) that would record into the same global ledgers and trace hub,
    and the aborted GET leaves shard reads hashing behind it. Writes the
    JSON the tests read."""
    rng = np.random.default_rng(12)
    payloads = {
        "small": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        "big": rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes(),
        "part1": rng.integers(0, 256, 140 << 10, dtype=np.uint8).tobytes(),
        "part2": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    }
    for mod in (erasure, jax_erasure):
        mod.HEDGE_FLOOR = 600.0
    for mod in (multipart, jax_multipart):
        mod.MIN_PART_SIZE = 1
    codec = BatchingDeviceCodec(device="cpu")
    ref_codec = JaxHostCodec(use_native=False)
    recon_calls = []
    orig = ref_codec.reconstruct_batch

    def spy(rows_batch, k, m, want, with_digests=False):
        cur = jax_tracing.current()
        recon_calls.append((cur.name if cur is not None else "", len(rows_batch), k, m))
        return orig(rows_batch, k, m, want, with_digests)

    ref_codec.reconstruct_batch = spy
    port_drives = _drives(os.path.join(root, "port"), port_format, LocalDrive)
    jax_drives = _drives(os.path.join(root, "jax"), jax_format, JaxLocalDrive)
    port = erasure.ErasureObjects(port_drives, parity=PARITY, codec=codec)
    ref = jax_erasure.ErasureObjects(jax_drives, parity=PARITY, codec=ref_codec)
    port.make_bucket(BUCKET)
    ref.make_bucket(BUCKET)
    out = {}
    try:
        for name, eo, trc, hub, led, prof, deg, dl, drives in (
            ("port", port, tracing, GLOBAL_TRACE, perf.GLOBAL_PERF, GLOBAL_PROFILER, GLOBAL_DEGRADE,
             deadline, port_drives),
            ("jax", ref, jax_tracing, JAX_TRACE, jax_perf.GLOBAL_PERF, JAX_PROFILER, JAX_DEGRADE,
             jax_deadline, jax_drives),
        ):
            led.ledger.reset()
            prof.copy.reset()
            deg_before = deg.snapshot()
            q = hub.subscribe()
            try:
                steps = _script(eo, trc, drives, payloads)
                ledger, copy = led.ledger.snapshot(), prof.copy.snapshot()["hops"]
                steps += _script_expired(eo, trc, dl, payloads)
            finally:
                hub.unsubscribe(q)
            deg_after = deg.snapshot()
            out[name] = {
                "steps": steps, "records": _drain(q), "ledger": ledger, "copy": copy,
                "aborts": {
                    k: v - deg_before["deadline_aborts"].get(k, 0)
                    for k, v in deg_after["deadline_aborts"].items()
                },
                "hedges": deg_after["hedge_launched"] - deg_before["hedge_launched"],
            }
        out["recon_calls"] = recon_calls
    finally:
        codec.close()
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def erasure_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obs"))
    out_path = os.path.join(root, "run.json")
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from tests.test_torch_observability import _erasure_main\n"
        "_erasure_main(sys.argv[2], sys.argv[3])\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code, REPO, root, out_path], cwd=REPO,
        capture_output=True, text=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out_path) as f:
        return json.load(f)


def test_script_steps_agree(erasure_run):
    port, ref = erasure_run["port"]["steps"], erasure_run["jax"]["steps"]
    assert port == ref
    assert port[2] is True and port[3] is True
    assert port[6:] == ["DeadlineExceeded"] * 3


def test_spans_match(erasure_run):
    port = _span_keys(erasure_run["port"]["records"])
    ref = _span_keys(erasure_run["jax"]["records"])
    recon = collections.Counter(
        k for k in port if k[0] == "erasure.reconstruct" for _ in range(port[k])
    )
    for k in recon:
        del port[k]
    assert port == ref
    # The port's reconstruct spans against the JAX codec's calls.
    got = collections.Counter(
        (parent, dict(attrs)["blocks"], dict(attrs)["k"], dict(attrs)["m"]) for _, _, parent, attrs in recon.elements()
    )
    want = collections.Counter((p, repr(b), repr(k), repr(m)) for p, b, k, m in erasure_run["recon_calls"])
    assert got == want and sum(got.values()) >= 2
    # Every layer of the object path shows up.
    assert {k[1] for k in ref} >= {"test", "object", "erasure"}
    names = {k[0] for k in ref}
    assert names >= {
        "object.PutObject", "object.GetObject", "object.HealObject", "object.PutObjectPart",
        "object.CompleteMultipartUpload", "encode", "shard-fanout", "commit", "shard-read",
        "decode", "erasure.encode",
    }


def _counts(snap: dict) -> dict:
    return {
        (layer, stage): sum(h["counts"])
        for layer, stages in snap["stages"].items()
        for stage, h in stages.items()
        if layer != "codec" and stage != "erasure.reconstruct"
    }


def test_ledger_counts_match(erasure_run):
    port, ref = _counts(erasure_run["port"]["ledger"]), _counts(erasure_run["jax"]["ledger"])
    assert port == ref
    assert port[("object", "frame-parse")] > 0


def test_codec_records_one_per_call(erasure_run):
    """The port records every codec call under the JAX stage names: one
    verify-batch per frame-parse on these paths, and one reconstruct-batch
    per erasure.reconstruct span."""
    stages = erasure_run["port"]["ledger"]["stages"]
    n = {s: sum(h["counts"]) for s, h in stages["codec"].items()}
    assert n["reconstruct-batch"] == sum(stages["erasure"]["erasure.reconstruct"]["counts"])
    assert n["encode-batch"] >= 1 and n["encode-batch-small"] >= 1
    assert n["verify-batch"] >= sum(stages["object"]["frame-parse"]["counts"])


def test_copy_ledger_matches(erasure_run):
    port, ref = erasure_run["port"]["copy"], erasure_run["jax"]["copy"]
    assert port == ref
    assert set(port) >= {"erasure-stage", "shard-fanout", "frame-parse", "decode"}


def test_degrade_records_match(erasure_run):
    port, ref = erasure_run["port"], erasure_run["jax"]
    assert port["aborts"] == ref["aborts"] == {"erasure-put": 1, "erasure-get": 1, "multipart-put": 1}
    assert port["hedges"] == ref["hedges"] == 0


# -- through the S3 fronts -------------------------------------------------------------


def _front_script(c: Client, body_big: bytes, body_small: bytes) -> list[int]:
    out = []
    out.append(c.send("PUT", "/obs").status)
    out.append(c.send("HEAD", "/obs").status)
    out.append(c.send("PUT", "/obs/small", body=body_small).status)
    out.append(c.send("PUT", "/obs/big", body=body_big).status)
    out.append(c.send("GET", "/obs/small").status)
    out.append(c.send("GET", "/obs/big", headers={"Range": "bytes=-100"}).status)
    out.append(c.send("HEAD", "/obs/big").status)
    out.append(c.send("GET", "/obs", query=[("list-type", "2")]).status)
    out.append(c.send("GET", "/obs/missing").status)
    out.append(c.send("PUT", "/obs/tagged", body=body_small, headers={"x-amz-tagging": "a=b"}).status)
    out.append(c.send("GET", "/obs/tagged", query=[("tagging", "")]).status)
    out.append(c.send("PUT", "/obs/copy", headers={"x-amz-copy-source": "/obs/small"}).status)
    out.append(c.send("GET", "/obs/copy").status)
    out.append(c.send("DELETE", "/obs/copy").status)
    out.append(c.send("GET", "/", ).status)
    out.append(c.send("GET", "/obs", query=[("location", "")]).status)
    out.append(c.send("GET", "/obs/small", sign="none").status)
    out.append(c.send("PUT", "/obs/late", body=body_big, headers={"X-Mtpu-Deadline": "0.0005"}).status)
    out.append(c.send("DELETE", "/obs/small").status)
    out.append(c.send("GET", "/obs", query=[("list-type", "2"), ("prefix", "b")]).status)
    return out


@pytest.fixture(scope="module")
def front_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obs-front"))
    formats = jax_format.init_format(SETS, SET_DRIVES)
    codec = BatchingDeviceCodec(device="cpu")
    rng = np.random.default_rng(14)
    body_big = rng.integers(0, 256, 200 << 10, dtype=np.uint8).tobytes()
    body_small = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    out = {}
    servers = []
    try:
        for pkg, hub, led, codec_i in (
            (JAX_FRONT, JAX_TRACE, jax_perf.GLOBAL_PERF, JaxHostCodec()),
            (PORT_FRONT, GLOBAL_TRACE, perf.GLOBAL_PERF, codec),
        ):
            layer = _stack(pkg, root, formats, codec_i)
            ts = pkg.ThreadedServer(pkg.S3Server(layer, pkg.IAMSys(*ROOT), check_skew=True))
            servers.append(ts)
            client = Client(pkg.name, ts.start())
            led.timeseries.reset()
            q = hub.subscribe()
            try:
                statuses = _front_script(client, body_big, body_small)
            finally:
                hub.unsubscribe(q)
            snap = led.timeseries.snapshot()
            out[pkg.name] = {"statuses": statuses, "records": _drain(q), "ts": snap}
        yield out
    finally:
        for ts in servers:
            ts.stop()
        codec.close()


def _root_and_api(records: list[dict]) -> collections.Counter:
    spans = [r for r in records if r.get("type") == "span"]
    names = {r["span"]: r["name"] for r in spans}
    out = collections.Counter()
    for r in spans:
        if r["layer"] != "api":
            continue
        if r["parent"] == "":
            out[("root", r["name"], r.get("status"), r.get("method"), r.get("path"), r.get("shed"))] += 1
        else:
            out[("api", r["name"], names.get(r["parent"], ""))] += 1
    return out


def _op_totals(snap: dict) -> dict:
    totals: dict = {}
    for sec in snap.get("series", []):
        for cls, cell in sec.get("classes", {}).items():
            t = totals.setdefault(cls, [0, 0])
            t[0] += cell["count"]
            t[1] += cell["errors"]
    return totals


def test_front_statuses_match(front_run):
    assert front_run["port"]["statuses"] == front_run["jax"]["statuses"]
    assert front_run["port"]["statuses"][17] == 503


def test_front_root_and_api_spans_match(front_run):
    port, ref = _root_and_api(front_run["port"]["records"]), _root_and_api(front_run["jax"]["records"])
    assert port == ref
    roots = sum(n for k, n in port.items() if k[0] == "root")
    assert roots == 20
    assert {k[1] for k in port if k[0] == "api"} >= {"auth", "body-read", "response-write"}


def test_front_op_classes_match(front_run):
    port, ref = _op_totals(front_run["port"]["ts"]), _op_totals(front_run["jax"]["ts"])
    assert port == ref
    assert sum(t[0] for t in port.values()) == 20
