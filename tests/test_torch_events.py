"""Bucket event notifications of minio_tpu_torch on the CPU (control/events.py,
control/event_targets.py, api/streams.py and the S3 front's event hooks),
held against the JAX package's.

The same events, notification XML and rule grids go through both packages'
`Event.to_record`, `parse_notification_xml` and `Rule.matches`. A spool that
one package's `TargetQueue` wrote while its broker was down is delivered by
the other's. `configure_targets` registers the same targets from the same
config in both, and a gated target whose client library is absent fails
into `on_error` in both. Then both fronts serve the same deployment (one
4-drive set, the same format.json) with a notifier whose rules come from the
same `PUT ?notification`, and the same S3 operations (PUT, copy, a multipart
upload, DELETE and a bulk delete) reach a webhook receiver on a local port:
the records are equal, with eventTime compared by its format only (it is the
wall clock of each emit). A closed port Node leaves no target thread, no
flight fan-out and no live bridge behind. Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.server
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from minio_tpu.api.server import S3Server as JaxS3Server
from minio_tpu.api.server import ThreadedServer as JaxThreadedServer
from minio_tpu.control import event_targets as jax_targets
from minio_tpu.control import events as jax_events
from minio_tpu.control.iam import IAMSys as JaxIAMSys
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.api import streams
from minio_tpu_torch.api.server import S3Server, ThreadedServer
from minio_tpu_torch.control import event_targets, events
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from tests.s3client import S3TestClient

PKGS = {"jax": jax_events, "port": events}
T0 = 1_760_000_000.0
EVENT_TIME = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ$")


def _events() -> list[dict]:
    rng = np.random.default_rng(41)
    names = ["s3:ObjectCreated:Put", "s3:ObjectCreated:Copy", "s3:ObjectCreated:CompleteMultipartUpload",
             "s3:ObjectRemoved:Delete", "s3:ObjectRemoved:Expired", "s3:ObjectCreated:Post"]
    out = []
    for i, name in enumerate(names):
        out.append({
            "name": name, "bucket": f"bkt{i % 2}", "object_name": f"dir/obj-{i}.txt",
            "etag": rng.integers(0, 256, 16, dtype=np.uint8).tobytes().hex(),
            "size": int(rng.integers(0, 1 << 30)), "version_id": "" if i % 2 else f"v-{i}",
            "time": T0 + float(rng.integers(0, 10**6)), "region": "us-east-1", "user_identity": f"user{i}",
        })
    return out


EVENTS = _events()


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_event_record_equal(i):
    recs = {name: mod.Event(**EVENTS[i]).to_record() for name, mod in PKGS.items()}
    assert recs["port"] == recs["jax"]
    assert recs["port"]["eventName"] == EVENTS[i]["name"].removeprefix("s3:")


NS = ' xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
XMLS = {
    "empty": "",
    "queue-prefix-suffix": (
        f"<NotificationConfiguration{NS}><QueueConfiguration><Id>1</Id>"
        "<Queue>arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*</Event>"
        "<Filter><S3Key><FilterRule><Name>prefix</Name><Value>tenant-00/</Value></FilterRule>"
        "<FilterRule><Name>Suffix</Name><Value>.bin</Value></FilterRule></S3Key></Filter>"
        "</QueueConfiguration></NotificationConfiguration>"),
    "two-configs": (
        "<NotificationConfiguration><QueueConfiguration><Queue>arn:minio:sqs::1:webhook</Queue>"
        "<Event>s3:ObjectCreated:Put</Event><Event>s3:ObjectCreated:Copy</Event></QueueConfiguration>"
        "<TopicConfiguration><Topic>arn:aws:sns:us-east-1:1:redis</Topic><Event>s3:ObjectRemoved:*</Event>"
        "</TopicConfiguration></NotificationConfiguration>"),
    "cloud-function-and-unknown": (
        "<NotificationConfiguration><CloudFunctionConfiguration><CloudFunction>arn:x:lambda:fn</CloudFunction>"
        "<Event>s3:*</Event></CloudFunctionConfiguration><Other><Event>s3:Nope</Event></Other>"
        "</NotificationConfiguration>"),
    "no-target": ("<NotificationConfiguration><QueueConfiguration><Event>s3:ObjectRemoved:Delete</Event>"
                  "</QueueConfiguration></NotificationConfiguration>"),
}


@pytest.mark.parametrize("case", sorted(XMLS))
def test_parse_notification_xml_equal(case):
    parsed = {name: [dataclasses.asdict(r) for r in mod.parse_notification_xml(XMLS[case])]
              for name, mod in PKGS.items()}
    assert parsed["port"] == parsed["jax"]
    # bytes parse as the same rules as text
    assert [dataclasses.asdict(r) for r in events.parse_notification_xml(XMLS[case].encode())] == parsed["port"]


def test_rule_matches_equal():
    patterns = [["s3:ObjectCreated:*"], ["s3:*"], ["s3:ObjectRemoved:Delete"], ["s3:ObjectCreated:Put", "s3:Obj*:Copy"]]
    names = ["s3:ObjectCreated:Put", "s3:ObjectCreated:Copy", "s3:ObjectRemoved:Delete", "s3:ObjectRemoved:Expired"]
    keys = ["tenant-00/a.bin", "tenant-01/a.bin", "tenant-00/b.txt", "x"]
    for pats in patterns:
        for prefix, suffix in (("", ""), ("tenant-00/", ""), ("", ".bin"), ("tenant-00/", ".bin")):
            rules = {n: m.Rule(events=pats, prefix=prefix, suffix=suffix) for n, m in PKGS.items()}
            got = {n: [r.matches(e, k) for e in names for k in keys] for n, r in rules.items()}
            assert got["port"] == got["jax"], (pats, prefix, suffix)


# -- the on-disk spool ---------------------------------------------------------------------------


def _records(n: int) -> list[dict]:
    out = []
    for i in range(n):
        ev = dict(EVENTS[i % len(EVENTS)], object_name=f"spool/{i}")
        rec = events.Event(**ev).to_record()
        out.append({"EventName": ev["name"], "Key": f"{ev['bucket']}/spool/{i}", "Records": [rec]})
    return out


def _down(record):
    raise ConnectionError("broker down")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_written_by_one_package_is_delivered_by_the_other(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    spool = str(tmp_path / "webhook")
    records = _records(7)
    q = PKGS[writer].TargetQueue(_down, spool)
    for r in records:
        q.put(r)
    q.close()
    files = sorted(os.listdir(spool))
    assert len(files) == len(records)
    assert [json.load(open(os.path.join(spool, f))) for f in files] == records
    got: list = []
    q2 = PKGS[reader].TargetQueue(got.append, spool)
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (len(got) < len(records) or os.listdir(spool)):
            time.sleep(0.02)
    finally:
        q2.close()
    assert got == records  # once each, in spool order
    assert os.listdir(spool) == [] and q2.pending() == 0


def test_spool_files_are_the_same_json(tmp_path):
    rec = _records(1)[0]
    blobs = {}
    for name, mod in PKGS.items():
        q = mod.TargetQueue(_down, str(tmp_path / name))
        q.put(rec)
        q.close()
        (f,) = os.listdir(tmp_path / name)
        assert re.fullmatch(r"\d+-[0-9a-f]{32}\.json", f)
        blobs[name] = (tmp_path / name / f).read_bytes()
    assert blobs["port"] == blobs["jax"]


class _Config:
    def __init__(self, kv: dict):
        self.kv = kv

    def get(self, subsys: str, key: str) -> str:
        return self.kv.get((subsys, key), "")


def test_configure_targets_isolates_a_target_whose_library_is_absent(tmp_path):
    cfg = _Config({
        ("notify_webhook", "enable"): "on", ("notify_webhook", "endpoint"): "http://127.0.0.1:9/hook",
        ("notify_redis", "enable"): "on", ("notify_redis", "address"): "127.0.0.1:9", ("notify_redis", "key"): "ev",
        ("notify_nats", "enable"): "on", ("notify_nats", "address"): "127.0.0.1:9",
        ("notify_nats", "subject"): "ev",
        ("notify_kafka", "enable"): "on", ("notify_kafka", "brokers"): "127.0.0.1:9",
        ("notify_kafka", "topic"): "ev",
    })
    out = {}
    for name, (ev_mod, tg_mod) in {"jax": (jax_events, jax_targets), "port": (events, event_targets)}.items():
        notifier = ev_mod.EventNotifier()
        errs: dict = {}
        ids = tg_mod.configure_targets(notifier, cfg, str(tmp_path / name),
                                       on_error=lambda tid, e, errs=errs: errs.__setitem__(tid, type(e).__name__))
        out[name] = (ids, sorted(notifier.targets), errs,
                     sorted(os.listdir(tmp_path / name)) if (tmp_path / name).exists() else [])
        for t in notifier.targets.values():
            t.close()
    assert out["port"] == out["jax"]
    ids, registered, errs, _ = out["port"]
    assert sorted(ids) == registered == ["nats", "redis", "webhook"]
    assert set(errs) == {"kafka"}


# -- the S3 front's events ------------------------------------------------------------------------


class _Receiver:
    """A webhook receiver on 127.0.0.1: records every POSTed JSON body."""

    def __init__(self):
        got = self.got = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                got.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/hook"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


RULES = (
    "<NotificationConfiguration><QueueConfiguration><Queue>arn:minio:sqs::1:webhook</Queue>"
    "<Event>s3:ObjectCreated:*</Event><Filter><S3Key><FilterRule><Name>prefix</Name><Value>tenant-00/</Value>"
    "</FilterRule></S3Key></Filter></QueueConfiguration>"
    "<QueueConfiguration><Queue>arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectRemoved:*</Event>"
    "</QueueConfiguration></NotificationConfiguration>"
).encode()
_rng = np.random.default_rng(43)
OBJS = {f"tenant-0{i % 2}/o{i}": _rng.integers(0, 256, int(_rng.integers(1, 9000)), dtype=np.uint8).tobytes()
        for i in range(6)}
OBJS["tenant-00/big"] = _rng.integers(0, 256, 140_000, dtype=np.uint8).tobytes()  # past the inline limit


def _ops(c: S3TestClient) -> dict:
    """The same S3 operations on one front; returns each HEAD after its write."""
    heads = {}
    assert c.request("PUT", "/evb", query=[("notification", "")], body=RULES).status_code == 200
    for key, body in OBJS.items():
        assert c.put_object("evb", key, body).status_code == 200
    for src, dst in (("tenant-01/o1", "tenant-00/copy1"), ("tenant-00/o0", "tenant-01/copy0")):
        assert c.request("PUT", f"/evb/{dst}", headers={"x-amz-copy-source": f"/evb/{src}"}).status_code == 200
    r = c.request("POST", "/evb/tenant-00/mp", query=[("uploads", "")])
    uid = re.search(rb"<UploadId>([^<]+)</UploadId>", r.content).group(1).decode()
    r = c.request("PUT", "/evb/tenant-00/mp", query=[("partNumber", "1"), ("uploadId", uid)], body=OBJS["tenant-00/o2"])
    etag = r.headers["ETag"]
    body = f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber><ETag>{etag}</ETag></Part></CompleteMultipartUpload>"
    assert c.request("POST", "/evb/tenant-00/mp", query=[("uploadId", uid)], body=body.encode()).status_code == 200
    for key in list(OBJS) + ["tenant-00/copy1", "tenant-01/copy0", "tenant-00/mp"]:
        h = c.head_object("evb", key)
        heads[key] = (int(h.headers["Content-Length"]), h.headers["ETag"].strip('"'))
    assert c.delete_object("evb", "tenant-01/o3").status_code == 204
    bulk = "".join(f"<Object><Key>{k}</Key></Object>" for k in ("tenant-00/o4", "tenant-01/o5"))
    r = c.request("POST", "/evb", query=[("delete", "")], body=f"<Delete>{bulk}</Delete>".encode())
    assert r.status_code == 200
    return heads


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("events"))
    formats = jax_format.init_format(1, 4)
    codec = BatchingDeviceCodec(device="cpu")
    sides = {
        "jax": (JaxLocalDrive, jax_format.DriveFormat, JaxErasureSets, JaxServerPools, JaxS3Server,
                JaxThreadedServer, JaxIAMSys, jax_events, JaxHostCodec()),
        "port": (LocalDrive, port_format.DriveFormat, ErasureSets, ServerPools, S3Server, ThreadedServer, IAMSys,
                 events, codec),
    }
    out = {}
    servers, receivers, targets = [], [], []
    try:
        for name, (LD, DF, ES, SP, Srv, TS, IAM, ev_mod, c) in sides.items():
            dirs = []
            for i, f in enumerate(formats):
                d = os.path.join(root, name, f"d{i}")
                os.makedirs(d)
                f.save(d)
                dirs.append(d)
            layer = SP([ES.from_drives([LD(d) for d in dirs], DF.load(dirs[0]), codec=c, pool_index=0)])
            srv = Srv(layer, IAM("evak", "evsk-secret"), check_skew=False)
            srv.notifier = ev_mod.EventNotifier()
            rcv = _Receiver()
            receivers.append(rcv)
            target = ev_mod.WebhookEventTarget("webhook", rcv.url, queue_dir=os.path.join(root, name, "spool"))
            targets.append(target)
            srv.notifier.register_target(target)
            ts = TS(srv)
            servers.append(ts)
            client = S3TestClient(ts.start(), "evak", "evsk-secret")
            assert client.make_bucket("evb").status_code == 200
            heads = _ops(client)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and target.queue.pending():
                time.sleep(0.05)
            out[name] = {"got": list(rcv.got), "heads": heads, "rules": srv.notifier.bucket_rules.get("evb"),
                         "pending": target.queue.pending()}
        yield out
    finally:
        for t in targets:
            t.close()
        for ts in servers:
            ts.stop()
        for r in receivers:
            r.close()
        codec.close()


def _strip_time(records: list) -> list:
    out = []
    for r in records:
        r = json.loads(json.dumps(r))
        for rec in r["Records"]:
            assert EVENT_TIME.match(rec.pop("eventTime"))
        out.append(r)
    return out


def test_s3_operations_give_the_jax_records(fronts):
    assert fronts["port"]["pending"] == fronts["jax"]["pending"] == 0
    assert _strip_time(fronts["port"]["got"]) == _strip_time(fronts["jax"]["got"])


def test_records_are_exactly_the_matching_operations(fronts):
    got = fronts["port"]["got"]
    names = [(r["EventName"], r["Key"]) for r in got]
    created = [k for k in list(OBJS) + ["tenant-00/copy1", "tenant-00/mp"] if k.startswith("tenant-00/")]
    expected = [("s3:ObjectCreated:Put", f"evb/{k}") for k in OBJS if k.startswith("tenant-00/")]
    expected += [("s3:ObjectCreated:Copy", "evb/tenant-00/copy1"),
                 ("s3:ObjectCreated:CompleteMultipartUpload", "evb/tenant-00/mp")]
    expected += [("s3:ObjectRemoved:Delete", f"evb/{k}") for k in ("tenant-01/o3", "tenant-00/o4", "tenant-01/o5")]
    assert names == expected
    heads = fronts["port"]["heads"]
    for r in got[: len(created)]:
        obj = r["Records"][0]["s3"]["object"]
        assert (obj["size"], obj["eTag"]) == heads[obj["key"]]
        assert obj["versionId"] == ""


def test_rules_from_put_notification_equal(fronts):
    as_dicts = {n: [dataclasses.asdict(r) for r in fronts[n]["rules"]] for n in ("jax", "port")}
    assert as_dicts["port"] == as_dicts["jax"] and len(as_dicts["port"]) == 2


# -- a closed node leaves nothing behind -------------------------------------------------------


def test_closed_node_leaves_no_target_thread_flight_fanout_or_bridge(tmp_path, monkeypatch):
    from minio_tpu_torch.control.flight import GLOBAL_FLIGHT
    from minio_tpu_torch.dist.node import Node

    monkeypatch.setenv("MTPU_FLIGHT", "1")
    monkeypatch.setenv("MTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENABLE", "on")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT", "http://127.0.0.1:9/hook")
    codec = BatchingDeviceCodec(device="cpu")
    loop = asyncio.new_event_loop()
    try:
        node = Node([str(tmp_path / f"d{i}") for i in range(4)], codec=codec, device="cpu").build()
        (target,) = node.notifier.targets.values()
        assert target.queue._thread.is_alive()
        assert node.notify_target_errors == {}
        assert os.path.isdir(os.path.join(str(tmp_path / "d0"), ".minio_tpu.sys", "notify-spool", "webhook"))
        assert GLOBAL_FLIGHT.node_id == node.url and GLOBAL_FLIGHT.fanout == node.notification.flight_capture_all
        assert GLOBAL_FLIGHT._thread is not None and GLOBAL_FLIGHT._thread.is_alive()
        bridge = streams.HubBridge(node.notifier.listen_hub, loop)
        bridge.start()
        assert node.notifier.listen_hub.num_subscribers() == 1
        node.close()
        assert not target.queue._thread.is_alive()
        assert GLOBAL_FLIGHT.fanout is None and GLOBAL_FLIGHT.node_id != node.url
        assert GLOBAL_FLIGHT._thread is None
        assert bridge.stop.is_set() and not bridge._thread.is_alive()
        assert node.notifier.listen_hub.num_subscribers() == 0
    finally:
        loop.close()
        codec.close()
