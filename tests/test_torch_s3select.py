"""SelectObjectContent of minio_tpu_torch on the CPU (s3select/ and the S3
front's _select_object), held against the JAX package's.

The cases of tests/test_s3select.py and tests/test_parquet.py run on the
port: each file is executed with its `minio_tpu.` imports pointed at
`minio_tpu_torch.` and the erasure harness of tests/harness.py built from
the port's modules; every other line is the JAX file's. The erasure stacks
they build without codec= serve this file's default codec, the batching
codec on the CPU (the kernels' plain versions). Then the two packages
meet: the same requests over the same seeded bytes (CSV, JSON lines and
documents, gzip, bzip2, Parquet plain and snappy, scan ranges, progress,
casts that fail mid-stream, parse errors) give the same event-stream frames
or the same SelectError from both run_select; and the JAX and port S3
fronts, each over its own erasure set holding the same objects, answer
the same Select requests with the same status and bytes, error frames and
error XML included. Tolerance: exact.
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import http.client
import json
import os
import urllib.parse

import numpy as np
import pytest

from minio_tpu.api.server import S3Server as JaxS3Server
from minio_tpu.api.server import ThreadedServer as JaxThreadedServer
from minio_tpu.control.iam import IAMSys as JaxIAMSys
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.pools import ServerPools as JaxServerPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.s3select import select as jax_select
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import s3select as port_s3select
from minio_tpu_torch.api.auth import Credentials, sign_request
from minio_tpu_torch.api.server import S3Server, ThreadedServer
from minio_tpu_torch.control.iam import IAMSys
from minio_tpu_torch.dist.node import Node
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.s3select import parquet as port_pq
from minio_tpu_torch.s3select import select as port_select
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive
from tests.test_torch_loadgen import rerun_on_port

_HARNESS = rerun_on_port("harness", [("from minio_tpu.", "from minio_tpu_torch.", 4)], {})
_SELECT_CASES = rerun_on_port(
    "test_s3select",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 11),
        ("    from tests.harness import ErasureHarness\n", "", 1),
    ],
    globals(),
    preset={"ErasureHarness": _HARNESS.ErasureHarness},
)
_PARQUET_CASES = rerun_on_port(
    "test_parquet",
    [
        ("from minio_tpu.", "from minio_tpu_torch.", 8),
        ("    from tests.harness import ErasureHarness\n", "", 1),
    ],
    globals(),
    preset={"ErasureHarness": _HARNESS.ErasureHarness},
)


@pytest.fixture(scope="module", autouse=True)
def cpu_default_codec():
    """The process default codec of the layers this file builds without
    codec= (the JAX files' HTTP stacks): the batching codec on the CPU."""
    codec = BatchingDeviceCodec(device="cpu")
    codec_mod.set_default_codec(codec)
    try:
        yield codec
    finally:
        Node.close_all()
        with codec_mod._default_lock:
            if codec_mod._default is codec:
                codec_mod._default = None
        codec.close()


def _test_functions(mod) -> list[str]:
    return [k for k, v in vars(mod).items() if k.startswith("test_") and callable(v)]


def test_the_jax_cases_run_on_the_port():
    """All 32 functions of tests/test_s3select.py and the 10 of
    tests/test_parquet.py were collected here, against the port's modules."""
    assert len(_test_functions(_SELECT_CASES)) == 32
    assert len(_test_functions(_PARQUET_CASES)) == 10
    assert _SELECT_CASES.run_select is port_s3select.run_select
    assert _PARQUET_CASES.pq is port_pq
    assert _HARNESS.ErasureObjects.__module__ == "minio_tpu_torch.object.erasure"


# -- the same request, the same frames ----------------------------------------------------------

REGIONS = ("us-east-1", "us-west-2", "eu-west-1", "ap-south-1", "sa-east-1")
STATUSES = ("200", "200", "200", "200", "304", "404", "500", "503")


def _log_columns(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(n),
        "region": rng.integers(0, len(REGIONS), n),
        "status": rng.integers(0, len(STATUSES), n),
        "bytes": rng.integers(0, 1 << 24, n),
        "latency_cs": rng.integers(0, 60000, n),
        "path": rng.integers(0, 1000, n),
    }


def _csv(cols: dict, header: bool = True) -> bytes:
    rows = [
        f"{i},{REGIONS[r]},{STATUSES[s]},{b},{c // 100}.{c % 100:02d},/api/v1/objects/{p}"
        for i, r, s, b, c, p in zip(*(cols[k].tolist() for k in cols))
    ]
    head = ["id,region,status,bytes,latency_ms,path"] if header else []
    return ("\n".join(head + rows) + "\n").encode()


def _json_lines(cols: dict) -> bytes:
    out = []
    for i, r, s, b, c, p in zip(*(cols[k].tolist() for k in cols)):
        rec = {"id": i, "region": REGIONS[r], "status": STATUSES[s], "bytes": b, "latency_ms": c / 100,
               "path": f"/api/v1/objects/{p}", "tags": [REGIONS[r][:2], STATUSES[s]]}
        if i % 7 == 0:
            rec["extra"] = {"n": i}
        out.append(json.dumps(rec))
    return ("\n".join(out) + "\n").encode()


COLS = _log_columns(17, 2000)
CSV = _csv(COLS)
CSV_BARE = _csv(COLS, header=False)
JSONL = _json_lines(COLS)
JSON_DOC = json.dumps({"log": {"region": "eu-west-1", "count": 3, "items": [1, 2, 3]}}).encode()
PARQUET_COLS = ([int(v) for v in COLS["bytes"][:500]], [REGIONS[r] for r in COLS["region"][:500]])

AGG = "SELECT count(*), sum(cast(s.bytes as int)) FROM S3Object s WHERE s.status = '500'"


def _req(mod, expression: str, **fields):
    req = mod.S3SelectRequest(expression=expression)
    for key, value in fields.items():
        owner = req
        *path, last = key.split("__")
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, last, value)
    return req


CASES = {
    "csv-aggregate": (AGG, CSV, {"csv_args__file_header_info": "USE"}),
    "csv-projection-float-where": (
        "SELECT s.id, s.path FROM S3Object s WHERE cast(s.latency_ms as float) > 450.5", CSV,
        {"csv_args__file_header_info": "USE"}),
    "csv-positional-no-header": ("SELECT _1, _3 FROM S3Object WHERE _2 = 'eu-west-1' LIMIT 40", CSV_BARE, {}),
    "csv-header-ignore": ("SELECT _4 FROM S3Object LIMIT 25", CSV, {"csv_args__file_header_info": "IGNORE"}),
    "csv-functions": (
        "SELECT upper(s.region), char_length(s.path), substring(s.path, 2, 3), trim('  x  '), "
        "lower(s.status) || '-' || s.region FROM S3Object s WHERE s.region LIKE 'us-%' LIMIT 50", CSV,
        {"csv_args__file_header_info": "USE"}),
    "csv-aggregates-min-max-avg": (
        "SELECT min(cast(s.bytes as int)), max(cast(s.latency_ms as float)), avg(cast(s.bytes as int)), "
        "count(s.path) FROM S3Object s WHERE s.status IN ('404', '503') AND cast(s.id as int) BETWEEN 10 AND 1500",
        CSV, {"csv_args__file_header_info": "USE"}),
    "csv-json-output": ("SELECT s.id, s.region FROM S3Object s WHERE s.status = '304' LIMIT 60", CSV,
                        {"csv_args__file_header_info": "USE", "output_format": "json"}),
    "csv-quote-always": ("SELECT s.region, s.path FROM S3Object s LIMIT 30", CSV,
                         {"csv_args__file_header_info": "USE", "out_csv__quote_fields": "ALWAYS",
                          "out_csv__field_delimiter": ";"}),
    "csv-progress": (AGG, CSV, {"csv_args__file_header_info": "USE", "progress": True}),
    "csv-scan-range-mid-record": ("SELECT * FROM S3Object", CSV_BARE, {"scan_start": 1001, "scan_end": 9999}),
    "csv-scan-range-tail": ("SELECT count(*) FROM S3Object", CSV_BARE, {"scan_start": len(CSV_BARE) - 500}),
    "csv-cast-fails-mid-stream": ("SELECT cast(s.region as int) FROM S3Object s", CSV,
                                  {"csv_args__file_header_info": "USE"}),
    "csv-bad-column-math": ("SELECT s.region * 2 FROM S3Object s", CSV, {"csv_args__file_header_info": "USE"}),
    "gzip-csv": (AGG, gzip.compress(CSV, mtime=0), {"csv_args__file_header_info": "USE", "compression": "GZIP"}),
    "bzip2-csv": (AGG, bz2.compress(CSV), {"csv_args__file_header_info": "USE", "compression": "BZIP2"}),
    "json-lines-fields": ("SELECT s.id, s.tags[1], s.extra.n FROM S3Object s WHERE s.bytes > 8000000", JSONL,
                          {"input_format": "json", "output_format": "json"}),
    "json-lines-missing": ("SELECT s.id FROM S3Object s WHERE s.extra IS MISSING LIMIT 100", JSONL,
                           {"input_format": "json"}),
    "json-lines-aggregate": ("SELECT count(*), sum(s.bytes), max(s.latency_ms) FROM S3Object s "
                             "WHERE s.region = 'ap-south-1'", JSONL, {"input_format": "json"}),
    "json-lines-star": ("SELECT * FROM S3Object s LIMIT 20", JSONL, {"input_format": "json", "output_format": "json"}),
    "json-lines-scan-range": ("SELECT s.id FROM S3Object s", JSONL,
                              {"input_format": "json", "scan_start": 777, "scan_end": 20000}),
    "json-document": ("SELECT s.log.region, s.log.items[2] FROM S3Object s", JSON_DOC,
                      {"input_format": "json", "json_args__type": "DOCUMENT"}),
    "parquet-plain": ("SELECT s.n, s.s FROM S3Object s WHERE s.s = 'eu-west-1'",
                      _PARQUET_CASES._write_simple_parquet(*PARQUET_COLS), {"input_format": "parquet"}),
    "parquet-snappy-aggregate": (
        "SELECT count(*), sum(s.n) FROM S3Object s WHERE s.s <> 'us-east-1'",
        _PARQUET_CASES._write_simple_parquet(*PARQUET_COLS, codec=port_pq.CODEC_SNAPPY), {"input_format": "parquet"}),
    "parquet-scan-range": ("SELECT * FROM S3Object", _PARQUET_CASES._write_simple_parquet(*PARQUET_COLS),
                           {"input_format": "parquet", "scan_start": 0, "scan_end": 10}),
    "parquet-corrupt": ("SELECT * FROM S3Object", b"PAR1" + bytes(range(200)) + b"PAR1",
                        {"input_format": "parquet"}),
    "parse-error": ("SELECT FROM S3Object WHERE", CSV, {}),
    "aggregate-mixing": ("SELECT count(*), s.id FROM S3Object s", CSV, {"csv_args__file_header_info": "USE"}),
    "bad-gzip": (AGG, b"not gzip at all", {"compression": "GZIP"}),
}


def _frames(mod, expression: str, data: bytes, fields: dict):
    try:
        return b"".join(mod.run_select(_req(mod, expression, **fields), lambda _o, _n: data))
    except mod.SelectError as e:
        return ("SelectError", e.code, e.message, e.status)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_select_frames_equal(name):
    expression, data, fields = CASES[name]
    port = _frames(port_select, expression, data, fields)
    jax = _frames(jax_select, expression, data, fields)
    assert port == jax
    if isinstance(port, bytes):
        kinds = [m["headers"].get(":event-type") or m["headers"].get(":message-type")
                 for m in port_s3select.decode_messages(port)]
        assert kinds[-1] in ("End", "error"), kinds


def test_csv_aggregate_equals_numpy():
    """The seeded log's aggregate, as numpy computes it from the columns."""
    frames = _frames(port_select, AGG, CSV, {"csv_args__file_header_info": "USE"})
    payload = b"".join(m["payload"] for m in port_s3select.decode_messages(frames)
                       if m["headers"].get(":event-type") == "Records")
    hit = np.asarray(STATUSES)[COLS["status"]] == "500"
    assert payload == f"{int(hit.sum())},{int(COLS['bytes'][hit].sum())}\n".encode()


REQUEST_XML = [
    b"""<?xml version="1.0" encoding="UTF-8"?>
<SelectObjectContentRequest xmlns="http://s3.amazonaws.com/doc/2006-03-01/">
  <Expression>SELECT * FROM S3Object</Expression><ExpressionType>SQL</ExpressionType>
  <InputSerialization><CompressionType>GZIP</CompressionType>
    <CSV><FileHeaderInfo>USE</FileHeaderInfo><FieldDelimiter>;</FieldDelimiter><QuoteCharacter>'</QuoteCharacter></CSV>
  </InputSerialization>
  <OutputSerialization><JSON><RecordDelimiter>,</RecordDelimiter></JSON></OutputSerialization>
  <RequestProgress><Enabled>true</Enabled></RequestProgress>
  <ScanRange><Start>10</Start><End>100</End></ScanRange>
</SelectObjectContentRequest>""",
    b"<SelectObjectContentRequest><Expression>SELECT s.a FROM S3Object s</Expression>"
    b"<ExpressionType>SQL</ExpressionType><InputSerialization><JSON><Type>DOCUMENT</Type></JSON>"
    b"</InputSerialization><OutputSerialization><CSV><QuoteFields>ALWAYS</QuoteFields></CSV>"
    b"</OutputSerialization></SelectObjectContentRequest>",
    b"<SelectObjectContentRequest><Expression>SELECT 1</Expression><ExpressionType>SQL</ExpressionType>"
    b"<InputSerialization><Parquet/></InputSerialization></SelectObjectContentRequest>",
    b"<NotSelect/>",
    b"<SelectObjectContentRequest><Expression>",
]


@pytest.mark.parametrize("i", range(len(REQUEST_XML)))
def test_request_xml_parses_equal(i):
    def parsed(mod):
        try:
            return dataclasses.asdict(mod.S3SelectRequest.from_xml(REQUEST_XML[i]))
        except mod.SelectError as e:
            return (e.code, e.message, e.status)

    assert parsed(port_select) == parsed(jax_select)


# -- the two S3 fronts, the same Select bytes --------------------------------------------------

ROOT = ("selectroot", "select-root-secret")
OBJECTS = {
    "log.csv": CSV[:100_000],  # inline: under the 128 KiB limit
    "big.csv": _csv(_log_columns(18, 5000)),  # past it: frames verified on the GET
    "log.json": JSONL[:60_000].rsplit(b"\n", 1)[0] + b"\n",
    "log.csv.gz": gzip.compress(CSV, mtime=0),
    "t.parquet": _PARQUET_CASES._write_simple_parquet(*PARQUET_COLS, codec=port_pq.CODEC_SNAPPY),
}


def _body(expression: str, input_xml: str, output_xml: str = "<CSV/>", extra: str = "") -> bytes:
    return (f"<SelectObjectContentRequest><Expression>{expression}</Expression>"
            f"<ExpressionType>SQL</ExpressionType><InputSerialization>{input_xml}</InputSerialization>"
            f"<OutputSerialization>{output_xml}</OutputSerialization>{extra}"
            "</SelectObjectContentRequest>").encode()


USE = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
FRONT_REQUESTS = {
    "aggregate-inline": ("log.csv", _body(AGG.replace("'", "&apos;"), USE)),
    "aggregate-erasure": ("big.csv", _body(AGG.replace("'", "&apos;"), USE)),
    "projection-erasure-json-out": ("big.csv", _body(
        "SELECT s.id, s.path FROM S3Object s WHERE cast(s.latency_ms as float) &gt; 300.0", USE, "<JSON/>")),
    "progress": ("big.csv", _body("SELECT count(*) FROM S3Object", USE, extra=
                                  "<RequestProgress><Enabled>true</Enabled></RequestProgress>")),
    "gzip": ("log.csv.gz", _body("SELECT count(*) FROM S3Object",
                                 f"<CompressionType>GZIP</CompressionType>{USE}")),
    "json-lines": ("log.json", _body("SELECT s.region, s.tags[0] FROM S3Object s WHERE s.bytes &lt; 1000000",
                                     "<JSON><Type>LINES</Type></JSON>", "<JSON/>")),
    "parquet": ("t.parquet", _body("SELECT s.s, s.n FROM S3Object s WHERE s.n &gt; 15000000", "<Parquet/>")),
    "bad-column-math": ("log.csv", _body("SELECT s.region * 2 FROM S3Object s", USE)),
    "parse-error": ("log.csv", _body("SELECT FROM WHERE", USE)),
    "malformed-xml": ("log.csv", b"<SelectObjectContentRequest><Expression>"),
    "scan-range-parquet": ("t.parquet", _body("SELECT * FROM S3Object", "<Parquet/>", extra=
                                              "<ScanRange><Start>0</Start><End>9</End></ScanRange>")),
}


def _stack(root: str, pkg: str, codec):
    formats = port_format.init_format(1, 4)
    dirs = []
    for i, f in enumerate(formats):
        d = os.path.join(root, pkg, f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    if pkg == "jax":
        drives = [JaxLocalDrive(d) for d in dirs]
        sets = JaxErasureSets.from_drives(drives, jax_format.DriveFormat.load(dirs[0]), codec=codec, pool_index=0)
        return JaxServerPools([sets]), JaxS3Server, JaxThreadedServer, JaxIAMSys
    drives = [LocalDrive(d) for d in dirs]
    sets = ErasureSets.from_drives(drives, port_format.DriveFormat.load(dirs[0]), codec=codec, pool_index=0)
    return ServerPools([sets]), S3Server, ThreadedServer, IAMSys


def _send(endpoint: str, method: str, path: str, query: list, body: bytes = b"") -> tuple[int, bytes]:
    host = urllib.parse.urlparse(endpoint).netloc
    headers = sign_request(Credentials(*ROOT), method, path, query, {"host": host}, body)
    headers.pop("host")
    url = path + ("?" + urllib.parse.urlencode(query) if query else "")
    conn = http.client.HTTPConnection(host, timeout=300)
    try:
        conn.request(method, url, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def fronts(tmp_path_factory, cpu_default_codec):
    """Each package's S3 front over its own 4-drive set, holding OBJECTS;
    then every request of FRONT_REQUESTS sent to both."""
    root = str(tmp_path_factory.mktemp("selfronts"))
    servers, answers = [], {}
    try:
        for pkg, codec in (("jax", JaxHostCodec()), ("port", cpu_default_codec)):
            layer, server_cls, threaded_cls, iam_cls = _stack(root, pkg, codec)
            ts = threaded_cls(server_cls(layer, iam_cls(*ROOT), check_skew=False))
            servers.append(ts)
            endpoint = ts.start()
            assert _send(endpoint, "PUT", "/sel", [])[0] == 200
            for key, data in OBJECTS.items():
                assert _send(endpoint, "PUT", f"/sel/{key}", [], data)[0] == 200, key
            answers[pkg] = {
                name: _send(endpoint, "POST", f"/sel/{key}", [("select", ""), ("select-type", "2")], body)
                for name, (key, body) in FRONT_REQUESTS.items()
            }
            answers[pkg]["missing-key"] = _send(endpoint, "POST", "/sel/nope.csv",
                                                [("select", ""), ("select-type", "2")],
                                                FRONT_REQUESTS["aggregate-inline"][1])
        yield answers
    finally:
        for ts in servers:
            ts.stop()


@pytest.mark.parametrize("name", sorted(FRONT_REQUESTS))
def test_front_select_bytes_equal(fronts, name):
    jax, port = fronts["jax"][name], fronts["port"][name]
    assert port == jax
    key, body = FRONT_REQUESTS[name]
    if port[0] == 200:
        want = b"".join(port_s3select.run_select(port_select.S3SelectRequest.from_xml(body),
                                                 lambda _o, _n: OBJECTS[key]))
        assert port[1] == want


def test_front_bad_column_math_is_an_error_frame(fronts):
    status, body = fronts["port"]["bad-column-math"]
    assert status == 200
    errors = [m["headers"] for m in port_s3select.decode_messages(body)
              if m["headers"].get(":message-type") == "error"]
    assert len(errors) == 1 and errors[0][":error-code"] == "CastFailed"


def test_front_missing_key_is_no_such_key(fronts):
    """Before any frame: a plain S3 error, the same code from both fronts
    (the request id differs)."""
    import xml.etree.ElementTree as ET

    codes = {pkg: (fronts[pkg]["missing-key"][0], ET.fromstring(fronts[pkg]["missing-key"][1]).findtext("Code"))
             for pkg in ("jax", "port")}
    assert codes["port"] == codes["jax"] == (404, "NoSuchKey")
