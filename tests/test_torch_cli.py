"""`python -m minio_tpu_torch server` as a real process on this host.

The server boots on ``--device cpu`` (the kernels' plain versions) over four
drives with EC:1, answers signed S3 and admin requests, writes four
format.json files, exits 0 on SIGTERM, and comes back after a restart with
its data and a user added over admin. On ``cuda`` (the default) without a
card the boot fails: FATAL with the probe's error, a non-zero exit, and no
PUT answered 200 on the way. One path with no erasure format serves the FS
backend, and `gateway nas` the same layer over a mount: each answers a
script of signed S3 and admin requests as the JAX CLI does, starts no probe
and builds no codec (so it comes online on cuda without a card).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu_torch import cli
from minio_tpu_torch.api.auth import Credentials, sign_request

REPO = Path(__file__).resolve().parent.parent
ROOT = ("cliadmin", "cli-root-secret")
USER = ("cliuser", "cli-user-secret")
BODY = np.random.default_rng(20).integers(0, 256, 20_000, dtype=np.uint8).tobytes()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _request(port: int, method: str, path: str, body=b"", creds=ROOT, timeout=60.0):
    if isinstance(body, dict):
        body = json.dumps(body).encode()
    headers = sign_request(Credentials(*creds), method, path, [], {"host": f"127.0.0.1:{port}"}, body)
    headers.pop("host", None)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


class Server:
    """One `python -m minio_tpu_torch server` process and its output."""

    def __init__(self, drives: str | list, device: str | None = "cpu", env: dict | None = None,
                 port: int | None = None, url: str = ""):
        self.port = port or _free_port()
        args = [sys.executable, "-m", "minio_tpu_torch", "server", "--address", f"127.0.0.1:{self.port}",
                "--json", *([drives] if isinstance(drives, str) else drives)]
        if url:
            args += ["--url", url]
        if device is not None:
            args[4:4] = ["--device", device]
        full_env = {**os.environ, "PYTHONPATH": str(REPO), "MINIO_ROOT_USER": ROOT[0],
                    "MINIO_ROOT_PASSWORD": ROOT[1], "MINIO_STORAGE_CLASS_STANDARD": "EC:1", **(env or {})}
        full_env.pop("MINIO_TPU_CODEC", None)
        self.proc = subprocess.Popen(args, cwd=REPO, env=full_env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.lines: list[str] = []
        self.err: list[str] = []
        self._online = threading.Event()
        self._listening = threading.Event()
        self._threads = [threading.Thread(target=self._read, args=(self.proc.stdout, self.lines), daemon=True),
                         threading.Thread(target=self._read, args=(self.proc.stderr, self.err), daemon=True)]
        for t in self._threads:
            t.start()

    def _read(self, stream, sink) -> None:
        for line in stream:
            sink.append(line)
            if '"msg": "online"' in line:
                self._online.set()
            if '"msg": "listening"' in line:
                self._listening.set()

    def wait_listening(self, timeout: float = 60.0) -> None:
        assert self._listening.wait(timeout), (self.lines, self.err)

    def wait_online(self, timeout: float = 90.0) -> dict:
        assert self._online.wait(timeout), (self.lines, self.err)
        return next(json.loads(ln) for ln in self.lines if '"msg": "online"' in ln)

    def stop(self, timeout: float = 30.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout)
        for t in self._threads:
            t.join(5)
        return rc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Boot, PUT/GET, add a user, SIGTERM; boot again and read it all back."""
    root = tmp_path_factory.mktemp("cli")
    drives = f"{root}/disk{{1...4}}"
    out = {}
    srv = Server(drives)
    try:
        out["online"] = srv.wait_online()
        p = srv.port
        out["make-bucket"] = _request(p, "PUT", "/clibkt")[0]
        out["put"] = _request(p, "PUT", "/clibkt/obj", BODY)[0]
        status, body = _request(p, "GET", "/clibkt/obj")
        out["get"] = (status, hashlib.sha256(body).hexdigest())
        out["user-add"] = _request(p, "POST", "/mtpu/admin/v1/users",
                                   {"accessKey": USER[0], "secretKey": USER[1], "policies": ["readwrite"]})[0]
        out["formats"] = [json.loads((root / f"disk{i}" / ".minio_tpu.sys" / "format.json").read_text())
                          for i in range(1, 5)]
    finally:
        out["rc"] = srv.stop()
        out["stdout"] = "".join(srv.lines)
    srv = Server(drives)
    try:
        out["restart-online"] = srv.wait_online()
        status, body = _request(srv.port, "GET", "/clibkt/obj", creds=USER)
        out["restart-user-get"] = (status, hashlib.sha256(body).hexdigest())
        status, body = _request(srv.port, "GET", "/mtpu/admin/v1/users")
        out["restart-users"] = (status, json.loads(body))
        out["restart-usage"] = _first_scan(srv.port)
    finally:
        out["restart-rc"] = srv.stop()
    return out


def _first_scan(port: int, timeout: float = 60.0) -> dict:
    """/datausage once the server's scanner has finished its first cycle
    (serve starts it once online; it scans at once, then every minute)."""
    t0 = time.monotonic()
    while True:
        status, body = _request(port, "GET", "/mtpu/admin/v1/datausage")
        doc = json.loads(body) if status == 200 else {}
        if doc.get("lastUpdate"):
            return doc
        assert time.monotonic() - t0 < timeout, (status, body)
        time.sleep(0.2)


def test_boots_on_cpu_and_serves_signed_put_and_get(served):
    online = served["online"]
    assert online["codec"] == "BatchingDeviceCodec" and online["device"] == "cpu"
    assert (online["drives"], online["pools"], online["sets"], online["set_drive_count"]) == (4, 1, 1, 4)
    assert served["make-bucket"] == served["put"] == served["user-add"] == 200
    assert served["get"] == (200, hashlib.sha256(BODY).hexdigest())


def test_four_format_json_written(served):
    formats = served["formats"]
    assert len(formats) == 4
    assert len({f["id"] for f in formats}) == 1
    assert len({f["erasure"]["this"] for f in formats}) == 4
    assert all(f["erasure"]["sets"] == formats[0]["erasure"]["sets"] for f in formats)


def test_sigterm_exits_0(served):
    assert served["rc"] == 0 and served["restart-rc"] == 0
    assert '"msg": "shutting down"' in served["stdout"]


def test_sigterm_closes_replication_then_site_replication(served):
    """serve closes bucket replication, then site replication, as the JAX
    serve does, and logs each close with whether its threads ended."""
    closed = [json.loads(ln) for ln in served["stdout"].splitlines() if ln.startswith("{")
              and json.loads(ln).get("msg", "").endswith("replication closed")]
    assert [(c["msg"], c["ended"]) for c in closed] == [("replication closed", True),
                                                        ("site replication closed", True)]


def test_scanner_starts_and_stops_with_serve(served):
    usage = served["restart-usage"]
    assert usage["objectsCount"] == 1
    assert usage["bucketsUsage"]["clibkt"] == {"objectsCount": 1, "size": len(BODY), "versionsCount": 1}
    assert served["restart-rc"] == 0  # serve stopped the scanner's thread and exited


def test_restart_keeps_data_and_the_user(served):
    assert served["restart-user-get"] == (200, hashlib.sha256(BODY).hexdigest())
    status, users = served["restart-users"]
    assert status == 200 and users[USER[0]] == {"status": "enabled", "policies": ["readwrite"]}


def test_cuda_without_a_card_fails_the_boot_and_serves_no_put(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    srv = Server(f"{tmp_path}/disk{{1...4}}", device=None, env={"MINIO_TPU_DEVICE_PROBE_S": "60"})
    statuses = []
    t0 = time.monotonic()
    while srv.proc.poll() is None and time.monotonic() - t0 < 90:
        try:
            statuses.append(_request(srv.port, "PUT", "/nobkt", timeout=5)[0])
        except OSError:
            pass  # not listening yet, or already gone
        time.sleep(0.1)
    rc = srv.stop()
    err = "".join(srv.err)
    assert rc != 0, err
    assert time.monotonic() - t0 < 60 + 30  # within the probe timeout (and the interpreter's start)
    assert "FATAL: node bootstrap failed: device probe failed" in err and "no CUDA device" in err
    assert "[probe] env:" in err
    assert 200 not in statuses and set(statuses) <= {503}
    assert not any('"msg": "online"' in ln for ln in srv.lines)


def _simple_script(port: int) -> dict:
    """Signed S3 and admin requests to a FS-backed front: {step: (status,
    the body with its random fields replaced by their shape)}."""
    csv = b"id,status,bytes\n" + b"".join(b"%d,%d,%d\n" % (i, 200 + 100 * (i % 4), i * 7) for i in range(400))
    select = (b"<SelectObjectContentRequest><Expression>SELECT count(*), sum(cast(s.bytes as int)) FROM S3Object s "
              b"WHERE s.status = '500'</Expression><ExpressionType>SQL</ExpressionType><InputSerialization><CSV>"
              b"<FileHeaderInfo>USE</FileHeaderInfo></CSV></InputSerialization><OutputSerialization><CSV/>"
              b"</OutputSerialization></SelectObjectContentRequest>")
    steps = [
        ("make-bucket", "PUT", "/fsbkt", b""),
        ("put", "PUT", "/fsbkt/dir/obj.bin", BODY),
        ("put-csv", "PUT", "/fsbkt/log.csv", csv),
        ("get", "GET", "/fsbkt/dir/obj.bin", b""),
        ("head", "HEAD", "/fsbkt/dir/obj.bin", b""),
        ("list-v2", "GET", "/fsbkt?list-type=2", b""),
        ("list-delimiter", "GET", "/fsbkt?delimiter=%2F", b""),
        ("select", "POST", "/fsbkt/log.csv?select=&select-type=2", select),
        ("get-missing", "GET", "/fsbkt/nope", b""),
        ("delete", "DELETE", "/fsbkt/dir/obj.bin", b""),
        ("list-after-delete", "GET", "/fsbkt?list-type=2", b""),
        ("admin-user-add", "POST", "/mtpu/admin/v1/users",
         {"accessKey": USER[0], "secretKey": USER[1], "policies": ["readwrite"]}),
        ("admin-users", "GET", "/mtpu/admin/v1/users", b""),
        ("admin-datausage", "GET", "/mtpu/admin/v1/datausage", b""),
        ("admin-config", "GET", "/mtpu/admin/v1/config", b""),
        ("admin-heal", "POST", "/mtpu/admin/v1/heal?bucket=fsbkt", b""),
        ("admin-pools", "GET", "/mtpu/admin/v1/pools/status", b""),
    ]
    out = {}
    for name, method, target, body in steps:
        path, _, qs = target.partition("?")
        query = [tuple(kv.split("=", 1)) for kv in qs.split("&")] if qs else []
        query = [(k, v.replace("%2F", "/")) for k, v in query]
        payload = json.dumps(body).encode() if isinstance(body, dict) else body
        headers = sign_request(Credentials(*ROOT), method, path, query, {"host": f"127.0.0.1:{port}"}, payload)
        headers.pop("host", None)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, target, body=payload, headers=headers)
            r = conn.getresponse()
            data = r.read()
        finally:
            conn.close()
        # Times, request ids and the like differ between two servers: their
        # digits and hex letters become "x".
        data = re.sub(rb"<(LastModified|RequestId|HostId|CreationDate)>[^<]*<",
                      lambda m: b"<%s>x<" % m.group(1), data)
        if name.startswith("admin-datausage"):
            data = re.sub(rb'"lastUpdate": ?[0-9.e+]+', b'"lastUpdate": x', data)
        out[name] = (r.status, data if name != "get" else hashlib.sha256(data).hexdigest())
    return out


@pytest.mark.parametrize(
    "argv,mode",
    [(["server", "{root}/one"], "fs"), (["gateway", "nas", "{root}/nas"], "gateway-nas")],
    ids=["fs-backend", "gateway-nas"],
)
def test_one_path_and_gateway_nas_serve_s3_like_the_jax_cli(tmp_path, argv, mode):
    """The port's CLI (its default device, cuda, on a host with or without
    a card) and the JAX CLI, each over its own directory: the same answers
    to the same script, an online line naming the mode, no probe, and
    exit 0 on SIGTERM."""
    answers, online, stderr = {}, {}, {}
    for pkg in ("minio_tpu", "minio_tpu_torch"):
        port = _free_port()
        args = [sys.executable, "-m", pkg, argv[0], "--address", f"127.0.0.1:{port}", "--json",
                *(a.format(root=tmp_path / pkg) for a in argv[1:])]
        env = {**os.environ, "PYTHONPATH": str(REPO), "MINIO_ROOT_USER": ROOT[0], "MINIO_ROOT_PASSWORD": ROOT[1],
               "JAX_PLATFORMS": "cpu"}
        env.pop("MINIO_TPU_CODEC", None)
        proc = subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.monotonic()
            lines = []
            while not any('"msg": "online"' in ln for ln in lines):
                line = proc.stdout.readline()
                assert line or proc.poll() is None, (lines, proc.stderr.read())
                lines.append(line)
                assert time.monotonic() - t0 < 120, lines
            online[pkg] = next(json.loads(ln) for ln in lines if '"msg": "online"' in ln)
            answers[pkg] = _simple_script(port)
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(30)
            stderr[pkg] = proc.stderr.read()
        assert rc == 0, stderr[pkg]
    assert online["minio_tpu_torch"]["mode"] == online["minio_tpu"]["mode"] == mode
    assert not {"codec", "probe", "device"} & set(online["minio_tpu_torch"])
    assert "[probe]" not in stderr["minio_tpu_torch"]
    assert sorted(answers["minio_tpu_torch"]) == sorted(answers["minio_tpu"])
    for step, want in answers["minio_tpu"].items():
        assert answers["minio_tpu_torch"][step] == want, step
    assert answers["minio_tpu_torch"]["select"][0] == 200 and answers["minio_tpu_torch"]["get"][0] == 200
    root = tmp_path / "minio_tpu_torch" / ("one" if mode == "fs" else "nas")
    assert (root / ".minio_tpu.sys" / "format-fs.json").is_file()
    assert not (root / ".minio_tpu.sys" / "format.json").exists()


def test_two_processes_form_a_cluster(tmp_path):
    """Two `server --device cpu --url ...` processes over one endpoint list
    (2 nodes x 2 drives, one EC:1 set). The leader (the owner of the first
    endpoint) is listening, and so formatting, before the other node starts:
    it formats only once the other node's drives answer. A PUT on one node
    GETs byte-exact on the other, and both exit 0 on SIGTERM."""
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    endpoints = [f"{urls[n]}{tmp_path}/n{n}d{d}" for n in range(2) for d in range(2)]
    nodes = [None, None]
    try:
        nodes[0] = Server(endpoints, port=ports[0], url=urls[0])
        nodes[0].wait_listening()
        time.sleep(1.0)  # the leader's format wait finds the other node's drives unreachable
        assert not nodes[0]._online.is_set()
        nodes[1] = Server(endpoints, port=ports[1], url=urls[1])
        online = [n.wait_online() for n in nodes]
        assert [(o["drives"], o["pools"], o["sets"]) for o in online] == [(4, 1, 1)] * 2
        formats = [json.loads((tmp_path / f"n{n}d{d}" / ".minio_tpu.sys" / "format.json").read_text())
                   for n in range(2) for d in range(2)]
        assert len({f["id"] for f in formats}) == 1 and len({f["erasure"]["this"] for f in formats}) == 4
        assert _request(ports[0], "PUT", "/clustered")[0] == 200
        assert _request(ports[0], "PUT", "/clustered/a", BODY)[0] == 200
        assert _request(ports[1], "GET", "/clustered/a") == (200, BODY)
        assert _request(ports[1], "PUT", "/clustered/b", BODY[:5000])[0] == 200
        assert _request(ports[0], "GET", "/clustered/b") == (200, BODY[:5000])
        status, body = _request(ports[0], "GET", "/mtpu/admin/v1/info")
        assert status == 200 and [s["node"] for s in json.loads(body)["servers"]] == [urls[1]]
    finally:
        rcs = [n.stop() if n is not None else None for n in nodes]
    assert rcs == [0, 0], (nodes[0].err, nodes[1].err)


def test_sigterm_leaves_a_stuck_scanner_behind(tmp_path):
    """A server whose scanner is stuck inside one call (here a scan cycle
    that sleeps, put in by a sitecustomize hook) exits 0 on SIGTERM after
    the scanner's grace and no more than a few seconds beyond it, and logs
    the scanner's stack."""
    hook = tmp_path / "hook"
    hook.mkdir()
    entered = tmp_path / "entered"
    (hook / "sitecustomize.py").write_text(
        "import time\n"
        "from minio_tpu_torch.control import scanner\n\n\n"
        "def stuck_cycle(self):\n"
        f"    open({str(entered)!r}, 'w').close()\n"
        "    time.sleep(120)\n\n\n"
        "scanner.DataScanner.scan_cycle = stuck_cycle\n"
    )
    srv = Server(f"{tmp_path}/disk{{1...4}}", env={"PYTHONPATH": f"{hook}{os.pathsep}{REPO}"})
    try:
        srv.wait_online()
        deadline = time.monotonic() + 30
        while not entered.exists():
            assert time.monotonic() < deadline, (srv.lines, srv.err)
            time.sleep(0.05)
        t0 = time.monotonic()
        assert srv.stop(60) == 0, srv.err
        took = time.monotonic() - t0
    finally:
        if srv.proc.poll() is None:
            srv.proc.kill()
            srv.proc.wait(10)
    assert cli.SCANNER_GRACE_S <= took < cli.SCANNER_GRACE_S + 10, took
    busy = [json.loads(ln) for ln in srv.lines if '"msg": "scanner still busy at shutdown"' in ln]
    assert len(busy) == 1 and "stuck_cycle" in busy[0]["stack"], srv.lines


def test_sigterm_leaves_a_stuck_replica_send_behind(tmp_path):
    """A replication worker stuck inside a replica send (here a send that
    sleeps, put in by a sitecustomize hook, as a target that stopped
    answering holds one for TargetClient's 30 s) does not hold the exit:
    the workers share ReplicationSys.close()'s 5 s, the close is logged as
    not ended, and the process exits 0 without joining the worker."""
    hook = tmp_path / "hook"
    hook.mkdir()
    entered = tmp_path / "entered"
    (hook / "sitecustomize.py").write_text(
        "import time\n"
        "from minio_tpu_torch.control import replication\n\n"
        "real_init = replication.ReplicationSys.__init__\n\n\n"
        "def init(self, *args, **kwargs):\n"
        "    real_init(self, *args, **kwargs)\n"
        "    self._enqueue(replication.ReplTask('bucket', 'object'))\n\n\n"
        "def stuck_send(self, task):\n"
        f"    open({str(entered)!r}, 'w').close()\n"
        "    time.sleep(120)\n"
        "    return True\n\n\n"
        "replication.ReplicationSys.__init__ = init\n"
        "replication.ReplicationSys._replicate = stuck_send\n"
    )
    srv = Server(f"{tmp_path}/disk{{1...4}}", env={"PYTHONPATH": f"{hook}{os.pathsep}{REPO}"})
    try:
        srv.wait_online()
        deadline = time.monotonic() + 30
        while not entered.exists():
            assert time.monotonic() < deadline, (srv.lines, srv.err)
            time.sleep(0.05)
        t0 = time.monotonic()
        assert srv.stop(60) == 0, srv.err
        took = time.monotonic() - t0
    finally:
        if srv.proc.poll() is None:
            srv.proc.kill()
            srv.proc.wait(10)
    assert 5.0 <= took < 15.0, took
    closed = [json.loads(ln) for ln in srv.lines if ln.startswith("{") and "replication closed" in ln]
    assert [(c["msg"], c["ended"]) for c in closed] == [("replication closed", False),
                                                        ("site replication closed", True)], srv.lines
