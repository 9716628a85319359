"""CLI bootstrap: the `minio server`-shaped entry point of the port.

Role of the reference's main.go / cmd/main.go / server-main.go (:422) +
endpoint-ellipses.go: parse `server` arguments with `{a...b}` ellipses
expansion into the ordered endpoint list, pick up the env-var config surface
(root credentials, set drive count, storage class), hard-fail boot golden
self-tests for the erasure/bitrot algorithms (erasure-coding.go:158
erasureSelfTest, bitrot.go:214 bitrotSelfTest), assemble the node (device
probe + codec install, format consensus, pools, control plane) and serve S3
and admin on one port until SIGINT/SIGTERM.

Usage:
    python -m minio_tpu_torch server /data/disk{1...16}
    python -m minio_tpu_torch server --device cpu /tmp/disk{1...4}
    python -m minio_tpu_torch server --url http://10.0.0.1:9000 \
        http://10.0.0.{1...4}:9000/mnt/disk{1...16}
    python -m minio_tpu_torch server /data/one            # one path: the FS backend
    python -m minio_tpu_torch gateway nas /mnt/shared
    python -m minio_tpu_torch gateway s3 http://10.0.0.1:9000
    python -m minio_tpu_torch update file:///mirror [--apply]

Every node of a cluster gets the same ordered endpoint list and its own
``--url``; endpoints on other nodes are reached over storage REST.

``--device`` is the data plane's device: ``cuda`` (the default) probes the
card in a bounded child and serves through its kernels; without a working
card the boot fails (FATAL, exit 1) -- there is no host fallback. ``cpu``
runs the kernels' plain torch versions, because the caller asked for it.
One path with no erasure format.json, and the ``gateway`` command, serve the
S3 front over plain files (object/fs.py) or a backing S3 endpoint
(object/gateway.py): they run no erasure, so they start no probe and build
no codec, and ``--device`` does not apply to them.

Env (reference names kept where the semantic matches, common-main.go
serverHandleEnvVars):
    MINIO_ROOT_USER / MINIO_ROOT_PASSWORD      root credentials
    MINIO_ERASURE_SET_DRIVE_COUNT              drives per erasure set
    MINIO_STORAGE_CLASS_STANDARD=EC:4          parity drive count
    MINIO_REGION                               cluster region
    MINIO_KMS_SECRET_KEY                       static KMS master key
    MINIO_TPU_CODEC=auto|device|host           data-plane codec (runtime.py)
    MTPU_WORKERS=N                             pre-fork N accept workers on one
                                               port (api/prefork.py), each with
                                               its own probe and codec
    MTPU_WORKER_RESPAWNS                       respawns per worker slot (2)
    MINIO_GATEWAY_ACCESS_KEY / _SECRET_KEY     backing S3 credentials of
    MINIO_GATEWAY_REGION                       `gateway s3` (default: root's)
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import re
import signal
import sys
import threading
import time

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

# Seconds a SIGTERMed server waits for its scanner to reach its next object.
SCANNER_GRACE_S = 10.0


def expand_ellipses(pattern: str) -> list[str]:
    """`{a...b}` range expansion, left-to-right cartesian for multiple ranges
    (endpoint-ellipses.go:68 ellipses.FindEllipsesPatterns). Numeric only;
    zero-padding follows the left bound: {01...16} -> 01, 02, ... 16."""
    matches = list(_ELLIPSIS.finditer(pattern))
    if not matches:
        # Unmatched braces are almost always a typo'd ellipsis ({1..4},
        # {a...d}); booting them as literal paths would silently format a
        # single mis-named drive.
        if "{" in pattern or "}" in pattern:
            raise ValueError(
                f"unrecognized ellipsis pattern in {pattern!r} (expected {{N...M}})"
            )
        return [pattern]
    ranges = []
    for m in matches:
        lo_s, hi_s = m.group(1), m.group(2)
        lo, hi = int(lo_s), int(hi_s)
        if hi < lo:
            raise ValueError(f"bad ellipsis range {m.group(0)}")
        width = len(lo_s) if lo_s.startswith("0") else 0
        ranges.append([str(v).zfill(width) for v in range(lo, hi + 1)])
    out = []
    for combo in itertools.product(*ranges):
        s, last = [], 0
        for m, val in zip(matches, combo):
            s.append(pattern[last:m.start()])
            s.append(val)
            last = m.end()
        s.append(pattern[last:])
        out.append("".join(s))
    return out


def expand_endpoints(args: list[str]) -> list[str]:
    out: list[str] = []
    for a in args:
        out.extend(expand_ellipses(a))
    if len(set(out)) != len(out):
        raise ValueError("duplicate endpoints after ellipses expansion")
    return out


def boot_self_test() -> None:
    """Hard-fail algorithm self-tests (erasure-coding.go:158, bitrot.go:214)."""
    import numpy as np

    from .ops import rs_ref
    from .ops.goldens import HH_GOLDEN, RS_GOLDEN
    from .ops.highwayhash import hash256

    if hash256(bytes(range(64))).hex() != HH_GOLDEN:
        raise SystemExit("FATAL: HighwayHash-256 self-test failed")
    data = np.frombuffer(bytes(range(256)), dtype=np.uint8).reshape(4, 64)
    enc = rs_ref.encode(data.copy(), parity=2)
    if hashlib.sha256(enc.tobytes()).hexdigest() != RS_GOLDEN:
        raise SystemExit("FATAL: Reed-Solomon self-test failed")
    # Reconstruct round-trip with two shards lost.
    shards: list = [enc[i].copy() for i in range(6)]
    shards[1] = None
    shards[4] = None
    rec = rs_ref.reconstruct(shards, k=4, parity=2)
    if not np.array_equal(np.stack(rec), enc):
        raise SystemExit("FATAL: Reed-Solomon reconstruct self-test failed")


def _log(quiet: bool, as_json: bool, **fields) -> None:
    if quiet:
        return
    line = json.dumps(fields) if as_json else " ".join(f"{k}={v}" for k, v in fields.items())
    # One write with its newline: pre-forked workers share this stream, and
    # an unbuffered print writes the text and the newline apart.
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def serve(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="minio_tpu_torch server")
    p.add_argument("endpoints", nargs="+", help="drive paths/URLs, {a...b} ellipses supported")
    p.add_argument("--address", default=":9000", help="listen address [HOST]:PORT")
    p.add_argument("--url", default="", help="this node's advertised URL (multi-node)")
    p.add_argument("--set-drive-count", type=int, default=0)
    p.add_argument("--parity", type=int, default=-1)
    p.add_argument("--region", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="data-plane device: cuda (probed, no fallback) or cpu (plain versions)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("--no-selftest", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)

    root_user = os.environ.get("MINIO_ROOT_USER", "minioadmin")
    root_password = os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")
    set_count = a.set_drive_count or int(os.environ.get("MINIO_ERASURE_SET_DRIVE_COUNT", "0"))
    region = a.region or os.environ.get("MINIO_REGION", "us-east-1")
    parity = a.parity if a.parity >= 0 else None
    if parity is None:
        sc = os.environ.get("MINIO_STORAGE_CLASS_STANDARD", "")
        if sc.startswith("EC:"):
            parity = int(sc[3:])
    rrs_parity = None
    rrs = os.environ.get("MINIO_STORAGE_CLASS_RRS", "")
    if rrs.startswith("EC:"):
        rrs_parity = int(rrs[3:])

    # Opt-in pre-fork accept workers (MTPU_WORKERS=N): fork NOW, before any
    # runtime state exists -- before the probe child's thread below, before
    # torch and any CUDA context (forking after those is undefined) -- and
    # let each worker run this same body single-process: its own probe
    # child and codec on the card, binding the shared port with SO_REUSEPORT.
    # Gated on the platform probes in plan_workers (fork, SO_REUSEPORT, a
    # real GIL), as in the JAX package, remote endpoints or not: each worker
    # then holds its own LocalLocker, and a peer's lock RPC reaches
    # whichever worker accepts it (ROADMAP.md observations).
    from .api import prefork

    n_workers, why = prefork.plan_workers()
    if n_workers > 1:
        _log(a.quiet, a.json, msg="prefork", workers=n_workers, detail=why)
        return prefork.run_master(n_workers, lambda _wid: serve(argv))

    try:
        # Multi-pool rule (the reference's endpoint-ellipses multi-arg
        # semantics): when more than one argument carries an ellipsis
        # pattern, EACH argument is an independent server pool; plain
        # path lists stay one pool (`server /d1 /d2 /d3 /d4`).
        ellipsis_args = [arg for arg in a.endpoints if "..." in arg]
        if ellipsis_args and len(ellipsis_args) != len(a.endpoints):
            # All-or-none (the reference's rule): a forgotten ellipsis on
            # one pool argument must not silently collapse pool boundaries.
            raise ValueError(
                "either every endpoint argument uses {a...b} ellipses "
                "(one pool per argument) or none do (one flat pool)"
            )
        if len(ellipsis_args) > 1:
            pools = [expand_endpoints([arg]) for arg in a.endpoints]
            flat = [e for pool in pools for e in pool]
            if len(set(flat)) != len(flat):
                raise ValueError("duplicate endpoints across pools")
            endpoints: list = pools
            n_endpoints = len(flat)
        else:
            endpoints = expand_endpoints(a.endpoints)
            n_endpoints = len(endpoints)
    except ValueError as e:
        p.error(str(e))
    host, port = _parse_address(p, a.address)

    # Single path -> FS backend, no erasure (the reference picks FS for one
    # endpoint, server-main.go:636-643) -- UNLESS the path already holds an
    # erasure format from an earlier deployment; silently switching backends
    # would hide all existing data. Decided before the probe: the FS backend
    # builds no codec and starts no probe.
    single_path = (
        len(endpoints) == 1
        and isinstance(endpoints[0], str)
        and not endpoints[0].startswith(("http://", "https://"))
    )
    fs_mode = single_path and not os.path.exists(
        os.path.join(endpoints[0], ".minio_tpu.sys", "format.json")
    )

    if (
        not fs_mode
        and a.device == "cuda"
        and os.environ.get("MINIO_TPU_CODEC", "auto").lower() == "auto"
    ):
        # Spawn the probe child before this process imports torch: the two
        # overlap, and Node.build() waits for the verdict.
        from . import runtime

        runtime.start_probe()

    if not a.no_selftest:
        t0 = time.perf_counter()
        boot_self_test()
        _log(a.quiet, a.json, msg="self-tests passed", seconds=round(time.perf_counter() - t0, 3))
    _log(a.quiet, a.json, msg="endpoints", count=n_endpoints)

    if fs_mode:
        return _serve_simple_layer(
            "fs", endpoints[0], host, port, root_user, root_password, region, a
        )
    if single_path:
        _log(a.quiet, a.json, msg="existing erasure format found; staying on erasure backend")

    from .dist.node import Node

    node = Node(
        endpoints,
        url=a.url,
        root_user=root_user,
        root_password=root_password,
        set_drive_count=set_count or None,
        parity=parity,
        rrs_parity=rrs_parity,
        region=region,
        device=a.device,
    )
    app = node.make_app()

    # Serve BEFORE build: peers need this node's storage REST up to reach
    # format quorum (server-main.go:495-521 starts dist routers first), and
    # S3 requests that come before the probe's verdict and the format quorum
    # answer 503 "server initializing".
    stop_evt = threading.Event()
    t, startup_errors = _run_app_until(app, host, port, stop_evt)
    if startup_errors:
        print(f"FATAL: HTTP server failed to start: {startup_errors[0]}", file=sys.stderr)
        return 1
    _log(a.quiet, a.json, msg="listening", address=f"{host}:{port}")

    # Signal handlers BEFORE the (possibly long) probe and format wait, so
    # SIGTERM during boot still shuts down cleanly.
    def _shutdown(signum, frame):
        _log(a.quiet, a.json, msg="shutting down", signal=signum)
        stop_evt.set()

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)

    from .runtime import shutdown_data_plane

    try:
        # Probes the card (auto on cuda) before anything is served: a failed
        # verdict raises here with the probe's error and transcript tail.
        node.build()
    except Exception as e:  # noqa: BLE001
        print(f"FATAL: node bootstrap failed: {e}", file=sys.stderr, flush=True)
        stop_evt.set()
        node.close()
        shutdown_data_plane(node.codec)
        t.join(5)
        return 1
    if not stop_evt.is_set():
        from .runtime import probe_status

        n_sets = sum(len(p.sets) for p in node.pools.pools)
        verdict = probe_status()
        # Which process is online, and its own probe's verdict: under
        # MTPU_WORKERS every worker probes the card and logs this line.
        who = {"pid": os.getpid()}
        if os.environ.get(prefork.WORKER_ENV):
            who["worker"] = int(os.environ.get(prefork.WORKER_ID_ENV, "0"))
        if verdict is not None:
            who["probe"] = f"PROBE_OK {verdict.platform} {verdict.device_kind}"
        _log(
            a.quiet,
            a.json,
            msg="online",
            codec=type(node.codec).__name__,
            device=a.device,
            drives=len(node.drives),
            pools=len(node.pools.pools),
            sets=n_sets,
            set_drive_count=node.set_drive_count,
            s3=f"http://{host}:{port}",
            admin=f"http://{host}:{port}/mtpu/admin/v1",
            **who,
        )
        # The background scanner runs for as long as the node serves. Under
        # MTPU_WORKERS every worker's node has one; the never-released dsync
        # leader lock lets one of them scan at a time.
        node.scanner.start()
    while not stop_evt.is_set():
        time.sleep(0.2)
    # The scanner's cycle is abandoned, as the reference's server exits
    # without waiting for its scanner: the loop gets a short grace to reach
    # its next object. One still inside a call after it is logged with its
    # stack and left behind, and the process ends without joining the
    # drive-I/O workers that call may hold.
    busy = not node.scanner.stop(timeout=SCANNER_GRACE_S)
    if busy:
        _log(a.quiet, a.json, msg="scanner still busy at shutdown", grace_s=SCANNER_GRACE_S,
             stack=node.scanner.stack())
    # Replication, then site replication, as the JAX serve closes them. A
    # replica send still waiting on a target is left behind like a busy
    # scanner: its worker is a daemon thread.
    for sub, what in ((node.replication, "replication"), (node.site_repl, "site replication")):
        if sub is not None:
            ended = sub.close()
            _log(a.quiet, a.json, msg=f"{what} closed", ended=ended)
            busy = busy or not ended
    node.close()
    shutdown_data_plane(node.codec)
    t.join(5)
    if busy:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    return 0


def _parse_address(p, address: str) -> tuple[str, int]:
    host, _, port_s = address.rpartition(":")
    host = host or "0.0.0.0"
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # bracketed IPv6 -> bare address for bind()
    try:
        return host, int(port_s)
    except ValueError:
        p.error(f"--address must be [HOST]:PORT, got {address!r}")


def _run_app_until(app, host, port, stop_evt):
    """Serve an aiohttp app on a background thread until stop_evt; returns
    (thread, error_list) with the thread started and the socket bound (or an
    error recorded)."""
    from aiohttp import web

    runner_ready = threading.Event()
    thread_error: list[BaseException] = []

    def _run_app():
        import asyncio

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        try:
            loop.run_until_complete(runner.setup())
            # Pre-fork workers share the port: SO_REUSEPORT lets the kernel
            # load-balance accepts across the sibling processes.
            from .api.prefork import WORKER_ENV

            site = web.TCPSite(runner, host, port, reuse_port=bool(os.environ.get(WORKER_ENV)) or None)
            loop.run_until_complete(site.start())
        except BaseException as e:  # noqa: BLE001 - surfaced to the main thread
            thread_error.append(e)
            runner_ready.set()
            loop.close()
            return
        runner_ready.set()

        async def _wait():
            while not stop_evt.is_set():
                await asyncio.sleep(0.2)

        loop.run_until_complete(_wait())
        loop.run_until_complete(runner.cleanup())
        loop.close()

    # mtpulint: disable=unjoined-thread -- the serving thread IS the process:
    # it lives until stop_evt at exit; callers hold the handle to join.
    t = threading.Thread(target=_run_app, daemon=True, name="http-server")
    t.start()
    if not runner_ready.wait(10) or thread_error:
        return t, thread_error or [TimeoutError("startup timeout")]
    return t, []


def _serve_simple_layer(kind, target, host, port, root_user, root_password, region, a) -> int:
    """Serve an S3 front over a non-erasure layer (FS backend / gateways) —
    the reference's gateway-main.go + FS server path. No probe and no codec:
    these layers run no erasure on this node."""
    from aiohttp import web

    from .api.admin import ADMIN_PREFIX, make_admin_app, AdminContext
    from .api.server import S3Server
    from .control.config import ConfigSys
    from .control.iam import IAMSys

    if kind == "fs":
        from .object.fs import FSObjectLayer

        layer = FSObjectLayer(target)
    elif kind == "nas":
        from .object.gateway import NASGateway

        layer = NASGateway(target)
    elif kind == "s3":
        from .object.gateway import S3Gateway

        layer = S3Gateway(
            target,
            os.environ.get("MINIO_GATEWAY_ACCESS_KEY", root_user),
            os.environ.get("MINIO_GATEWAY_SECRET_KEY", root_password),
            region=os.environ.get("MINIO_GATEWAY_REGION", region),
        )
    else:
        print(f"unknown gateway type {kind!r}; supported: nas, s3", file=sys.stderr)
        return 2

    config = ConfigSys()
    iam = IAMSys(root_user, root_password)
    # Gateway mode has no erasure meta bucket to persist IAM into; etcd is
    # the reference's answer there (iam.go picks the etcd store whenever
    # one is configured) — without it, gateway IAM is memory-only.
    from .control.etcd import etcd_store_from_env
    from .utils import errors as _errs

    etcd_store = etcd_store_from_env()
    if etcd_store is not None:
        iam.store = etcd_store
        try:
            iam.load()
        except _errs.FileCorrupt as e:
            # Wrong root credential, not an outage: serving with zero
            # identities would mask the misconfiguration. Fail the boot.
            print(f"fatal: etcd IAM store unseal failed ({e})", file=sys.stderr)
            return 1
        except _errs.StorageError as e:
            print(f"warning: etcd IAM store unreadable ({e}); IAM is memory-only", file=sys.stderr)
            iam.store = None
    srv = S3Server(layer, iam, region=region, check_skew=False, config=config)
    app = web.Application(client_max_size=1 << 31)
    app.add_subapp(
        ADMIN_PREFIX,
        make_admin_app(AdminContext(layer=layer, iam=iam, verifier=srv.verifier, config=config)),
    )
    app.router.add_route("*", "/{tail:.*}", srv._entry)

    stop_evt = threading.Event()
    t, startup_errors = _run_app_until(app, host, port, stop_evt)
    if startup_errors:
        print(f"FATAL: HTTP server failed to start: {startup_errors[0]}", file=sys.stderr)
        return 1

    def _shutdown(signum, frame):
        _log(a.quiet, a.json, msg="shutting down", signal=signum)
        stop_evt.set()

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)
    mode = "fs" if kind == "fs" else f"gateway-{kind}"
    _log(a.quiet, a.json, msg="online", mode=mode, target=target,
         s3=f"http://{host}:{port}")
    while not stop_evt.is_set():
        time.sleep(0.2)
    t.join(5)
    return 0


def gateway(argv: list[str]) -> int:
    """`python -m minio_tpu_torch gateway nas|s3 <target>`: the S3 front over
    a shared mount or a backing S3 endpoint (cmd/gateway-main.go role)."""
    p = argparse.ArgumentParser(prog="minio_tpu_torch gateway")
    p.add_argument("type", choices=["nas", "s3"], help="gateway backend type")
    p.add_argument("target", help="NAS mount path or backing S3 endpoint URL")
    p.add_argument("--address", default=":9000")
    p.add_argument("--region", default="")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true")
    a = p.parse_args(argv)
    root_user = os.environ.get("MINIO_ROOT_USER", "minioadmin")
    root_password = os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")
    region = a.region or os.environ.get("MINIO_REGION", "us-east-1")
    host, port = _parse_address(p, a.address)
    return _serve_simple_layer(a.type, a.target, host, port, root_user, root_password, region, a)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "server":
        return serve(rest)
    if cmd == "gateway":
        return gateway(rest)
    if cmd == "update":
        return update_cmd(rest)
    print(f"unknown command {cmd!r}; supported: server, gateway, update", file=sys.stderr)
    return 2


def update_cmd(argv: list[str]) -> int:
    """`python -m minio_tpu_torch update <base-url>`: check + verify + stage
    a release (cmd/update.go role). Applies only with --apply; otherwise it
    stages and prints what it would do — updates should be two-phase on
    servers. The release must carry a minio_tpu_torch/ tree: --apply swaps
    this package's directory, not the JAX package's."""
    p = argparse.ArgumentParser(prog="minio_tpu_torch update")
    p.add_argument("url", help="release base URL (https:// or file:// mirror)")
    p.add_argument("--stage-dir", default=os.path.expanduser("~/.minio_tpu/updates"))
    p.add_argument("--apply", action="store_true", help="swap the running tree")
    p.add_argument(
        "--allow-unsigned", action="store_true",
        help="accept a release without a signature (NOT for production)",
    )
    a = p.parse_args(argv)
    from .control import update as upd

    try:
        info = upd.check_update(a.url, allow_unsigned=a.allow_unsigned)
        print(f"release: {info.version} sha256={info.sha256[:16]}...")
        os.makedirs(a.stage_dir, exist_ok=True)
        staged = upd.download_and_stage(info, a.stage_dir)
        print(f"staged: {staged}")
        if a.apply:
            # Swap the PACKAGE directory only: the grandparent would be
            # site-packages (or the repo root) and swapping that would
            # discard every other installed package.
            install = os.path.dirname(os.path.abspath(__file__))
            staged_pkg = os.path.join(staged, "minio_tpu_torch")
            if not os.path.isdir(staged_pkg):
                print("update failed: release has no minio_tpu_torch/ tree", file=sys.stderr)
                return 1
            backup = upd.apply_staged(staged_pkg, install)
            print(f"applied; previous tree at {backup}. Restart to load {info.version}.")
        else:
            print("not applied (pass --apply to swap the install tree)")
        return 0
    except upd.UpdateError as e:
        print(f"update failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
