"""Inter-node REST plumbing: msgpack-over-HTTP with typed error transport.

Role of the reference's internal/rest (client.go:76 Client with health checks
and backoff) + the msgp wire encoding of storage-rest: all inter-node traffic
is HTTP with msgpack bodies on the DCN control path; shard payloads ride raw
request/response bodies. Errors cross the wire as exception class names and
re-raise as the same utils/errors.py type on the caller. The wire is the
JAX package's: a port node and a JAX node talk to each other.
"""

from __future__ import annotations

import hashlib
import hmac
import random
import threading
import time

import msgpack
import requests

from ..chaos import net as chaos_net
from ..chaos.faults import REGISTRY as _CHAOS
from ..control import tracing
from ..control.degrade import GLOBAL_DEGRADE
from ..control.perf import GLOBAL_PERF
from ..utils import deadline, errors
from ..control.sanitizer import san_lock, san_rlock

ERROR_HEADER = "X-Mtpu-Error"
TOKEN_HEADER = "X-Mtpu-Token"
TRACE_HEADER = tracing.TRACE_HEADER
DEADLINE_HEADER = deadline.DEADLINE_HEADER
# Seconds a call may spend opening its connection. A peer whose listener
# accepts nothing (its accept queue full, or a process stopping without
# closing it) drops the SYNs, and connect() would wait out the whole call
# timeout: that held a stopping node's scanner past its shutdown grace. A
# healthy connect takes well under a millisecond; this leaves room for one
# SYN retransmission (1 s).
CONNECT_TIMEOUT = 2.0


def jitter(seconds: float, frac: float = 0.10) -> float:
    """Spread a retry/probe interval by ±frac. Peers partitioned at the same
    instant otherwise reconnect in lockstep, hammering the healed link on
    exact HEALTH_INTERVAL boundaries (the thundering-herd the reference
    avoids with randomized backoff in dsync and rest retries)."""
    return seconds * (1.0 + random.uniform(-frac, frac))


def cluster_token(secret: str) -> str:
    """Shared-secret auth token for intra-cluster REST (the reference signs
    internode requests with the root credentials; same idea)."""
    return hmac.new(secret.encode(), b"minio-tpu-internode", hashlib.sha256).hexdigest()


def error_to_name(e: Exception) -> str:
    return type(e).__name__


def name_to_error(name: str, msg: str = "") -> Exception:
    cls = getattr(errors, name, None)
    if cls is not None and isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(msg)
        except TypeError:
            return cls()
    return errors.StorageError(f"{name}: {msg}")


class DynamicTimeout:
    """Self-tuning per-channel timeout (cmd/dynamic-timeouts.go:36).

    Every 16 outcomes: >33% failures -> grow the timeout 25%; <10%
    failures -> shrink 50% of the way toward 1.25x the slowest observed
    success, floored at `minimum`. Healthy fast channels converge to
    tight timeouts (peers drop quickly), congested ones back off instead
    of flapping."""

    LOG_SIZE = 16
    MAX_TIMEOUT = 24 * 3600.0
    _FAILURE = float("inf")

    def __init__(self, timeout: float, minimum: float):
        self._timeout = timeout
        self.minimum = min(minimum, timeout)
        self._log: list[float] = []
        self._lock = san_lock("DynamicTimeout._lock")

    def timeout(self) -> float:
        return self._timeout

    def log_success(self, duration: float) -> None:
        self._entry(duration)

    def log_failure(self) -> None:
        self._entry(self._FAILURE)

    def _entry(self, duration: float) -> None:
        # The whole read-adjust-write runs under the lock: two windows
        # completing concurrently must not lose an adjustment.
        with self._lock:
            self._log.append(duration)
            if len(self._log) < self.LOG_SIZE:
                return
            entries, self._log = self._log, []
            failures = sum(1 for d in entries if d == self._FAILURE)
            slowest = max((d for d in entries if d != self._FAILURE), default=0.0)
            fail_pct = failures / len(entries)
            t = self._timeout
            if fail_pct > 0.33:
                t = min(t * 1.25, self.MAX_TIMEOUT)
            elif fail_pct < 0.10:
                target = slowest * 1.25
                if target < t:
                    t = max((target + t) / 2, self.minimum)
            self._timeout = t


class RestClient:
    """HTTP client to one peer with connection reuse, failure tracking,
    periodic reconnect probing, and a self-tuning default timeout
    (internal/rest/client.go + dynamic-timeouts.go behavior)."""

    HEALTH_INTERVAL = 3.0

    def __init__(self, base_url: str, token: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        # Per-peer ledger label: host:port, not the full prefixed URL --
        # one histogram per (peer, endpoint path) in the perf ledger.
        self._peer_label = self.base_url.split("//", 1)[-1].split("/", 1)[0]
        # One tuner PER ENDPOINT PATH: a ping and a bulk shard read must
        # not share a timeout (the reference keeps separate dynamicTimeouts
        # per operation class for the same reason). Floor at 5s so fast
        # metadata traffic can't shrink an op class under what a loaded
        # server legitimately needs.
        self._tuners: dict[str, DynamicTimeout] = {}
        self._tuners_lock = san_lock("RestClient._tuners_lock")
        self.session = requests.Session()
        self.session.headers[TOKEN_HEADER] = token
        self._online = True
        self._last_failure = 0.0
        self._probe_interval = self.HEALTH_INTERVAL
        self._lock = san_lock("RestClient._lock")

    def is_online(self) -> bool:
        with self._lock:
            if self._online:
                return True
            # Off-line: allow a probe every ~HEALTH_INTERVAL. The interval is
            # re-jittered on each failure so a fleet of clients that lost the
            # same peer together doesn't re-probe it in lockstep.
            return (time.monotonic() - self._last_failure) > self._probe_interval

    def _mark(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self._online = True
            else:
                self._online = False
                self._last_failure = time.monotonic()
                self._probe_interval = jitter(self.HEALTH_INTERVAL)

    def call(
        self,
        path: str,
        args: dict | None = None,
        body: bytes | None = None,
        raw_response: bool = False,
        timeout: float | None = None,
        stream: bool = False,
    ):
        """POST base/path. args -> msgpack body (or query when body given).
        Returns the msgpack-decoded object, raw bytes if raw_response, or
        the live response when stream=True (caller iterates + closes)."""
        # Chaos plane: one None check when disarmed. Covers storage-REST,
        # peer fanout, and lock clients -- everything rides this method.
        if _CHAOS.net is not None:
            chaos_net.before_rpc(self.base_url, path)
        url = self.base_url + path
        # Explicit timeouts win; plain calls ride the endpoint's self-tuned
        # timeout. Streams tune too: session.post(stream=True) returns at
        # response HEADERS, so the tuner times time-to-headers, and the 5s
        # tuner floor sits above the ~1s keep-alives long streams emit.
        tune = timeout is None
        dt: DynamicTimeout | None = None
        if tune:
            with self._tuners_lock:
                dt = self._tuners.get(path)
                if dt is None:
                    dt = self._tuners[path] = DynamicTimeout(
                        self.timeout, minimum=min(5.0, self.timeout)
                    )
        effective = timeout if timeout is not None else dt.timeout()
        # Deadline propagation: the remaining budget caps this hop's socket
        # timeout and rides the wire so the far side inherits it. Checked
        # AFTER the chaos hook -- an injected slow-rpc consumes budget like
        # a real slow link would.
        rem = deadline.remaining()
        capped = False
        if rem is not None:
            if rem < deadline.MIN_BUDGET:
                GLOBAL_DEGRADE.record_deadline_abort("rpc")
                raise errors.DeadlineExceeded(f"rpc{path}: budget spent before send")
            if rem < effective:
                effective = rem
                capped = True
        # The hop is a span of the caller's trace; its id rides the trace
        # header so spans opened on the far side chain under this hop.
        rpc = tracing.span(f"rpc{path}", "rpc", peer=self.base_url)
        trace_hdr = rpc.header()
        headers: dict[str, str] = {}
        if trace_hdr:
            headers[TRACE_HEADER] = trace_hdr
        if rem is not None:
            headers[DEADLINE_HEADER] = f"{max(rem, 0.0):.3f}"
        t0 = time.monotonic()
        c0 = time.thread_time()
        socket_timeout = (min(CONNECT_TIMEOUT, effective), effective)
        try:
            if body is not None:
                r = self.session.post(
                    url,
                    params={k: str(v) for k, v in (args or {}).items()},
                    data=body,
                    headers=headers or None,
                    timeout=socket_timeout,
                    stream=stream,
                )
            else:
                headers["Content-Type"] = "application/x-msgpack"
                r = self.session.post(
                    url,
                    data=msgpack.packb(args or {}, use_bin_type=True),
                    headers=headers,
                    timeout=socket_timeout,
                    stream=stream,
                )
        except requests.RequestException as e:
            self._mark(False)
            # Per-peer RPC histogram: recorded directly (not via the span,
            # which is a no-op outside request context) so background RPCs
            # -- heal, scanner, lock refresh -- are attributed too.
            GLOBAL_PERF.ledger.record(
                "rpc-peer",
                f"{path}@{self._peer_label}",
                time.monotonic() - t0,
                time.thread_time() - c0,
            )
            rpc.finish(error=type(e).__name__)
            # A timeout on a deadline-capped hop is the BUDGET expiring, not
            # the channel misbehaving: surface DeadlineExceeded (aborts the
            # whole request) instead of DiskNotFound (counts against the
            # drive), and don't feed the tuner -- a capped timeout says
            # nothing about how the channel should be sized.
            if capped and isinstance(e, requests.Timeout):
                GLOBAL_DEGRADE.record_deadline_abort("rpc")
                raise errors.DeadlineExceeded(f"rpc{path}: budget spent in flight")
            # Only READ timeouts are evidence the timeout is too small; a
            # down peer (connection-refused = ConnectionError, blackholed =
            # ConnectTimeout) says nothing about sizing and must not
            # ratchet the timeout toward the cap during an outage.
            if (
                dt is not None
                and isinstance(e, requests.Timeout)
                and not isinstance(e, requests.ConnectTimeout)
            ):
                dt.log_failure()
            raise errors.DiskNotFound(f"{url}: {e}")
        elapsed = time.monotonic() - t0
        GLOBAL_PERF.ledger.record(
            "rpc-peer",
            f"{path}@{self._peer_label}",
            elapsed,
            time.thread_time() - c0,
        )
        rpc.set(status=r.status_code)
        rpc.finish()
        self._mark(True)
        if dt is not None:
            dt.log_success(elapsed)
        if r.status_code != 200:
            name = r.headers.get(ERROR_HEADER, "StorageError")
            text = r.text[:200]
            r.close()
            raise name_to_error(name, text)
        if stream:
            return r
        if raw_response:
            return r.content
        if not r.content:
            return None
        return msgpack.unpackb(r.content, raw=False, strict_map_key=False)

    def stream_guard(self):
        """Context for consuming a streamed response body: translates
        transport failures into the typed wire error and marks the peer
        offline, matching call()'s contract."""
        return _StreamGuard(self)


class _StreamGuard:
    def __init__(self, client: "RestClient"):
        self._client = client

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and isinstance(exc, requests.RequestException):
            self._client._mark(False)
            raise errors.DiskNotFound(f"stream aborted: {exc}") from exc
        return False
