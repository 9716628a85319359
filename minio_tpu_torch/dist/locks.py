"""Distributed locking: local locker + dsync quorum RW mutex + lock REST.

Role of the reference's internal/dsync (drwmutex.go:64 DRWMutex) +
cmd/local-locker.go + lock-rest-{client,server}.go: a lock is acquired by
broadcasting to every node's locker and holding a quorum (N/2+1 for writes,
N/2 for reads, drwmutex.go:173-185); partially acquired locks are released
and retried with jitter; held locks are refreshed every few seconds and a
lost refresh quorum cancels the protected operation via callback
(drwmutex.go:221-254). Locker entries expire server-side when refreshes stop,
so crashed holders don't wedge the namespace.
"""

from __future__ import annotations

import hmac
import random
import threading
import time
import uuid
from dataclasses import dataclass, field

import msgpack

from ..control.logging import GLOBAL_LOGGER
from aiohttp import web

from ..utils import deadline, errors
from .transport import ERROR_HEADER, TOKEN_HEADER, RestClient
from ..control.sanitizer import san_lock, san_rlock

LOCK_PREFIX = "/mtpu/lock/v1"
REFRESH_INTERVAL = 3.0
EXPIRY = 30.0  # entries without refresh die after this


class LockNotHeld(errors.StorageError):
    pass


# ---------------------------------------------------------------------------
# Local locker (one per node; cmd/local-locker.go:53)
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    writer: bool
    uids: dict[str, float] = field(default_factory=dict)  # uid -> last refresh


class LocalLocker:
    def __init__(self):
        self._lock = san_lock("LocalLocker._lock")
        self._map: dict[str, _Entry] = {}

    def _expire(self, resource: str) -> None:
        e = self._map.get(resource)
        if not e:
            return
        now = time.monotonic()
        dead = [u for u, t in e.uids.items() if now - t > EXPIRY]
        for u in dead:
            del e.uids[u]
        if not e.uids:
            self._map.pop(resource, None)

    def lock(self, resource: str, uid: str, writer: bool) -> bool:
        with self._lock:
            self._expire(resource)
            e = self._map.get(resource)
            if e is None:
                self._map[resource] = _Entry(writer=writer, uids={uid: time.monotonic()})
                return True
            if writer or e.writer:
                return False  # exclusive conflicts with anything
            e.uids[uid] = time.monotonic()  # shared read
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._lock:
            e = self._map.get(resource)
            if e is None or uid not in e.uids:
                return False
            del e.uids[uid]
            if not e.uids:
                del self._map[resource]
            return True

    def refresh(self, resource: str, uid: str) -> bool:
        with self._lock:
            e = self._map.get(resource)
            if e is None or uid not in e.uids:
                return False
            e.uids[uid] = time.monotonic()
            return True

    def force_unlock(self, resource: str) -> bool:
        with self._lock:
            return self._map.pop(resource, None) is not None

    def is_online(self) -> bool:
        return True

    def top_locks(self) -> list[dict]:
        with self._lock:
            return [
                {"resource": r, "writer": e.writer, "holders": list(e.uids)}
                for r, e in self._map.items()
            ]


# ---------------------------------------------------------------------------
# Lock REST (server + client) -- lock-rest-server-common.go:31-37 endpoints
# ---------------------------------------------------------------------------


def make_lock_app(locker: LocalLocker, token: str) -> web.Application:
    app = web.Application()

    def handler(fn):
        async def wrapped(request: web.Request):
            # Constant-time compare, like every api/ auth path.
            if not hmac.compare_digest(request.headers.get(TOKEN_HEADER, ""), token):
                return web.Response(status=403)
            body = await request.read()
            a = msgpack.unpackb(body, raw=False) if body else {}
            try:
                with deadline.bind_header(request.headers.get(deadline.DEADLINE_HEADER)):
                    ok = fn(a)
                return web.Response(
                    body=msgpack.packb({"ok": ok}), content_type="application/x-msgpack"
                )
            except Exception as e:  # noqa: BLE001
                return web.Response(status=500, headers={ERROR_HEADER: type(e).__name__}, text=str(e))

        return wrapped

    app.router.add_post("/lock", handler(lambda a: locker.lock(a["resource"], a["uid"], True)))
    app.router.add_post("/rlock", handler(lambda a: locker.lock(a["resource"], a["uid"], False)))
    app.router.add_post("/unlock", handler(lambda a: locker.unlock(a["resource"], a["uid"])))
    app.router.add_post("/runlock", handler(lambda a: locker.unlock(a["resource"], a["uid"])))
    app.router.add_post("/refresh", handler(lambda a: locker.refresh(a["resource"], a["uid"])))
    app.router.add_post(
        "/force-unlock", handler(lambda a: locker.force_unlock(a["resource"]))
    )
    return app


class RemoteLocker:
    """Lock REST client to one peer node."""

    def __init__(self, node_url: str, token: str):
        self.client = RestClient(node_url.rstrip("/") + LOCK_PREFIX, token, timeout=5.0)

    def _call(self, op: str, resource: str, uid: str) -> bool:
        try:
            r = self.client.call(f"/{op}", {"resource": resource, "uid": uid})
            return bool(r and r.get("ok"))
        except errors.StorageError:
            return False

    def lock(self, resource, uid, writer):
        return self._call("lock" if writer else "rlock", resource, uid)

    def unlock(self, resource, uid):
        return self._call("unlock", resource, uid)

    def refresh(self, resource, uid):
        return self._call("refresh", resource, uid)

    def force_unlock(self, resource):
        return self._call("force-unlock", resource, "")

    def is_online(self):
        return self.client.is_online()


# ---------------------------------------------------------------------------
# DRWMutex -- quorum lock over all lockers (internal/dsync/drwmutex.go:64)
# ---------------------------------------------------------------------------


class DRWMutex:
    def __init__(self, lockers: list, resource: str, on_lost=None):
        self.lockers = lockers
        self.resource = resource
        self.uid = str(uuid.uuid4())
        self.on_lost = on_lost
        self._held: list[int] = []  # locker indexes we hold
        self._writer = False
        self._stop = threading.Event()
        self.lost = threading.Event()

    def _quorum(self, writer: bool) -> int:
        # Write: N/2+1; read: N/2 (min 1) -- drwmutex.go:173-185.
        n = len(self.lockers)
        return n // 2 + 1 if writer else max(n // 2, 1)

    def acquire(self, writer: bool = True, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        quorum = self._quorum(writer)
        while time.monotonic() < deadline:
            held = []
            for i, lk in enumerate(self.lockers):
                try:
                    if lk.lock(self.resource, self.uid, writer):
                        held.append(i)
                except Exception as e:  # noqa: BLE001 - a dead locker is a no-vote
                    GLOBAL_LOGGER.log_once(
                        f"locker {i} vote failed for {self.resource}: {e}",
                        key=f"locker-vote-{i}",
                    )
                    continue
            if len(held) >= quorum:
                self._held = held
                self._writer = writer
                self._start_refresher()
                return True
            # Partial acquisition: release and retry with jitter
            # (drwmutex.go:216 randomized backoff).
            for i in held:
                try:
                    self.lockers[i].unlock(self.resource, self.uid)
                except Exception as e:  # noqa: BLE001 - best-effort rollback
                    GLOBAL_LOGGER.log_once(
                        f"locker {i} rollback-unlock failed: {e}", key=f"locker-unlock-{i}"
                    )
            time.sleep(random.uniform(0.005, 0.05))
        return False

    def release(self) -> None:
        self._stop.set()
        _refresh_daemon.unregister(self)
        for i in self._held:
            try:
                self.lockers[i].unlock(self.resource, self.uid)
            except Exception as e:  # noqa: BLE001 - lease expiry reclaims it
                GLOBAL_LOGGER.log_once(
                    f"locker {i} release-unlock failed: {e}", key=f"locker-unlock-{i}"
                )
        self._held = []

    def _start_refresher(self) -> None:
        self._stop.clear()
        _refresh_daemon.register(self)

    def _refresh_round(self) -> bool:
        """One refresh sweep; returns False when the quorum is lost."""
        ok = 0
        for i in list(self._held):
            try:
                if self.lockers[i].refresh(self.resource, self.uid):
                    ok += 1
            except Exception as e:  # noqa: BLE001 - counted as a lost vote
                GLOBAL_LOGGER.log_once(
                    f"locker {i} refresh failed for {self.resource}: {e}",
                    key=f"locker-refresh-{i}",
                )
                continue
        if ok >= self._quorum(self._writer):
            return True
        # Lost the lock: cancel the protected operation
        # (drwmutex.go:221 loss callback).
        self.lost.set()
        if self.on_lost is not None:
            try:
                self.on_lost()
            except Exception as e:  # noqa: BLE001 - loss is already being handled
                GLOBAL_LOGGER.error("lock-lost callback raised", exc=e)
        return False

    def __enter__(self):
        if not self.acquire(True):
            raise LockNotHeld(self.resource)
        return self

    def __exit__(self, *exc):
        self.release()


class _RefreshDaemon:
    """One process-wide refresher thread for every held DRWMutex.

    The reference runs a goroutine per held lock (drwmutex.go:221); a Python
    thread per acquisition costs ~1 ms of spawn+join on the PUT commit path
    for a lock typically held for microseconds. One shared daemon sweeping
    all registered mutexes every REFRESH_INTERVAL gives the same liveness
    (server-side entries expire after EXPIRY=30 s — ten missed sweeps)."""

    def __init__(self):
        self._mu = san_lock("_RefreshDaemon._mu")
        self._live: dict[int, DRWMutex] = {}
        self._thread: threading.Thread | None = None
        self._pool = None

    def register(self, m: DRWMutex) -> None:
        with self._mu:
            self._live[id(m)] = m
            if self._thread is None or not self._thread.is_alive():
                # mtpulint: disable=unjoined-thread -- process-lifetime
                # singleton by design: one daemon sweeps EVERY live DRWMutex
                # for the process and parks (see _loop) when none remain;
                # mtpusan SUPPRESSIONS carries the matching runtime entry.
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="lock-refresh"
                )
                self._thread.start()

    def unregister(self, m: DRWMutex) -> None:
        with self._mu:
            self._live.pop(id(m), None)

    def _loop(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        # Refresh mutexes CONCURRENTLY: a blackholed peer stalls its
        # RemoteLocker call for the full 5 s REST timeout, and a sequential
        # sweep of many held locks through one dead peer could overrun the
        # 30 s server-side EXPIRY — expiring locks this daemon exists to
        # keep alive. Eight lanes bound the convoy to ceil(n/8) timeouts.
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="lock-refresh")
        while True:
            time.sleep(REFRESH_INTERVAL)
            with self._mu:
                batch = list(self._live.values())
            if not batch:
                continue

            def one(m):
                if m._stop.is_set() or not m._refresh_round():
                    self.unregister(m)

            list(self._pool.map(one, batch))


_refresh_daemon = _RefreshDaemon()


# ---------------------------------------------------------------------------
# Namespace lock (cmd/namespace-lock.go role)
# ---------------------------------------------------------------------------


class NamespaceLock:
    """Per-object lock factory. Single-node: one LocalLocker. Distributed:
    all nodes' lockers behind DRWMutex quorum."""

    def __init__(self, lockers: list | None = None):
        self.lockers = lockers if lockers is not None else [LocalLocker()]

    def new(self, bucket: str, object_name: str, on_lost=None) -> DRWMutex:
        return DRWMutex(self.lockers, f"{bucket}/{object_name}", on_lost=on_lost)
