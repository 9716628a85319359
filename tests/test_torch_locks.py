"""The port's dsync locks (dist/locks.py) held against the JAX package's.

``LocalLocker`` expiry and conflicts step by step in both packages; one
writer across two nodes and readers that share, over lock REST served on
real sockets; the write and read quorums with lockers down; the refresh that
loses its quorum and calls ``on_lost``; the ``lock-death`` chaos kind, which
reaches the lock RPCs through ``chaos/net.py``; the port's ``RemoteLocker``
against the JAX lock app and the reverse; and two erasure sets sharing one
``NamespaceLock``, whose writers of one key serialize in both packages.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np
import pytest
from aiohttp import web

from minio_tpu import cli as jax_cli
from minio_tpu.dist import locks as jax_locks
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.erasure import ErasureObjects as JaxErasureObjects
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch import cli
from minio_tpu_torch.chaos.faults import REGISTRY, FaultSpec
from minio_tpu_torch.dist import locks
from minio_tpu_torch.dist.transport import cluster_token
from minio_tpu_torch.object.erasure import ErasureObjects
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

TOKEN = cluster_token("locks-secret")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LockServer:
    """One node's LocalLocker served as lock REST under LOCK_PREFIX."""

    def __init__(self, pkg=locks, run_app_until=cli._run_app_until):
        self.locker = pkg.LocalLocker()
        app = web.Application()
        app.add_subapp(pkg.LOCK_PREFIX, pkg.make_lock_app(self.locker, TOKEN))
        self.stop_evt = threading.Event()
        port = _free_port()
        self.thread, errs = run_app_until(app, "127.0.0.1", port, self.stop_evt)
        assert not errs, errs
        self.url = f"http://127.0.0.1:{port}"

    def stop(self) -> None:
        self.stop_evt.set()
        self.thread.join(10)


@pytest.fixture
def servers():
    made: list = []

    def make(n: int, pkg=locks, run_app_until=cli._run_app_until) -> list:
        out = [LockServer(pkg, run_app_until) for _ in range(n)]
        made.extend(out)
        return out

    yield make
    for s in made:
        s.stop()


# -- LocalLocker ---------------------------------------------------------------------------


def _locker_steps(mod) -> list:
    lk = mod.LocalLocker()
    out = [
        lk.lock("r", "w1", True), lk.lock("r", "w2", True), lk.lock("r", "r1", False),
        lk.refresh("r", "w1"), lk.refresh("r", "nobody"), lk.unlock("r", "nobody"),
        lk.unlock("r", "w1"), lk.lock("r", "r1", False), lk.lock("r", "r2", False), lk.lock("r", "w3", True),
        sorted(lk.top_locks()[0]["holders"]), lk.top_locks()[0]["writer"],
    ]
    # A crashed holder: its entry ages past the expiry and is swept.
    for uid in ("r1", "r2"):
        lk._map["r"].uids[uid] -= mod.EXPIRY + 1
    out += [lk.lock("r", "w4", True), lk.top_locks(), lk.force_unlock("r"), lk.force_unlock("r"), lk.top_locks()]
    return out


def test_local_locker_equals_jax():
    assert _locker_steps(locks) == _locker_steps(jax_locks)
    assert (locks.EXPIRY, locks.REFRESH_INTERVAL, locks.LOCK_PREFIX) == \
        (jax_locks.EXPIRY, jax_locks.REFRESH_INTERVAL, jax_locks.LOCK_PREFIX)


def test_local_locker_expiry():
    lk = locks.LocalLocker()
    assert lk.lock("res", "uid1", True)
    assert not lk.lock("res", "uid2", True)
    lk._map["res"].uids["uid1"] -= locks.EXPIRY + 1
    assert lk.lock("res", "uid2", True)  # the expired entry was swept
    assert lk.top_locks() == [{"resource": "res", "writer": True, "holders": ["uid2"]}]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 16])
def test_quorum_sizes_equal_jax(n):
    for writer in (True, False):
        assert locks.DRWMutex([None] * n, "r")._quorum(writer) == jax_locks.DRWMutex([None] * n, "r")._quorum(writer)


# -- across nodes --------------------------------------------------------------------------


def test_one_writer_across_two_nodes(servers):
    a, b = servers(2)
    m0 = locks.DRWMutex([a.locker, locks.RemoteLocker(b.url, TOKEN)], "bucket/lock-test")
    m1 = locks.DRWMutex([locks.RemoteLocker(a.url, TOKEN), b.locker], "bucket/lock-test")
    assert m0.acquire(writer=True, timeout=5)
    assert not m1.acquire(writer=True, timeout=0.5)
    assert not m1.acquire(writer=False, timeout=0.3)
    m0.release()
    assert m1.acquire(writer=True, timeout=5)
    assert a.locker.top_locks()[0]["holders"] == [m1.uid] == b.locker.top_locks()[0]["holders"]
    m1.release()
    assert a.locker.top_locks() == b.locker.top_locks() == []


def test_readers_share(servers):
    a, b = servers(2)
    lockers = [a.locker, locks.RemoteLocker(b.url, TOKEN)]
    r0, r1 = locks.DRWMutex(lockers, "bucket/rlock"), locks.DRWMutex(lockers, "bucket/rlock")
    assert r0.acquire(writer=False, timeout=2) and r1.acquire(writer=False, timeout=2)
    w = locks.DRWMutex(lockers, "bucket/rlock")
    assert not w.acquire(writer=True, timeout=0.5)
    r0.release()
    r1.release()
    assert w.acquire(writer=True, timeout=2)
    w.release()


def test_quorum_with_one_locker_down(servers):
    a, b, c = servers(3)
    lockers = [a.locker, locks.RemoteLocker(b.url, TOKEN), locks.RemoteLocker(c.url, TOKEN)]
    c.stop()  # 2 of 3 lockers answer: the write quorum (2) still holds
    m = locks.DRWMutex(lockers, "bucket/quorum")
    assert m.acquire(writer=True, timeout=5)
    assert sorted(m._held) == [0, 1]
    m.release()
    b.stop()  # 1 of 3: below the write quorum, and at the read quorum (1)
    assert not locks.DRWMutex(lockers, "bucket/quorum").acquire(writer=True, timeout=0.5)
    r = locks.DRWMutex(lockers, "bucket/quorum")
    assert r.acquire(writer=False, timeout=2)
    r.release()


def test_refresh_that_loses_its_quorum_calls_on_lost(servers):
    a, b = servers(2)
    lost = []
    m = locks.DRWMutex([a.locker, locks.RemoteLocker(b.url, TOKEN)], "bucket/lost", on_lost=lambda: lost.append(1))
    assert m.acquire(writer=True, timeout=5)
    assert m._refresh_round() and not m.lost.is_set()
    b.locker.force_unlock("bucket/lost")  # the peer forgets the entry
    assert not m._refresh_round()
    assert m.lost.is_set() and lost == [1]
    m.release()


def test_lock_death_reaches_the_lock_rpcs(servers):
    a, b = servers(2)
    remote = locks.RemoteLocker(b.url, TOKEN)
    fid = REGISTRY.arm(FaultSpec(kind="lock-death", target=b.url))
    try:
        assert not remote.lock("bucket/dead", "u1", True)  # the partitioned vote is a no
        assert b.locker.top_locks() == []
        assert not locks.DRWMutex([a.locker, remote], "bucket/dead").acquire(writer=True, timeout=0.3)
        assert REGISTRY.injected_counts()[("lock-death", b.url)] >= 2
    finally:
        REGISTRY.disarm(fid)
    assert remote.lock("bucket/dead", "u1", True)


@pytest.mark.parametrize("client", ["port->jax", "jax->port"])
def test_remote_locker_across_packages(servers, client):
    if client == "port->jax":
        (srv,) = servers(1, jax_locks, jax_cli._run_app_until)
        rl = locks.RemoteLocker(srv.url, TOKEN)
    else:
        (srv,) = servers(1)
        rl = jax_locks.RemoteLocker(srv.url, TOKEN)
    steps = [
        rl.lock("b/k", "u1", True), rl.lock("b/k", "u2", False), rl.refresh("b/k", "u1"), rl.refresh("b/k", "u2"),
        srv.locker.top_locks(), rl.unlock("b/k", "u1"), rl.lock("b/k", "u2", False), rl.lock("b/k", "u3", False),
        sorted(srv.locker.top_locks()[0]["holders"]), rl.force_unlock("b/k"), srv.locker.top_locks(),
        rl.is_online(),
    ]
    assert steps == [
        True, False, True, False, [{"resource": "b/k", "writer": True, "holders": ["u1"]}], True, True, True,
        ["u2", "u3"], True, [], True,
    ]
    # A wrong token is a no vote.
    assert not type(rl)(srv.url, "bad-token").lock("b/x", "u9", True)


# -- two sets sharing one NamespaceLock ------------------------------------------------------


def _set(root: str, fmt_mod, drive_cls, eo_cls, codec, ns_lock):
    drives = []
    for i, f in enumerate(fmt_mod.init_format(1, 4)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(drive_cls(d))
    eo = eo_cls(drives, parity=1, codec=codec, ns_lock=ns_lock)
    eo.make_bucket("bkt")
    return eo


PKGS = {
    "port": (locks, port_format, LocalDrive, ErasureObjects),
    "jax": (jax_locks, jax_format, JaxLocalDrive, JaxErasureObjects),
}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_two_sets_sharing_a_namespace_lock_serialize_writers(tmp_path, pkg):
    mod, fmt_mod, drive_cls, eo_cls = PKGS[pkg]
    codec = BatchingDeviceCodec(device="cpu") if pkg == "port" else JaxHostCodec()
    ns = mod.NamespaceLock()
    sets = [_set(str(tmp_path / f"s{i}"), fmt_mod, drive_cls, eo_cls, codec, ns) for i in range(2)]
    assert sets[0].ns_lock is sets[1].ns_lock is ns
    body = np.random.default_rng(3).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    try:
        held = ns.new("bkt", "key")
        assert held.acquire(writer=True, timeout=5)
        done: list = []
        t = threading.Thread(target=lambda: done.append(sets[1].put_object("bkt", "key", body)))
        t.start()
        # A writer of another key through the same lock is not held up.
        sets[1].put_object("bkt", "other", body)
        time.sleep(0.5)
        assert not done and t.is_alive()  # the set's commit waits for the lock set 0's writer holds
        held.release()
        t.join(30)
        assert not t.is_alive() and len(done) == 1
        assert sets[1].get_object("bkt", "key")[1] == body
    finally:
        close = getattr(codec, "close", None)
        if close is not None:
            close()


def test_the_object_layer_defaults_to_one_process_namespace_lock(tmp_path):
    from minio_tpu_torch.object import erasure

    codec = BatchingDeviceCodec(device="cpu")
    try:
        a = _set(str(tmp_path / "a"), port_format, LocalDrive, ErasureObjects, codec, None)
        b = _set(str(tmp_path / "b"), port_format, LocalDrive, ErasureObjects, codec, None)
        assert a.ns_lock is b.ns_lock is erasure._process_ns_lock()
        assert isinstance(a.ns_lock, locks.NamespaceLock)
        assert [type(lk) for lk in a.ns_lock.lockers] == [locks.LocalLocker]
    finally:
        codec.close()
