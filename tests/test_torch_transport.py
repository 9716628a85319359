"""The port's internode transport and storage REST, held against the JAX
package's on the same inputs.

transport: ``cluster_token``, the typed error names, ``DynamicTimeout`` over
one seeded outcome sequence and ``jitter``'s bounds. Storage REST in both
directions: a port ``RemoteDrive`` against the JAX ``make_storage_app``, and a
JAX ``RemoteDrive`` against the port's app, each served on a real socket.
The same scripted StorageAPI calls go to the remote drive and to a
``LocalDrive`` of the client's package over a twin directory; every method
must give the same result, or raise the same exception type. Results are
compared by value: files and listings exactly, xl.meta by its bytes, and
the fields that name a path or a clock (endpoints, free space, creation
times) by their presence.
"""

from __future__ import annotations

import inspect
import os
import socket
import threading

import numpy as np
import pytest

from minio_tpu import cli as jax_cli
from minio_tpu.dist import storage_rest as jax_rest
from minio_tpu.dist import transport as jax_transport
from minio_tpu.storage import types as jax_types
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu.utils import errors as jax_errors
from minio_tpu_torch import cli
from minio_tpu_torch.dist import storage_rest, transport
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage import types as port_types
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors

SECRET = "transport-secret"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- transport ------------------------------------------------------------------------------


@pytest.mark.parametrize("secret", ["minioadmin", SECRET, "", "ünïcode-secret"])
def test_cluster_token_equals_jax(secret):
    assert transport.cluster_token(secret) == jax_transport.cluster_token(secret)


ERROR_NAMES = sorted(
    name for name, cls in inspect.getmembers(errors, inspect.isclass)
    if issubclass(cls, Exception) and cls.__module__ == errors.__name__
)


@pytest.mark.parametrize("name", ERROR_NAMES)
def test_error_name_round_trip(name):
    cls = getattr(errors, name)
    try:
        e = cls("msg")
    except TypeError:
        e = cls()
    wire = transport.error_to_name(e)
    assert wire == name == jax_transport.error_to_name(e)
    # Either side re-raises the wire name as its own class of that name.
    assert type(transport.name_to_error(wire, "m")) is cls
    assert type(jax_transport.name_to_error(wire, "m")).__name__ == name
    assert issubclass(type(jax_transport.name_to_error(wire, "m")), jax_errors.StorageError) == \
        issubclass(cls, errors.StorageError)


def test_unknown_error_name_is_a_storage_error():
    e = transport.name_to_error("NoSuchThing", "boom")
    assert type(e) is errors.StorageError and "NoSuchThing" in str(e)
    assert str(e) == str(jax_transport.name_to_error("NoSuchThing", "boom"))


def _outcomes(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    fail_p = rng.uniform(0.0, 0.6, n // 16 + 1)
    return [None if rng.random() < fail_p[i // 16] else float(rng.uniform(0.001, 2.0)) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dynamic_timeout_equals_jax(seed):
    port_dt = transport.DynamicTimeout(30.0, minimum=1.0)
    jax_dt = jax_transport.DynamicTimeout(30.0, minimum=1.0)
    seen = []
    for d in _outcomes(seed, 400):
        for dt in (port_dt, jax_dt):
            dt.log_failure() if d is None else dt.log_success(d)
        assert port_dt.timeout() == jax_dt.timeout()
        seen.append(port_dt.timeout())
    assert len(set(seen)) > 1  # the sequence moved the timeout


def test_jitter_bounds():
    for seconds, frac in ((3.0, 0.10), (1.0, 0.5), (10.0, 0.0)):
        xs = [transport.jitter(seconds, frac) for _ in range(2000)]
        assert min(xs) >= seconds * (1 - frac) and max(xs) <= seconds * (1 + frac)
        if frac:
            assert max(xs) - min(xs) > seconds * frac  # it spreads


# -- storage REST in both directions ---------------------------------------------------------


def _fi(t, name: str, data_dir: str = "", inline: bytes = b"", version_id: str = "", size: int = 0,
        deleted: bool = False):
    """A FileInfo of the package whose storage types module is `t`."""
    return t.FileInfo(
        volume="vol", name=name, version_id=version_id, data_dir=data_dir, mod_time=1_700_000_000.25,
        size=size, metadata={"etag": "abc", "content-type": "application/octet-stream"},
        parts=[t.ObjectPartInfo(number=1, size=size, actual_size=size, mod_time=1_700_000_000.25)] if size else [],
        erasure=t.ErasureInfo(data_blocks=2, parity_blocks=2, block_size=1 << 20, index=1,
                              distribution=[1, 2, 3, 4]),
        inline_data=inline, deleted=deleted,
    )


def _norm(v):
    """A comparable form of one call's result."""
    if v is None or isinstance(v, (bytes, int, str, bool)):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    name = type(v).__name__
    if name == "FileInfo":
        return ("FileInfo", v.to_dict(with_inline=True))
    if name == "VolInfo":
        return ("VolInfo", v.name, v.created > 0)
    if name == "DiskInfo":
        d = v.to_dict()
        return ("DiskInfo", d["disk_id"], d["total"] > 0, d["fs_type"], d["healing"], d["error"])
    if name == "XLMeta":
        return ("XLMeta", v.to_bytes())
    raise AssertionError(f"no normal form for {name}")


def _script(d, pkg) -> dict:
    """Every StorageAPI method, with its error cases; {step: result or
    ("raises", exception class name)}."""
    rng = np.random.default_rng(7)
    blob = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    out: dict = {}

    def step(name, fn):
        try:
            out[name] = _norm(fn())
        except Exception as e:  # noqa: BLE001 - the exception type is the result
            out[name] = ("raises", type(e).__name__)

    step("disk_id", d.disk_id)
    step("disk_info", d.disk_info)
    step("is_online", d.is_online)
    step("make_vol", lambda: d.make_vol("vol"))
    step("make_vol-exists", lambda: d.make_vol("vol"))
    step("stat_vol", lambda: d.stat_vol("vol"))
    step("stat_vol-missing", lambda: d.stat_vol("nope"))
    step("list_vols", lambda: sorted(v.name for v in d.list_vols() if not v.name.startswith(".")))
    step("write_all", lambda: d.write_all("vol", "cfg/a.json", b'{"a": 1}'))
    step("read_all", lambda: d.read_all("vol", "cfg/a.json"))
    step("read_all-missing", lambda: d.read_all("vol", "cfg/missing"))
    step("create_file", lambda: d.create_file("vol", "stage/s1/part.1", blob[:100_000]))
    step("append_file", lambda: d.append_file("vol", "stage/s1/part.1", blob[100_000:200_000]))
    step("append_iov", lambda: d.append_iov("vol", "stage/s1/part.1", [blob[200_000:250_000], blob[250_000:]]))
    step("stat_file", lambda: d.stat_file("vol", "stage/s1/part.1"))
    step("stat_file-missing", lambda: d.stat_file("vol", "stage/s1/part.9"))
    step("read_file", lambda: d.read_file("vol", "stage/s1/part.1", 12_345, 70_000))
    step("read_file-tail", lambda: d.read_file("vol", "stage/s1/part.1", 299_990))
    step("read_file-missing", lambda: d.read_file("vol", "nope/part.1"))

    def read_into():
        buf = bytearray(5000)
        n = d.read_file_into("vol", "stage/s1/part.1", 298_000, memoryview(buf))
        return [n, bytes(buf)]

    step("read_file_into", read_into)
    step("rename_data", lambda: d.rename_data("vol", "stage/s1", _fi(pkg, "obj", data_dir="dd-1", size=300_000),
                                              "vol", "obj"))
    step("rename_data-missing", lambda: d.rename_data("vol", "stage/s9", _fi(pkg, "obj9", data_dir="dd-9"),
                                                      "vol", "obj9"))
    step("read_moved_part", lambda: d.read_file("vol", "obj/dd-1/part.1"))
    step("write_metadata", lambda: d.write_metadata("vol", "small", _fi(pkg, "small", inline=blob[:3000],
                                                                        size=3000)))
    step("write_metadata-v2", lambda: d.write_metadata("vol", "small", _fi(pkg, "small", inline=blob[:10],
                                                                           version_id="v2", size=10)))
    step("read_version", lambda: d.read_version("vol", "small"))
    step("read_version-v2", lambda: d.read_version("vol", "small", "v2"))
    step("read_version-missing", lambda: d.read_version("vol", "small", "v9"))
    step("read_version-obj", lambda: d.read_version("vol", "obj"))
    step("read_xl", lambda: d.read_xl("vol", "small"))
    step("read_xl-missing", lambda: d.read_xl("vol", "nope"))

    def update():
        fi = _fi(pkg, "small", inline=blob[:10], version_id="v2", size=10)
        fi.metadata["x-amz-meta-k"] = "v"
        d.update_metadata("vol", "small", fi)
        return d.read_version("vol", "small", "v2")

    step("update_metadata", update)
    step("verify_file", lambda: d.verify_file("vol", "obj", _fi(pkg, "obj", data_dir="dd-1", size=300_000)))
    step("delete_version", lambda: d.delete_version("vol", "small", _fi(pkg, "small", version_id="v2")))
    step("read_version-after-delete", lambda: d.read_version("vol", "small", "v2"))
    step("delete_version-marker", lambda: d.delete_version("vol", "small", _fi(pkg, "small", version_id="dm",
                                                                                 deleted=True)))
    step("read_version-marker", lambda: d.read_version("vol", "small"))
    step("rename_file", lambda: d.rename_file("vol", "cfg/a.json", "vol", "cfg/b.json"))
    step("read_all-renamed", lambda: d.read_all("vol", "cfg/b.json"))
    step("list_dir", lambda: sorted(d.list_dir("vol", "")))
    step("list_dir-sub", lambda: sorted(d.list_dir("vol", "cfg")))
    step("walk_dir", lambda: list(d.walk_dir("vol")))
    step("walk_dir-base", lambda: list(d.walk_dir("vol", "obj")))
    step("walk_dir-missing", lambda: list(d.walk_dir("nope")))
    step("delete", lambda: d.delete("vol", "cfg/b.json"))
    step("delete-missing", lambda: d.delete("vol", "cfg/b.json"))
    step("delete-recursive", lambda: d.delete("vol", "obj", recursive=True))
    step("delete_vol-not-empty", lambda: d.delete_vol("vol"))
    step("delete_vol-force", lambda: d.delete_vol("vol", force=True))
    step("stat_vol-deleted", lambda: d.stat_vol("vol"))
    return out


# One drive identity for the served directories and their references.
FORMAT = port_format.init_format(1, 4)[0]


def _formatted(root: str) -> str:
    os.makedirs(root)
    FORMAT.save(root)
    return root


def _serve(run_app_until, storage_app):
    """Serve a storage app under its prefix, as a node mounts it."""
    from aiohttp import web

    app = web.Application(client_max_size=1 << 31)
    app.add_subapp(storage_rest.PREFIX, storage_app)
    stop = threading.Event()
    port = _free_port()
    thread, errs = run_app_until(app, "127.0.0.1", port, stop)
    assert not errs, errs
    return f"http://127.0.0.1:{port}", stop, thread


@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    """Both directions' scripts, each beside its LocalDrive reference."""
    root = str(tmp_path_factory.mktemp("rest"))
    token = transport.cluster_token(SECRET)
    out = {}
    served = []
    try:
        # Port client -> JAX server.
        jax_dir = _formatted(os.path.join(root, "jax-served"))
        url, stop, thread = _serve(jax_cli._run_app_until,
                                   jax_rest.make_storage_app({jax_dir: JaxLocalDrive(jax_dir)}, token))
        served.append((stop, thread))
        out["port->jax"] = (
            _script(storage_rest.RemoteDrive(url, jax_dir, token), port_types),
            _script(LocalDrive(_formatted(os.path.join(root, "port-ref"))), port_types),
        )
        # JAX client -> port server.
        port_dir = _formatted(os.path.join(root, "port-served"))
        url, stop, thread = _serve(cli._run_app_until,
                                   storage_rest.make_storage_app({port_dir: LocalDrive(port_dir)}, token))
        served.append((stop, thread))
        out["jax->port"] = (
            _script(jax_rest.RemoteDrive(url, port_dir, token), jax_types),
            _script(JaxLocalDrive(_formatted(os.path.join(root, "jax-ref"))), jax_types),
        )
        # A wrong token is refused by both servers.
        out["bad-token"] = [
            ("raises", type(_raises(lambda: storage_rest.RemoteDrive(url, port_dir, "x").disk_info())).__name__),
        ]
        yield out
    finally:
        for stop, thread in served:
            stop.set()
            thread.join(10)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return e
    raise AssertionError("no exception")


STEPS = [
    "disk_id", "disk_info", "is_online", "make_vol", "make_vol-exists", "stat_vol", "stat_vol-missing", "list_vols",
    "write_all", "read_all", "read_all-missing", "create_file", "append_file", "append_iov", "stat_file",
    "stat_file-missing", "read_file", "read_file-tail", "read_file-missing", "read_file_into", "rename_data",
    "rename_data-missing", "read_moved_part", "write_metadata", "write_metadata-v2", "read_version",
    "read_version-v2", "read_version-missing", "read_version-obj", "read_xl", "read_xl-missing",
    "update_metadata", "verify_file", "delete_version", "read_version-after-delete", "delete_version-marker",
    "read_version-marker", "rename_file", "read_all-renamed", "list_dir", "list_dir-sub", "walk_dir",
    "walk_dir-base", "walk_dir-missing", "delete", "delete-missing", "delete-recursive", "delete_vol-not-empty",
    "delete_vol-force", "stat_vol-deleted",
]


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("step", STEPS)
def test_remote_drive_equals_local_drive(rest, direction, step):
    remote, local = rest[direction]
    assert set(remote) == set(local) == set(STEPS)
    if (direction, step) == ("jax->port", "read_xl"):
        # The JAX client msgpack-decodes the raw xl.meta bytes the server
        # answers (its RemoteDrive.read_xl); the port's client reads them raw.
        assert remote[step] == ("raises", "ExtraData")
        assert rest["port->jax"][0][step] == local[step]
        return
    assert remote[step] == local[step], (direction, step)


def test_both_directions_give_the_same_answers(rest):
    port_remote, _ = rest["port->jax"]
    jax_remote, _ = rest["jax->port"]
    assert {k: v for k, v in port_remote.items() if k != "read_xl"} == \
        {k: v for k, v in jax_remote.items() if k != "read_xl"}


def test_remote_walk_is_streamed(rest):
    remote, _ = rest["port->jax"]
    assert remote["walk_dir"] and all(isinstance(e, list) and len(e) == 2 for e in remote["walk_dir"])
    assert remote["walk_dir-missing"] == ("raises", "VolumeNotFound")
    src = inspect.getsource(storage_rest.RemoteDrive.walk_dir)
    assert "/walkdirstream" in src and "stream=True" in src


def test_wrong_token_is_refused(rest):
    assert rest["bad-token"] == [("raises", "StorageError")]
