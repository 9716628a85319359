"""Erasure sets, server pools and the metacache of minio_tpu_torch on the
CPU, held against the JAX package's.

Both packages get the same deployment: the same format.json on every drive
(2 sets of 4 drives a pool, so the same deployment id and the same set
arrangement), the same calls and the same numpy-seeded objects. The port
runs its BatchingDeviceCodec on device="cpu" (the kernels' plain torch
versions), the JAX package its HostCodec. Tolerance: exact. Set choices,
part files, inline data and the erasure fields of xl.meta are an on-disk
format, and listings are what S3 clients page through. Version ids and mod
times are random in each package, so they are compared by position, not by
value. The cases mirror tests/test_sets_pools.py and tests/test_pools.py,
including a multi-pool delimiter listing in which both packages drop a key.
"""

from __future__ import annotations

import os
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu_torch
from minio_tpu.object import metacache as jax_metacache
from minio_tpu.object import pools as jax_pools
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import DeleteObjectOptions as JaxDeleteObjectOptions
from minio_tpu.object.types import PutObjectOptions as JaxPutObjectOptions
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.local import LocalDrive as JaxLocalDrive
from minio_tpu_torch.object import metacache as port_metacache
from minio_tpu_torch.object import pools as port_pools
from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.local import LocalDrive

SETS, SET_DRIVES = 2, 4
RRS_PARITY = 1  # below the 4-drive sets' default EC:2, so RRS has its own geometry
BUCKET = "bkt"
MiB = 1 << 20

JAX = SimpleNamespace(
    name="jax", ErasureSets=JaxErasureSets, ServerPools=jax_pools.ServerPools, pools=jax_pools,
    LocalDrive=JaxLocalDrive, DriveFormat=jax_format.DriveFormat, Put=JaxPutObjectOptions,
    Delete=JaxDeleteObjectOptions, metacache=jax_metacache,
)
PORT = SimpleNamespace(
    name="port", ErasureSets=minio_tpu_torch.ErasureSets, ServerPools=minio_tpu_torch.ServerPools,
    pools=port_pools, LocalDrive=LocalDrive, DriveFormat=port_format.DriveFormat, Put=PutObjectOptions,
    Delete=DeleteObjectOptions, metacache=port_metacache,
)
PKGS = (JAX, PORT)

# One object of each size class: tiny and inline (data in xl.meta), one
# short block, a full block plus a tail, and a reduced-redundancy one.
SIZE_OBJECTS = {
    "size/tiny": (37, ""),
    "size/inline": (20 << 10, ""),
    "size/small": (200 << 10, ""),
    "size/multi-block": (MiB + 37, ""),
    "size/rrs": (300 << 10, "REDUCED_REDUNDANCY"),
}


def _listing_names() -> list[str]:
    names = [f"tenant-{t:02d}/2024-01-{d:02d}/obj-{n:05d}" for t in range(3) for d in range(1, 4) for n in range(3)]
    return names + ["a.txt", "b/one", "b/two", "c.txt", "d/e/deep", "logs/2024/a", "logs/2025/c"]


def _save_formats(root: str, formats) -> list[str]:
    dirs = []
    for i, f in enumerate(formats):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        dirs.append(d)
    return dirs


def _pool(pkg, dirs: list[str], pool_index: int, codec):
    drives = [pkg.LocalDrive(d) for d in dirs]
    fmt = pkg.DriveFormat.load(dirs[0])
    return pkg.ErasureSets.from_drives(drives, fmt, codec=codec, pool_index=pool_index, rrs_parity=RRS_PARITY)


class Deployment:
    """The same pools in both packages: formats made once and saved to the
    drive directories of each. Pool 1 is attached by attach()."""

    def __init__(self, root, codec, n_pools: int = 2):
        formats = [jax_format.init_format(SETS, SET_DRIVES) for _ in range(n_pools)]
        self.dirs = {
            pkg.name: [_save_formats(os.path.join(root, pkg.name, f"pool{p}"), formats[p]) for p in range(n_pools)]
            for pkg in PKGS
        }
        self.codecs = {"jax": JaxHostCodec(), "port": codec}
        self.layers = {
            pkg.name: pkg.ServerPools([_pool(pkg, self.dirs[pkg.name][0], 0, self.codecs[pkg.name])])
            for pkg in PKGS
        }

    def both(self, fn) -> dict:
        """fn(pkg, layer) in each package; exceptions are returned by class
        name, so that a test compares them too."""
        out = {}
        for pkg in PKGS:
            try:
                out[pkg.name] = fn(pkg, self.layers[pkg.name])
            except Exception as e:  # noqa: BLE001 - the class name is compared
                out[pkg.name] = f"raised {type(e).__name__}"
        return out

    def do(self, fn) -> dict:
        """fn(pkg, layer) in each package, which must not raise in either."""
        out = self.both(fn)
        for name, res in out.items():
            assert not (isinstance(res, str) and res.startswith("raised ")), (name, res)
        return out

    def attach(self, drain_pool0: bool = True) -> None:
        """Attach pool 1 as pool expansion does (SUSPENDED, then ACTIVE);
        optionally set pool 0 DRAINING, so every new object lands in pool 1."""
        for pkg in PKGS:
            layer = self.layers[pkg.name]
            idx = layer.add_pool(_pool(pkg, self.dirs[pkg.name][1], 1, self.codecs[pkg.name]))
            assert layer.statuses[idx] == pkg.pools.POOL_SUSPENDED
            layer.pools[idx].make_bucket(BUCKET)
            layer.set_pool_status(idx, pkg.pools.POOL_ACTIVE)
            if drain_pool0:
                layer.set_pool_status(0, pkg.pools.POOL_DRAINING)


def _same(results: dict, raises: str = ""):
    """The one result both packages gave: an exception of class `raises`
    when one is named, else a value (neither package may have raised)."""
    assert results["port"] == results["jax"]
    got = results["port"]
    if raises:
        assert got == f"raised {raises}"
    else:
        assert not (isinstance(got, str) and got.startswith("raised ")), got
    return got


def _obj(o) -> tuple:
    return (o.name, o.size, o.etag, o.is_latest, o.delete_marker, o.storage_class, o.content_type)


def _list(res) -> tuple:
    return ([_obj(o) for o in res.objects], list(res.prefixes), res.is_truncated, res.next_marker)


def _versions(res) -> tuple:
    return ([_obj(o) for o in res.objects], list(res.prefixes), res.is_truncated, res.next_key_marker)


def _put(pkg, layer, name, data, storage_class="", versioned=False):
    return layer.put_object(BUCKET, name, data, pkg.Put(storage_class=storage_class, versioned=versioned))


@pytest.fixture(scope="module")
def codec():
    c = BatchingDeviceCodec(device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory, codec):
    """One pool in each package holding the size-class objects, the listing
    names and three versioned keys (3 versions each, one delete marker)."""
    dep = Deployment(str(tmp_path_factory.mktemp("sets")), codec, n_pools=1)
    dep.do(lambda pkg, layer: layer.make_bucket(BUCKET))
    rng = np.random.default_rng(2024)
    payloads = {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for name, (n, _) in SIZE_OBJECTS.items()}
    for name in _listing_names():
        payloads[name] = rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
    for name, data in payloads.items():
        sc = SIZE_OBJECTS.get(name, (0, ""))[1]
        dep.do(lambda pkg, layer: _put(pkg, layer, name, data, sc))
    for v in range(3):
        for i in range(3):
            dep.do(lambda pkg, layer: _put(pkg, layer, f"ver/obj-{i}", f"v{v}-{i}".encode(), versioned=True))
    dep.do(lambda pkg, layer: layer.delete_object(BUCKET, "ver/obj-1", pkg.Delete(versioned=True)))
    return dep, payloads


def _object_dir(layer, name: str) -> tuple[int, list]:
    sets = layer.pools[0]
    s = sets.get_set_index(name)
    return s, sets.sets[s].disks


def _part_or_inline(drive, name: str) -> bytes:
    fi = drive.read_version(BUCKET, name)
    if fi.inline_data:
        return b"inline:" + fi.inline_data
    obj = os.path.join(drive.root, BUCKET, name, fi.data_dir)
    with open(os.path.join(obj, "part.1"), "rb") as f:
        return f.read()


def _erasure_fields(fi) -> tuple:
    e = fi.erasure
    return (
        e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
        [dict(c) for c in e.checksums], [(p.number, p.size, p.actual_size, p.etag) for p in fi.parts],
        fi.size, bool(fi.data_dir), fi.metadata.get("etag"), fi.metadata.get("x-internal-storage-class"),
    )


# -- routing -----------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["SIPMOD+PARITY", "CRCMOD"])
@pytest.mark.parametrize("n_sets", [2, 3, 16])
def test_set_choice_matches(algo, n_sets):
    dep_id = "a0d3c9a1-3f8e-4b61-9f5e-2a7c11d4e5f6"
    names = [f"tenant-{i % 16:02d}/2024-01-{i % 8 + 1:02d}/obj-{i:05d}" for i in range(256)]
    picks = {
        pkg.name: [
            pkg.ErasureSets([None] * (n_sets * 4), 4, deployment_id=dep_id, distribution_algo=algo).get_set_index(n)
            for n in names
        ]
        for pkg in PKGS
    }
    assert picks["port"] == picks["jax"]
    assert set(picks["port"]) == set(range(n_sets))


def test_from_drives_restores_format_positions(tmp_path):
    formats = jax_format.init_format(SETS, SET_DRIVES)
    dirs = _save_formats(str(tmp_path), formats)
    arranged = {}
    for pkg in PKGS:
        drives = [pkg.LocalDrive(d) for d in reversed(dirs)]
        sets = pkg.ErasureSets.from_drives(drives, pkg.DriveFormat.load(dirs[0]))
        arranged[pkg.name] = [[d.disk_id() for d in s.disks] for s in sets.sets]
    assert arranged["port"] == arranged["jax"] == formats[0].sets


# -- bytes on disk --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SIZE_OBJECTS))
def test_placement_on_the_hashed_set(stacks, name):
    dep, _ = stacks
    sets_by_pkg = {}
    for pkg in PKGS:
        layer = dep.layers[pkg.name]
        s, _ = _object_dir(layer, name)
        holders = [
            (si, di)
            for si, es in enumerate(layer.pools[0].sets)
            for di, d in enumerate(es.disks)
            if os.path.exists(os.path.join(d.root, BUCKET, name, "xl.meta"))
        ]
        assert holders == [(s, di) for di in range(SET_DRIVES)]
        sets_by_pkg[pkg.name] = s
    assert sets_by_pkg["port"] == sets_by_pkg["jax"]


@pytest.mark.parametrize("name", sorted(SIZE_OBJECTS))
def test_part_files_and_inline_data_equal(stacks, name):
    dep, _ = stacks
    got = {pkg.name: [_part_or_inline(d, name) for d in _object_dir(dep.layers[pkg.name], name)[1]] for pkg in PKGS}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("name", sorted(SIZE_OBJECTS))
def test_xl_meta_erasure_fields_equal(stacks, name):
    dep, _ = stacks
    got = {
        pkg.name: [_erasure_fields(d.read_version(BUCKET, name)) for d in _object_dir(dep.layers[pkg.name], name)[1]]
        for pkg in PKGS
    }
    assert got["port"] == got["jax"]
    k = got["port"][0][0]
    assert k == (SET_DRIVES - RRS_PARITY if name == "size/rrs" else SET_DRIVES - 2)


@pytest.mark.parametrize("name", ["size/tiny", "size/inline", "size/small", "size/rrs"])
def test_get_through_the_sets(stacks, name):
    dep, payloads = stacks
    assert _same(dep.both(lambda pkg, layer: layer.get_object(BUCKET, name)[1])) == payloads[name]


# -- listing, one pool ----------------------------------------------------------------

LIST_CASES = {
    "all": {},
    "max-keys-0": {"max_keys": 0},
    "max-keys-1": {"max_keys": 1},
    "max-keys-1000": {"max_keys": 1000},
    "prefix": {"prefix": "tenant-01/"},
    "prefix-delimiter": {"prefix": "tenant-01/", "delimiter": "/"},
    "delimiter": {"delimiter": "/"},
    "delimiter-max-keys-3": {"delimiter": "/", "max_keys": 3},
    "marker": {"marker": "tenant-01/2024-01-02/obj-00001"},
    "marker-delimiter": {"marker": "b/two", "delimiter": "/"},
    "common-prefix-marker": {"marker": "tenant-00/", "delimiter": "/"},
    "prefix-marker-max-keys-1": {"prefix": "tenant-02/", "marker": "tenant-02/2024-01-01/obj-00002", "max_keys": 1},
    "missing-prefix": {"prefix": "nope/"},
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_list_objects_page_equal(stacks, case):
    dep, _ = stacks
    _same(dep.both(lambda pkg, layer: _list(layer.list_objects(BUCKET, **LIST_CASES[case]))))


@pytest.mark.parametrize("delimiter", ["", "/"])
def test_list_objects_pages_through_every_key(stacks, delimiter):
    dep, payloads = stacks

    def pages(pkg, layer):
        out, marker = [], ""
        while True:
            res = layer.list_objects(BUCKET, marker=marker, delimiter=delimiter, max_keys=5)
            out.append(_list(res))
            if not res.is_truncated:
                return out
            marker = res.next_marker

    got = _same(dep.both(pages))
    names = [o[0] for page in got for o in page[0]]
    prefixes = [p for page in got for p in page[1]]
    live = sorted(payloads) + ["ver/obj-0", "ver/obj-2"]
    if delimiter:
        assert names == sorted(n for n in live if "/" not in n)
        assert prefixes == sorted({n.split("/")[0] + "/" for n in live if "/" in n})
    else:
        assert names == sorted(live) and prefixes == []


def test_list_object_versions_pages_with_key_and_version_markers(stacks):
    dep, _ = stacks

    def pages(pkg, layer):
        out, km, vm = [], "", ""
        while True:
            res = layer.list_object_versions(BUCKET, prefix="ver/", key_marker=km, version_marker=vm, max_keys=2)
            # The version ids are each package's own: the next page's markers
            # point at the last entry returned.
            assert (res.next_key_marker, res.next_version_marker) == (
                (res.objects[-1].name, res.objects[-1].version_id) if res.is_truncated else ("", "")
            )
            out.append(_versions(res))
            if not res.is_truncated:
                return out
            km, vm = res.next_key_marker, res.next_version_marker

    got = _same(dep.both(pages))
    entries = [o for page in got for o in page[0]]
    assert len(entries) == 10  # 3 keys x 3 versions + 1 delete marker
    assert [(o[0], o[3], o[4]) for o in entries if o[3]] == [
        ("ver/obj-0", True, False), ("ver/obj-1", True, True), ("ver/obj-2", True, False),
    ]


def test_list_object_versions_with_delimiter(stacks):
    dep, _ = stacks
    _same(dep.both(lambda pkg, layer: _versions(layer.list_object_versions(BUCKET, delimiter="/", max_keys=1000))))


def test_metacache_pages_without_rewalking(stacks):
    dep, _ = stacks

    def walks(pkg, layer):
        sets = layer.pools[0]
        sets.metacache.invalidate(BUCKET)
        w, h = sets.metacache.walks, sets.metacache.hits
        first = layer.list_objects(BUCKET, prefix="tenant-", max_keys=4)
        second = layer.list_objects(BUCKET, prefix="tenant-", marker=first.next_marker, max_keys=4)
        return _list(second), sets.metacache.walks - w, sets.metacache.hits - h

    _, walked, hit = _same(dep.both(walks))
    assert (walked, hit) == (1, 1)


def test_missing_bucket_listing(stacks):
    dep, _ = stacks
    _same(dep.both(lambda pkg, layer: layer.list_objects("nope")), raises="BucketNotFound")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metacache_image_read_by_the_other_package(tmp_path, codec, writer):
    """One package fills and persists a listing image; a fresh sets layer of
    the other package over the same drives serves the listing from it
    without a walk."""
    formats = jax_format.init_format(SETS, SET_DRIVES)
    dirs = _save_formats(str(tmp_path), formats)
    w, r = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    codecs = {"jax": JaxHostCodec(), "port": codec}
    sets = _pool(w, dirs, 0, codecs[w.name])
    sets.make_bucket(BUCKET)
    names = [f"mc/obj-{i:03d}" for i in range(12)]
    for n in names:
        sets.put_object(BUCKET, n, n.encode())
    want = _list(sets.list_objects(BUCKET, prefix="mc/"))
    assert JAX.metacache.cache_path(BUCKET, "mc/") == PORT.metacache.cache_path(BUCKET, "mc/")
    assert any(
        os.path.exists(os.path.join(d, PORT.metacache.META_BUCKET, PORT.metacache.cache_path(BUCKET, "mc/")))
        for d in dirs
    )
    reader = _pool(r, dirs, 0, codecs[r.name])
    got = reader.list_objects(BUCKET, prefix="mc/")
    assert [o.name for o in got.objects] == names
    assert (reader.metacache.walks, reader.metacache.hits) == (0, 1)
    # Only mod times differ: the image holds the writer's xl.meta.
    assert _list(got)[1:] == want[1:] and [o[:3] for o in _list(got)[0]] == [o[:3] for o in want[0]]


# -- writes through the pools --------------------------------------------------------


@pytest.fixture
def fresh(tmp_path, codec):
    dep = Deployment(str(tmp_path), codec)
    dep.do(lambda pkg, layer: layer.make_bucket(BUCKET))
    return dep


def test_delete_objects(fresh):
    for i in range(8):
        fresh.do(lambda pkg, layer: _put(pkg, layer, f"o{i}", b"x" * (i + 1)))
    victims = [(f"o{i}", "") for i in range(0, 8, 2)] + [("missing", "")]

    def bulk(pkg, layer):
        res = layer.delete_objects(BUCKET, victims)
        return [type(e).__name__ if e else None for _, e in res], _list(layer.list_objects(BUCKET))

    errs, listing = _same(fresh.both(bulk))
    assert errs == [None] * 4 + ["ObjectNotFound"]
    assert [o[0] for o in listing[0]] == ["o1", "o3", "o5", "o7"]


def test_delete_objects_past_the_pool_width(fresh):
    """A bulk delete of more keys than the drive-IO pool has workers (64):
    each key's drive fan-out runs nested in a pool task. The JAX package's
    copy of parallel_map deadlocks here (every worker waits on tasks queued
    behind the others), so only the port runs it; it must finish."""
    layer = fresh.layers["port"]
    names = [f"bulk/{i:03d}" for i in range(80)]
    for n in names:
        _put(PORT, layer, n, n.encode())
    done: dict = {}
    t = threading.Thread(target=lambda: done.update(res=layer.delete_objects(BUCKET, [(n, "") for n in names])),
                         daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "delete_objects did not finish"
    assert [e for _, e in done["res"]] == [None] * len(names)
    assert layer.list_objects(BUCKET, prefix="bulk/").objects == []


def test_heal_bucket_recreates_a_lost_volume(fresh):
    fresh.attach(drain_pool0=False)

    def heal(pkg, layer):
        lost = [layer.pools[0].sets[1].disks[2].root, layer.pools[1].sets[0].disks[0].root]
        for root in lost:
            shutil.rmtree(os.path.join(root, BUCKET))
        before = [os.path.isdir(os.path.join(root, BUCKET)) for root in lost]
        layer.heal_bucket(BUCKET)
        return before, [os.path.isdir(os.path.join(root, BUCKET)) for root in lost]

    assert _same(fresh.both(heal)) == ([False, False], [True, True])


def test_delete_bucket_refuses_nonempty_across_pools(fresh):
    fresh.attach()
    fresh.do(lambda pkg, layer: _put(pkg, layer, "in-pool-1", b"x"))
    _same(fresh.both(lambda pkg, layer: layer.delete_bucket(BUCKET)), raises="BucketNotEmpty")
    fresh.do(lambda pkg, layer: layer.delete_object(BUCKET, "in-pool-1"))
    fresh.do(lambda pkg, layer: layer.delete_bucket(BUCKET))
    assert _same(fresh.both(lambda pkg, layer: layer.bucket_exists(BUCKET))) is False


def test_multipart_through_the_pools(fresh):
    fresh.attach()
    part = np.random.default_rng(9).integers(0, 256, 300 << 10, dtype=np.uint8).tobytes()

    def upload(pkg, layer):
        uid = layer.new_multipart_upload(BUCKET, "mp/object")
        aborted = layer.new_multipart_upload(BUCKET, "mp/aborted")
        info = layer.put_object_part(BUCKET, "mp/object", uid, 1, part)
        listed = [(u["object"], u["upload_id"] in (uid, aborted)) for u in layer.list_multipart_uploads(BUCKET)]
        parts = [(p.number, p.size, p.etag) for p in layer.list_parts(BUCKET, "mp/object", uid)]
        layer.abort_multipart_upload(BUCKET, "mp/aborted", aborted)
        oi = layer.complete_multipart_upload(BUCKET, "mp/object", uid, [(1, info.etag)])
        holder = layer._pool_holding_index(BUCKET, "mp/object")
        _, drives = _object_dir_in(layer.pools[holder], "mp/object")
        files = [_part_or_inline(d, "mp/object") for d in drives]
        return listed, parts, (oi.size, oi.etag), holder, files, layer.list_multipart_uploads(BUCKET)

    listed, parts, (size, etag), holder, _, left = _same(fresh.both(upload))
    assert listed == [("mp/aborted", True), ("mp/object", True)]
    assert parts[0][:2] == (1, len(part)) and size == len(part) and etag.endswith("-1")
    assert holder == 1 and left == []
    assert _same(fresh.both(lambda pkg, layer: layer.get_object(BUCKET, "mp/object")[1])) == part


def _object_dir_in(sets, name: str):
    s = sets.get_set_index(name)
    return s, sets.sets[s].disks


def test_draining_pool_overwrite_places_fresh(fresh):
    fresh.do(lambda pkg, layer: _put(pkg, layer, "mig", b"old"))
    fresh.attach()

    def overwrite(pkg, layer):
        layer.put_object(BUCKET, "mig", b"new")
        return (
            layer._pool_holding_index(BUCKET, "mig"),
            layer.get_object(BUCKET, "mig")[1],
            layer.pools[0].get_object(BUCKET, "mig")[1],
            layer.pools[1].get_object(BUCKET, "mig")[1],
        )

    assert _same(fresh.both(overwrite)) == (1, b"new", b"old", b"new")


def test_overwrite_follows_an_active_holding_pool(fresh):
    fresh.attach(drain_pool0=False)

    def overwrite(pkg, layer):
        layer.pools[1].put_object(BUCKET, "sticky", b"v1")
        layer.put_object(BUCKET, "sticky", b"v2")
        return (
            layer._pool_holding_index(BUCKET, "sticky"),
            layer.pools[1].get_object(BUCKET, "sticky")[1],
            type(_raises(lambda: layer.pools[0].get_object_info(BUCKET, "sticky"))).__name__,
        )

    assert _same(fresh.both(overwrite)) == (1, b"v2", "ObjectNotFound")


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned for comparison
        return e
    return None


def test_no_active_pool_is_disk_full(fresh):
    fresh.attach()

    def full(pkg, layer):
        layer.set_pool_status(1, pkg.pools.POOL_DRAINING)
        return layer.put_object(BUCKET, "nowhere", b"x")

    _same(fresh.both(full), raises="DiskFull")


def test_decommissioned_pool_is_skipped(fresh):
    fresh.attach()
    fresh.do(lambda pkg, layer: _put(pkg, layer, "kept", b"kept"))

    def skip(pkg, layer):
        layer.set_pool_status(0, pkg.pools.POOL_DECOMMISSIONED)
        return (
            [i for i, _ in layer._probe_pools()],
            layer.get_object(BUCKET, "kept")[1],
            type(_raises(lambda: layer.get_object(BUCKET, "no-such-key"))).__name__,
        )

    assert _same(fresh.both(skip)) == ([1], b"kept", "ObjectNotFound")


def test_delete_sweeps_every_pool(fresh):
    fresh.attach(drain_pool0=False)

    def sweep(pkg, layer):
        layer.pools[0].put_object(BUCKET, "both", b"copy0")
        layer.pools[1].put_object(BUCKET, "both", b"copy1")
        layer.delete_object(BUCKET, "both")
        return type(_raises(lambda: layer.get_object(BUCKET, "both"))).__name__, _list(layer.list_objects(BUCKET))

    assert _same(fresh.both(sweep)) == ("ObjectNotFound", ([], [], False, ""))


def test_versioned_delete_marker_lands_in_the_holding_pool(fresh):
    fresh.do(lambda pkg, layer: _put(pkg, layer, "vkey", b"v1", versioned=True))
    fresh.attach(drain_pool0=False)

    def marker(pkg, layer):
        oi = layer.delete_object(BUCKET, "vkey", pkg.Delete(versioned=True))
        versions = layer.pools[0].list_object_versions(BUCKET, prefix="vkey")
        return oi.delete_marker, _versions(versions)

    dm, (entries, *_rest) = _same(fresh.both(marker))
    assert dm and [(o[0], o[4]) for o in entries] == [("vkey", True), ("vkey", False)]


# -- listing across two pools ---------------------------------------------------------------


@pytest.fixture
def two_pool_listing(fresh):
    """Pool 0 holds a b c/1 d/1 e and the tenant names; pool 1 (attached
    later, pool 0 draining) holds f and more tenant names."""
    names0 = ["a", "b", "c/1", "d/1", "e"] + [f"t/{i:03d}" for i in range(0, 30, 2)]
    names1 = ["f"] + [f"t/{i:03d}" for i in range(1, 30, 2)]
    for n in names0:
        fresh.do(lambda pkg, layer: _put(pkg, layer, n, n.encode()))
    fresh.attach()
    for n in names1:
        fresh.do(lambda pkg, layer: _put(pkg, layer, n, n.encode()))
    for pkg in PKGS:
        assert fresh.layers[pkg.name]._pool_holding_index(BUCKET, "f") == 1
    return fresh, sorted(names0 + names1)


@pytest.mark.parametrize("max_keys", [1, 4, 1000])
def test_two_pool_listing_without_delimiter_is_exact(two_pool_listing, max_keys):
    dep, names = two_pool_listing

    def pages(pkg, layer):
        out, marker = [], ""
        while True:
            res = layer.list_objects(BUCKET, marker=marker, max_keys=max_keys)
            out.append(_list(res))
            if not res.is_truncated:
                return out
            marker = res.next_marker

    got = _same(dep.both(pages))
    assert [o[0] for page in got for o in page[0]] == names


@pytest.mark.parametrize("case", ["prefix", "max-keys-0", "max-keys-1", "delimiter", "marker"])
def test_two_pool_list_objects_page_equal(two_pool_listing, case):
    dep, _ = two_pool_listing
    args = {"prefix": {"prefix": "t/0"}, "max-keys-0": {"max_keys": 0}, "max-keys-1": {"max_keys": 1},
            "delimiter": {"delimiter": "/"}, "marker": {"marker": "c/1", "max_keys": 5}}[case]
    _same(dep.both(lambda pkg, layer: _list(layer.list_objects(BUCKET, **args))))


def test_two_pool_delimiter_listing_drops_a_key_in_both_packages(two_pool_listing):
    """The reference's multi-pool V1 listing with a delimiter: each pool cuts
    its page at its own point and the merged next_marker is the newest
    object name, so pool 0's "e" falls between the pages. The port gives
    the JAX package's result, this one too."""
    dep, _ = two_pool_listing

    def pages(pkg, layer):
        first = layer.list_objects(BUCKET, delimiter="/", max_keys=4)
        second = layer.list_objects(BUCKET, delimiter="/", max_keys=4, marker=first.next_marker)
        return _list(first), _list(second)

    first, second = _same(dep.both(pages))
    assert ([o[0] for o in first[0]], first[1], first[3]) == (["a", "b", "f"], ["c/", "d/", "t/"], "f")
    seen = [o[0] for o in first[0] + second[0]]
    assert "e" not in seen


def test_two_pool_version_listing_stops_early_in_both_packages(fresh):
    """The reference's multi-pool ListObjectVersions merges one page of each
    pool and sets is_truncated only when the union holds more than
    max_keys: a pool whose page was full but truncated ends the listing
    early. The port gives the JAX package's result, this one too."""
    fresh.attach()
    for v in range(3):
        for i in range(4):
            fresh.do(lambda pkg, layer: _put(pkg, layer, f"v/obj-{i}", f"{v}".encode(), versioned=True))

    def pages(pkg, layer):
        out, km, vm = [], "", ""
        while True:
            res = layer.list_object_versions(BUCKET, prefix="v/", key_marker=km, version_marker=vm, max_keys=5)
            out.append(_versions(res))
            if not res.is_truncated:
                return out
            km, vm = res.next_key_marker, res.next_version_marker

    got = _same(fresh.both(pages))
    assert len(got) == 1 and len(got[0][0]) == 5  # 5 of the 12 versions
    full = _same(fresh.both(lambda pkg, layer: _versions(layer.pools[1].list_object_versions(BUCKET, prefix="v/"))))
    assert len(full[0]) == 12


def test_two_pool_list_object_versions_equal(two_pool_listing):
    dep, _ = two_pool_listing
    _same(dep.both(lambda pkg, layer: _versions(layer.list_object_versions(BUCKET, prefix="t/", max_keys=7))))


# -- names ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["ab", "-bad", "BAD", "a" * 64, ".start", "end."])
def test_bucket_name_validation(fresh, bad):
    _same(fresh.both(lambda pkg, layer: layer.make_bucket(bad)), raises="BucketNameInvalid")


@pytest.mark.parametrize("bad", ["", "/lead", "a/../b", "a\\b", "x" * 1025])
def test_object_name_validation(fresh, bad):
    _same(fresh.both(lambda pkg, layer: layer.put_object(BUCKET, bad, b"x")), raises="ObjectNameInvalid")
