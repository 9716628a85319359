"""Storage REST: a local drive served over HTTP + its remote StorageAPI proxy.

Role of the reference's storage-rest-server.go / storage-rest-client.go (wire
v42): every StorageAPI method gets an endpoint under /mtpu/storage/v1/;
remote drives are indistinguishable from local ones to the object layer.
Shard payloads travel as raw HTTP bodies; structured args/results are
msgpack. Per-drive identity is the drive's format disk-id, checked on every
call via header (the xl-storage-disk-id-check.go role is split between client
and server here).
"""

from __future__ import annotations

import hmac
import itertools
import urllib.parse

import msgpack
from aiohttp import web

from ..storage.interface import StorageAPI
from ..storage.local import LocalDrive
from ..storage.types import DiskInfo, FileInfo, VolInfo
from ..storage.xlmeta import XLMeta
from ..control import tracing
from ..utils import deadline, errors
from .transport import ERROR_HEADER, TOKEN_HEADER, RestClient, error_to_name, name_to_error

PREFIX = "/mtpu/storage/v1"


def _fi_pack(fi: FileInfo) -> dict:
    d = fi.to_dict(with_inline=True)
    return d


def _fi_unpack(d: dict) -> FileInfo:
    return FileInfo.from_dict(d)


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------


def make_storage_app(drives: dict[str, "StorageAPI"], token: str) -> web.Application:
    """drives: url-path -> LocalDrive (e.g. "/data/disk0" -> LocalDrive)."""
    app = web.Application(client_max_size=1 << 31)

    def get_drive(request: web.Request) -> LocalDrive:
        # Constant-time compare: the timing of an equality mismatch must not
        # leak how much of a guessed token matched (same discipline as the
        # api/ signature checks).
        if not hmac.compare_digest(request.headers.get(TOKEN_HEADER, ""), token):
            raise web.HTTPForbidden(text="bad cluster token")
        dpath = request.query.get("disk", "")
        d = drives.get(dpath)
        if d is None:
            raise errors.DiskNotFound(dpath)
        return d

    def error_resp(e: Exception) -> web.Response:
        """Typed error transport: exception class name rides a header."""
        return web.Response(
            status=500 if not isinstance(e, errors.StorageError) else 400,
            headers={ERROR_HEADER: error_to_name(e)},
            text=str(e),
        )

    def handler(fn):
        async def wrapped(request: web.Request):
            import asyncio

            try:
                drive = get_drive(request)
                body = await request.read()
                # Adopt the caller's trace context AND its deadline budget:
                # to_thread copies this coroutine's context, so drive spans
                # parent under the hop and the remaining budget keeps
                # shrinking through nested RPCs.
                with tracing.bind_header(request.headers.get(tracing.TRACE_HEADER)), \
                        deadline.bind_header(request.headers.get(deadline.DEADLINE_HEADER)):
                    result = await asyncio.to_thread(fn, drive, request, body)
                if isinstance(result, bytes):
                    return web.Response(body=result)
                return web.Response(
                    body=msgpack.packb(result, use_bin_type=True),
                    content_type="application/x-msgpack",
                )
            except web.HTTPException:
                raise
            except Exception as e:  # noqa: BLE001 - typed error transport
                return error_resp(e)

        return wrapped

    def args(request, body: bytes) -> dict:
        if request.content_type == "application/x-msgpack" and body:
            return msgpack.unpackb(body, raw=False, strict_map_key=False)
        return {k: v for k, v in request.query.items() if k != "disk"}

    # -- endpoints ----------------------------------------------------------

    def h_disk_info(d, request, body):
        return d.disk_info().to_dict()

    def h_disk_id(d, request, body):
        return {"id": d.disk_id()}

    def h_make_vol(d, request, body):
        d.make_vol(args(request, body)["volume"])

    def h_stat_vol(d, request, body):
        v = d.stat_vol(args(request, body)["volume"])
        return {"name": v.name, "created": v.created}

    def h_list_vols(d, request, body):
        return [{"name": v.name, "created": v.created} for v in d.list_vols()]

    def h_delete_vol(d, request, body):
        a = args(request, body)
        d.delete_vol(a["volume"], bool(a.get("force")))

    def h_write_all(d, request, body):
        d.write_all(request.query["volume"], request.query["path"], body)

    def h_read_all(d, request, body):
        a = args(request, body)
        return d.read_all(a["volume"], a["path"])

    def h_delete(d, request, body):
        a = args(request, body)
        d.delete(a["volume"], a["path"], bool(a.get("recursive")))

    def h_create_file(d, request, body):
        d.create_file(request.query["volume"], request.query["path"], body)

    def h_append_file(d, request, body):
        d.append_file(request.query["volume"], request.query["path"], body)

    def h_read_file(d, request, body):
        a = args(request, body)
        return d.read_file(a["volume"], a["path"], int(a.get("offset", 0)), int(a.get("length", -1)))

    def h_stat_file(d, request, body):
        a = args(request, body)
        return {"size": d.stat_file(a["volume"], a["path"])}

    def h_read_xl(d, request, body):
        a = args(request, body)
        meta = d.read_xl(a["volume"], a["path"])
        return meta.to_bytes()

    def h_read_version(d, request, body):
        a = args(request, body)
        fi = d.read_version(a["volume"], a["path"], a.get("version_id", ""))
        return _fi_pack(fi)

    def h_write_metadata(d, request, body):
        a = args(request, body)
        d.write_metadata(a["volume"], a["path"], _fi_unpack(a["fi"]))

    def h_update_metadata(d, request, body):
        a = args(request, body)
        d.update_metadata(a["volume"], a["path"], _fi_unpack(a["fi"]))

    def h_delete_version(d, request, body):
        a = args(request, body)
        fi = _fi_unpack(a["fi"])
        fi.deleted = a.get("deleted", False) or fi.deleted
        d.delete_version(a["volume"], a["path"], fi)

    def h_rename_data(d, request, body):
        a = args(request, body)
        d.rename_data(
            a["src_volume"], a["src_path"], _fi_unpack(a["fi"]), a["dst_volume"], a["dst_path"]
        )

    def h_rename_file(d, request, body):
        a = args(request, body)
        d.rename_file(a["src_volume"], a["src_path"], a["dst_volume"], a["dst_path"])

    def h_list_dir(d, request, body):
        a = args(request, body)
        return d.list_dir(a["volume"], a.get("path", ""))

    def h_walk_dir(d, request, body):
        a = args(request, body)
        out = []
        for name, raw in d.walk_dir(a["volume"], a.get("base", ""), bool(a.get("recursive", True))):
            out.append([name, raw])
        return out

    def h_verify_file(d, request, body):
        a = args(request, body)
        d.verify_file(a["volume"], a["path"], _fi_unpack(a["fi"]))

    async def h_walk_stream(request: web.Request):
        """Streaming WalkDir: msgpack-framed [name, raw] entries flow as the
        walk produces them (the reference's metacache-walk.go:62 streaming
        discipline) instead of one buffered body per listing -- a 100K-entry
        remote listing stays O(batch) in memory at both ends. The FIRST
        batch is pulled before headers go out, so lazy-generator errors
        (VolumeNotFound on a missing bucket) still take the typed-error
        path rather than aborting a started chunked response."""
        import asyncio

        def next_batch(it):
            return list(itertools.islice(it, 256))

        binder = tracing.bind_header(request.headers.get(tracing.TRACE_HEADER))
        dl_binder = deadline.bind_header(request.headers.get(deadline.DEADLINE_HEADER))
        try:
            drive = get_drive(request)
            body = await request.read()
            a = args(request, body)
            with binder, dl_binder:
                it = drive.walk_dir(a["volume"], a.get("base", ""), bool(a.get("recursive", True)))
                first = await asyncio.to_thread(next_batch, it)
        except web.HTTPException:
            raise
        except Exception as e:  # noqa: BLE001 - typed error transport
            return error_resp(e)

        resp = web.StreamResponse()
        resp.content_type = "application/x-msgpack"
        await resp.prepare(request)
        batch = first
        try:
            while batch:
                await resp.write(
                    b"".join(msgpack.packb([n, r], use_bin_type=True) for n, r in batch)
                )
                if len(batch) < 256:
                    break
                with binder, dl_binder:
                    batch = await asyncio.to_thread(next_batch, it)
        except (ConnectionError, asyncio.CancelledError):
            raise  # client went away: nothing to tell it
        except Exception as e:  # noqa: BLE001
            # Headers already went out: carry the typed error IN-BAND as a
            # dict frame (list frames are entries). Silent truncation would
            # make an incomplete listing look complete; a bare connection
            # abort would read as a dead peer instead of a storage error.
            await resp.write(
                msgpack.packb(
                    {"__error__": error_to_name(e), "msg": str(e)[:200]},
                    use_bin_type=True,
                )
            )
        await resp.write_eof()
        return resp

    app.router.add_post("/walkdirstream", h_walk_stream)

    for name, fn in {
        "diskinfo": h_disk_info,
        "diskid": h_disk_id,
        "makevol": h_make_vol,
        "statvol": h_stat_vol,
        "listvols": h_list_vols,
        "deletevol": h_delete_vol,
        "writeall": h_write_all,
        "readall": h_read_all,
        "delete": h_delete,
        "createfile": h_create_file,
        "appendfile": h_append_file,
        "readfile": h_read_file,
        "statfile": h_stat_file,
        "readxl": h_read_xl,
        "readversion": h_read_version,
        "writemetadata": h_write_metadata,
        "updatemetadata": h_update_metadata,
        "deleteversion": h_delete_version,
        "renamedata": h_rename_data,
        "renamefile": h_rename_file,
        "listdir": h_list_dir,
        "walkdir": h_walk_dir,
        "verifyfile": h_verify_file,
    }.items():
        app.router.add_post(f"/{name}", handler(fn))
    return app


# ---------------------------------------------------------------------------
# Client side: StorageAPI proxy
# ---------------------------------------------------------------------------


class RemoteDrive(StorageAPI):
    """StorageAPI over the storage REST wire (storage-rest-client.go role)."""

    def __init__(self, node_url: str, drive_path: str, token: str, timeout: float = 30.0):
        self.node_url = node_url.rstrip("/")
        self.drive_path = drive_path
        self.client = RestClient(self.node_url + PREFIX, token, timeout)
        self._disk_id = ""

    def _call(self, method: str, args: dict | None = None, body: bytes | None = None, raw=False):
        if body is not None:
            a = dict(args or {})
            a["disk"] = self.drive_path
            return self.client.call(f"/{method}", a, body=body, raw_response=raw)
        url = f"/{method}?disk={urllib.parse.quote(self.drive_path, safe='')}"
        return self.client.call(url, dict(args or {}), raw_response=raw)

    # identity
    def endpoint(self) -> str:
        return f"{self.node_url}{self.drive_path}"

    def is_online(self) -> bool:
        return self.client.is_online()

    def is_local(self) -> bool:
        return False

    def disk_id(self) -> str:
        if not self._disk_id:
            try:
                self._disk_id = self._call("diskid")["id"]
            except errors.StorageError:
                return ""
        return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id

    def disk_info(self) -> DiskInfo:
        return DiskInfo.from_dict(self._call("diskinfo"))

    # volumes
    def make_vol(self, volume: str) -> None:
        self._call("makevol", {"volume": volume})

    def stat_vol(self, volume: str) -> VolInfo:
        d = self._call("statvol", {"volume": volume})
        return VolInfo(d["name"], d["created"])

    def list_vols(self) -> list[VolInfo]:
        return [VolInfo(d["name"], d["created"]) for d in self._call("listvols")]

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._call("deletevol", {"volume": volume, "force": force})

    # small files
    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._call("writeall", {"volume": volume, "path": path}, body=data)

    def read_all(self, volume: str, path: str) -> bytes:
        return self._call("readall", {"volume": volume, "path": path}, raw=True)

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        self._call("delete", {"volume": volume, "path": path, "recursive": recursive})

    # shard files
    def create_file(self, volume: str, path: str, data: bytes) -> None:
        self._call("createfile", {"volume": volume, "path": path}, body=data)

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        self._call("appendfile", {"volume": volume, "path": path}, body=data)

    def read_file(self, volume: str, path: str, offset: int = 0, length: int = -1) -> bytes:
        return self._call(
            "readfile",
            {"volume": volume, "path": path, "offset": offset, "length": length},
            raw=True,
        )

    def stat_file(self, volume: str, path: str) -> int:
        return self._call("statfile", {"volume": volume, "path": path})["size"]

    # metadata
    def read_xl(self, volume: str, path: str) -> XLMeta:
        # The server answers xl.meta's raw bytes, so they are read raw (the
        # JAX client msgpack-decodes them and raises ExtraData; nothing in
        # either package calls read_xl on a remote drive).
        raw = self._call("readxl", {"volume": volume, "path": path}, raw=True)
        return XLMeta.from_bytes(raw)

    def read_version(self, volume: str, path: str, version_id: str = "") -> FileInfo:
        return _fi_unpack(
            self._call("readversion", {"volume": volume, "path": path, "version_id": version_id})
        )

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("writemetadata", {"volume": volume, "path": path, "fi": _fi_pack(fi)})

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("updatemetadata", {"volume": volume, "path": path, "fi": _fi_pack(fi)})

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call(
            "deleteversion",
            {"volume": volume, "path": path, "fi": _fi_pack(fi), "deleted": fi.deleted},
        )

    # commit
    def rename_data(self, src_volume, src_path, fi, dst_volume, dst_path) -> None:
        self._call(
            "renamedata",
            {
                "src_volume": src_volume,
                "src_path": src_path,
                "fi": _fi_pack(fi),
                "dst_volume": dst_volume,
                "dst_path": dst_path,
            },
        )

    def rename_file(self, src_volume, src_path, dst_volume, dst_path) -> None:
        self._call(
            "renamefile",
            {
                "src_volume": src_volume,
                "src_path": src_path,
                "dst_volume": dst_volume,
                "dst_path": dst_path,
            },
        )

    # listing
    def list_dir(self, volume: str, path: str) -> list[str]:
        return self._call("listdir", {"volume": volume, "path": path})

    def walk_dir(self, volume: str, base: str = "", recursive: bool = True):
        """Streaming remote walk: entries decode incrementally from the
        chunked response (storage-rest-client WalkDir role). Typed errors
        (VolumeNotFound etc.) surface before the stream starts; transport
        failures mid-stream re-raise as the typed wire error."""
        url = f"/walkdirstream?disk={urllib.parse.quote(self.drive_path, safe='')}"
        resp = self.client.call(
            url,
            {"volume": volume, "base": base, "recursive": recursive},
            stream=True,
        )
        unpacker = msgpack.Unpacker(raw=False, max_buffer_size=1 << 30)
        try:
            with self.client.stream_guard():
                for chunk in resp.iter_content(chunk_size=1 << 16):
                    if not chunk:
                        continue
                    unpacker.feed(chunk)
                    for item in unpacker:
                        if isinstance(item, dict):  # in-band typed error frame
                            raise name_to_error(
                                item.get("__error__", "StorageError"), item.get("msg", "")
                            )
                        name, raw = item
                        yield name, raw
        finally:
            resp.close()

    # integrity
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("verifyfile", {"volume": volume, "path": path, "fi": _fi_pack(fi)})
