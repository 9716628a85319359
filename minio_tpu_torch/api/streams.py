"""Live NDJSON hub streaming over HTTP: the shared engine for ListenNotification,
admin trace, and the peer listen/trace endpoints.

The reference streams live events/trace records to watchers from EVERY node:
the serving node subscribes to its local pub/sub hub and to each peer's
stream endpoint, merging them into one HTTP response
(cmd/listen-notification-handlers.go:31, cmd/admin-handlers.go:1103-1166,
cmd/peer-rest-server.go:985). This module holds the pieces every such
handler needs:

  * HubBridge -- one DEDICATED thread per watcher pumping a blocking PubSub
    queue into a bounded asyncio queue (never parks a shared executor
    thread; drop-on-full matches PubSub's slow-subscriber semantics);
  * peer_pumps -- threads that consume peers' NDJSON streams and offer each
    record into the same bridge queue (the merge);
  * stream_hub_response -- the response loop: wall-clock keep-alives so
    dead watchers are reaped even when every record is filtered out;
  * close_bridges -- stops every live bridge on one hub, so a closing node
    leaves no pump of its streams behind.
"""

from __future__ import annotations

import asyncio
import json
import queue as queue_mod
import threading
import time
from typing import Callable

from aiohttp import web

from ..control.logging import GLOBAL_LOGGER
from ..control.profiler import COPIED, GLOBAL_PROFILER
from ..control.sanitizer import san_lock, san_rlock


# Every bridge not yet closed, so close_bridges() can reach the streams of a
# closing node's hub.
_live_lock = san_lock("streams._live_lock")
_live: set = set()


def close_bridges(hub) -> int:
    """Close every live bridge subscribed to `hub`; returns how many."""
    with _live_lock:
        bridges = [b for b in _live if b.hub is hub]
    for b in bridges:
        b.close()
    return len(bridges)


class HubBridge:
    """Bridge a blocking PubSub hub into an asyncio queue."""

    def __init__(self, hub, loop: asyncio.AbstractEventLoop, maxsize: int = 10_000):
        self.hub = hub
        self.loop = loop
        self.aq: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.stop = threading.Event()
        self._sub = hub.subscribe() if hub is not None else None
        self._thread = threading.Thread(target=self._pump, daemon=True, name="hub-bridge")
        self._peer_resps: list = []
        self._peer_threads: list[threading.Thread] = []
        self._peer_lock = san_lock("HubBridge._peer_lock")
        with _live_lock:
            _live.add(self)

    def offer_threadsafe(self, item) -> None:
        """Enqueue from any thread; drops when the watcher is slow."""
        self.loop.call_soon_threadsafe(self._offer, item)

    def _offer(self, item) -> None:
        try:
            self.aq.put_nowait(item)
        except asyncio.QueueFull:
            pass  # slow watcher drops records, never grows memory

    def _pump(self) -> None:
        while not self.stop.is_set():
            try:
                item = self._sub.get(True, 0.5)
            except queue_mod.Empty:
                continue
            self.offer_threadsafe(item)

    def start(self) -> None:
        if self._sub is not None:
            self._thread.start()

    def register_peer_resp(self, resp) -> bool:
        """Track a peer stream so close() can abort its blocking read.
        Returns False when the bridge already closed (caller closes resp)."""
        with self._peer_lock:
            if self.stop.is_set():
                return False
            self._peer_resps.append(resp)
            return True

    def start_peer_pumps(self, stream_fns: list[Callable[[], object]]) -> None:
        """One thread per peer stream, merging peers' NDJSON records into the
        bridge queue. A peer going away ends its pump quietly (the local
        stream keeps serving). close() aborts the pumps by closing their
        responses -- a pump blocked in iter_lines() on an event-idle peer
        would otherwise never observe the stop flag (peer keep-alives are
        newline-less, so iter_lines yields nothing)."""

        def pump(stream_fn):
            resp = None
            try:
                resp = stream_fn()
                if not self.register_peer_resp(resp):
                    resp.close()
                    return
                for line in resp.iter_lines():
                    if self.stop.is_set():
                        break
                    if not line or not line.strip():
                        continue  # peer keep-alive
                    try:
                        self.offer_threadsafe(json.loads(line))
                    except ValueError:
                        continue
            except Exception as e:  # noqa: BLE001 - peer loss must not kill the stream
                GLOBAL_LOGGER.log_once(f"peer stream lost: {e}", key="peer-stream")
            finally:
                if resp is not None:
                    try:
                        resp.close()
                    except OSError:
                        pass

        for fn in stream_fns:
            t = threading.Thread(
                target=pump, args=(fn,), daemon=True, name="peer-stream-pump"
            )
            with self._peer_lock:
                self._peer_threads.append(t)
            t.start()

    def close(self) -> None:
        self.stop.set()
        with _live_lock:
            _live.discard(self)
        if self._sub is not None:
            self.hub.unsubscribe(self._sub)
        with self._peer_lock:
            resps, self._peer_resps = self._peer_resps, []
            threads, self._peer_threads = self._peer_threads, []
        for r in resps:
            try:
                r.close()  # aborts the pump's blocking iter_lines
            except OSError:
                pass
        # The local pump wakes within its 0.5s poll; peer pumps unblock when
        # their responses are closed above (a pump still connecting rides the
        # transport timeout -- don't stall the event loop waiting for it).
        if self._thread.is_alive():
            self._thread.join(2.0)
        for t in threads:
            t.join(2.0)


async def stream_hub_response(
    request: web.Request,
    hub,
    to_line: Callable[[object], str | None],
    peer_streams: list[Callable[[], object]] | None = None,
    content_type: str = "application/json",
) -> web.StreamResponse:
    """Stream hub records (local + merged peers) as NDJSON until disconnect.

    to_line turns a record into its wire line or None to filter it out.
    The LOCAL hub subscription happens before the client can observe the
    200, so no locally-emitted record after the headers is lost; peer
    attachment fires before the 200 too but completes asynchronously (an
    HTTP connect per peer) -- remote events are merged as soon as each
    peer's stream is up, and a dead peer never delays the response."""
    loop = asyncio.get_running_loop()
    bridge = HubBridge(hub, loop)
    try:
        if peer_streams:
            bridge.start_peer_pumps(peer_streams)
        resp = web.StreamResponse()
        resp.content_type = content_type
        resp.headers["Connection"] = "close"
        if hub is not None:
            # Loss disclosure: how many records THIS hub has dropped on slow
            # subscribers so far (control/pubsub.py counter). A watcher that
            # reconnects and sees the number grow knows its previous feed
            # had holes instead of trusting an unbroken-looking stream.
            resp.headers["X-Mtpu-Hub-Dropped"] = str(getattr(hub, "dropped", 0))
        await resp.prepare(request)
        bridge.start()
        # Disconnects surface only through failed writes: emit at least one
        # write per ~1s of wall clock even when the filter drops everything,
        # or a dead narrowly-filtered watcher leaks its threads forever.
        last_write = time.monotonic()
        while True:
            if time.monotonic() - last_write > 1.0:
                try:
                    await resp.write(b" ")  # keep-alive, as the reference sends
                    last_write = time.monotonic()
                except (ConnectionResetError, RuntimeError):
                    break
            try:
                record = await asyncio.wait_for(bridge.aq.get(), timeout=1.0)
            except asyncio.TimeoutError:
                continue
            line = to_line(record)
            if line is None:
                continue
            try:
                data = line.encode() + b"\n"
                await resp.write(data)
                # Copy-ledger hop: every watcher line is serialized into a
                # fresh buffer before the write (json.dumps + encode).
                GLOBAL_PROFILER.copy.record("watch-stream", COPIED, len(data))
                last_write = time.monotonic()
            except (ConnectionResetError, RuntimeError):
                break
    finally:
        bridge.close()
    return resp
