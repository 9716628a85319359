"""FaultyDisk: a StorageAPI decorator that injects registry faults.

Layered UNDER storage/metered.py's MeteredDrive -- MeteredDrive(FaultyDisk(
LocalDrive)) -- so injected failures are timed and counted like real ones
(a chaos drive-error shows up in the per-drive error EWMAs exactly as a
kernel EIO would).

Disarmed fast path: `__getattr__` checks the registry's `disk` snapshot;
when it is None the INNER bound method is returned unchanged -- no wrapper
frame, no allocation, identical object to `inner.method`.

Fault semantics:
  drive-error   -- raise errors.FaultyDisk (a DiskError: quorum-countable);
  drive-hang    -- sleep delay_ms (default 100 ms -- a bounded stand-in for
                   a wedged spindle whose caller timed out), then raise
                   errors.FaultyDisk;
  drive-latency -- sleep delay_ms, then run the real call;
  bitrot        -- flip one byte of the shard payload post-checksum: on the
                   default write ops the corruption lands at rest, so every
                   later read fails HighwayHash verify until heal rewrites
                   the shard; with ops=("read_file","read_all") the returned
                   bytes are flipped instead.
"""

from __future__ import annotations

import time

from ..storage.metered import _METERED
from ..utils import errors
from . import faults as faults_mod

# Same seam as the metered set: every StorageAPI method that hits the disk.
_FAULTABLE = _METERED

_BITROT_WRITE_OPS = frozenset({"create_file", "append_file", "append_iov", "write_all"})
_BITROT_READ_OPS = frozenset({"read_file", "read_all"})

_DEFAULT_HANG_MS = 100.0


def flip_byte(buf: bytes) -> bytes:
    """One deterministic mid-buffer bit-complemented byte -- enough to fail
    any digest over the buffer, cheap enough for multi-MiB shards."""
    if not buf:
        return buf
    i = len(buf) // 2
    return b"%s%s%s" % (buf[:i], bytes([buf[i] ^ 0xFF]), buf[i + 1 :])


class FaultyDisk:
    """Transparent StorageAPI decorator consulting a FaultRegistry."""

    def __init__(self, inner, registry: faults_mod.FaultRegistry | None = None):
        # __dict__ assignment avoids recursing through __setattr__/__getattr__
        # (the MeteredDrive decorator idiom).
        self.__dict__["inner"] = inner
        self.__dict__["registry"] = registry if registry is not None else faults_mod.REGISTRY

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if self.registry.disk is None or name not in _FAULTABLE or not callable(attr):
            return attr

        def faulted(*args, **kwargs):
            spec = self._consult(name, args)
            if spec is None:
                return attr(*args, **kwargs)
            return self._inject(spec, name, attr, args, kwargs)

        return faulted

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value
        else:
            setattr(self.inner, name, value)

    # walk_dir stays a REAL generator function so MeteredDrive's
    # isgeneratorfunction check keeps timing the full iteration when it
    # wraps a FaultyDisk instead of a bare LocalDrive.
    def walk_dir(self, volume: str, base: str = "", recursive: bool = True):
        if self.registry.disk is not None:
            spec = self._consult("walk_dir", (volume, base))
            if spec is not None:
                # Generators can't rewrite payloads; error/hang/latency only.
                out = self._inject(spec, "walk_dir", None, (volume, base), {})
                if out is not None:
                    yield from out
                    return
        yield from self.inner.walk_dir(volume, base, recursive)

    # -- internals -----------------------------------------------------------

    def _consult(self, op: str, args: tuple):
        volume = args[0] if args and isinstance(args[0], str) else ""
        path = args[1] if len(args) > 1 and isinstance(args[1], str) else ""
        return self.registry.match_disk(self.inner.endpoint(), op, volume, path)

    def _inject(self, spec, op: str, attr, args: tuple, kwargs: dict):
        kind = spec.kind
        ep = self.inner.endpoint()
        if kind == faults_mod.DRIVE_LATENCY:
            if spec.delay_ms > 0:
                time.sleep(spec.delay_ms / 1e3)
        elif kind == faults_mod.DRIVE_HANG:
            time.sleep((spec.delay_ms or _DEFAULT_HANG_MS) / 1e3)
            raise errors.FaultyDisk(f"chaos: drive hang on {ep}.{op}")
        elif kind == faults_mod.DRIVE_ERROR:
            raise errors.FaultyDisk(f"chaos: injected I/O error on {ep}.{op}")
        elif kind == faults_mod.BITROT:
            if op == "append_iov" and len(args) > 2 and isinstance(args[2], list):
                # Gathered write: corrupt the joined payload, keep the shape.
                args = (args[0], args[1], [flip_byte(b"".join(bytes(v) for v in args[2]))])
            elif op in _BITROT_WRITE_OPS and len(args) > 2 and isinstance(
                args[2], (bytes, bytearray, memoryview)
            ):
                args = (args[0], args[1], flip_byte(bytes(args[2]))) + args[3:]
            elif op in _BITROT_READ_OPS:
                return flip_byte(bytes(attr(*args, **kwargs)))
            elif op == "read_file_into":
                # In-place read: run the real call, then flip a byte inside
                # the caller's pooled window so verify fails downstream.
                n = attr(*args, **kwargs)
                buf = kwargs.get("buf") if len(args) < 4 else args[3]
                if n and buf is not None:
                    i = int(n) // 2
                    buf[i] ^= 0xFF
                return n
        if attr is None:  # walk_dir latency path
            return None
        return attr(*args, **kwargs)
