"""Health / observability probes: the obd-style cluster dump.

Role of the reference's healthinfo surface (cmd/admin-handlers.go:1484
HealthInfoHandler + internal/disk iostats :1266, internal/mountinfo :296,
internal/smart :643): one admin call returns CPU, memory, OS, per-mount,
per-blockdevice-iostat, and per-drive state so support can diagnose a
cluster from a single dump. Everything here reads procfs — no shelling
out, no extra deps; fields that a platform lacks come back empty rather
than erroring (the reference degrades the same way per-probe).
"""

from __future__ import annotations

import os
import platform
import time


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def cpu_info() -> dict:
    raw = _read("/proc/cpuinfo")
    model = ""
    cores = 0
    for line in raw.splitlines():
        if line.startswith("model name") and not model:
            model = line.split(":", 1)[1].strip()
        if line.startswith("processor"):
            cores += 1
    load = _read("/proc/loadavg").split()
    return {
        "model": model,
        "cores": cores or os.cpu_count() or 0,
        "loadavg": [float(x) for x in load[:3]] if len(load) >= 3 else [],
    }


def mem_info() -> dict:
    out: dict[str, int] = {}
    for line in _read("/proc/meminfo").splitlines():
        k, _, rest = line.partition(":")
        if k in ("MemTotal", "MemFree", "MemAvailable", "Buffers", "Cached", "SwapTotal", "SwapFree"):
            out[k.lower()] = int(rest.split()[0]) * 1024  # kB -> bytes
    return out


def os_info() -> dict:
    uptime = _read("/proc/uptime").split()
    return {
        "platform": platform.platform(),
        "kernel": platform.release(),
        "arch": platform.machine(),
        "uptime_seconds": float(uptime[0]) if uptime else 0.0,
    }


def disk_iostats() -> list[dict]:
    """/proc/diskstats (internal/disk/stat_linux.go role): per-device
    read/write counts, sectors, io time."""
    out = []
    for line in _read("/proc/diskstats").splitlines():
        f = line.split()
        if len(f) < 14:
            continue
        name = f[2]
        if name.startswith(("loop", "ram")):
            continue
        out.append(
            {
                "device": name,
                "reads": int(f[3]),
                "read_sectors": int(f[5]),
                "writes": int(f[7]),
                "write_sectors": int(f[9]),
                "io_in_progress": int(f[11]),
                "io_time_ms": int(f[12]),
            }
        )
    return out


def mount_info() -> list[dict]:
    out = []
    for line in _read("/proc/mounts").splitlines():
        f = line.split()
        if len(f) < 4 or f[2] in ("proc", "sysfs", "cgroup", "cgroup2", "devpts", "securityfs"):
            continue
        out.append({"device": f[0], "mountpoint": f[1], "fstype": f[2], "options": f[3]})
    return out


def net_info() -> list[dict]:
    out = []
    for line in _read("/proc/net/dev").splitlines()[2:]:
        name, _, rest = line.partition(":")
        f = rest.split()
        if len(f) < 16:
            continue
        out.append(
            {
                "interface": name.strip(),
                "rx_bytes": int(f[0]),
                "rx_errors": int(f[2]),
                "tx_bytes": int(f[8]),
                "tx_errors": int(f[10]),
            }
        )
    return out


def drives_info(layer) -> list[dict]:
    """Per-drive state incl. latency EWMAs when the drive is metered
    (xl-storage-disk-id-check.go role)."""
    from ..ops import native
    from ..utils import errors

    out = []
    for pool_idx, pool in enumerate(getattr(layer, "pools", [])):
        for d in getattr(pool, "disks", []):
            if d is None:
                out.append({"pool": pool_idx, "state": "offline"})
                continue
            entry: dict = {"pool": pool_idx, "endpoint": d.endpoint()}
            try:
                di = d.disk_info()
                entry.update(
                    state="ok",
                    total=di.total,
                    free=di.free,
                    disk_id=di.disk_id,
                )
            except errors.DiskError:
                entry["state"] = "offline"
            if d.is_local():
                # The port's LocalDrive writes through its host library
                # (ops/native.py), which a failed build stops instead of
                # falling back: reuse the drive's cached probe, or run it.
                cached = getattr(d, "_odirect", None)
                if cached is None:
                    try:
                        cached = native.odirect_supported(d.root)
                        d._odirect = cached
                    except (OSError, AttributeError):
                        cached = None
                if cached is not None:
                    entry["odirect"] = cached
            metrics = getattr(d, "api_latencies", None)
            if callable(metrics):
                entry["api_latencies_ms"] = metrics()
            out.append(entry)
    return out


def health_info(layer=None) -> dict:
    """The full obd dump (mc admin obd / health top-level shape)."""
    info = {
        "timestamp": time.time(),
        "cpu": cpu_info(),
        "memory": mem_info(),
        "os": os_info(),
        "iostats": disk_iostats(),
        "mounts": mount_info(),
        "network": net_info(),
    }
    if layer is not None:
        info["drives"] = drives_info(layer)
    return info
