"""Prometheus metrics: request counters, latency windows, storage gauges.

Role of the reference's cmd/metrics-v2.go (MetricsGroup cached collectors,
TTFB histograms :977) + http-stats.go + last-minute.go: per-API counters and
latency tracking exposed as Prometheus text at /minio/v2/metrics/cluster.
Pure stdlib -- the exposition format is simple text.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque

from .degrade import GLOBAL_DEGRADE
from .sanitizer import san_lock, san_rlock


class LastMinuteLatency:
    """Sliding 60s window of (count, total_seconds) per second bucket
    (cmd/last-minute.go role)."""

    def __init__(self):
        self._buckets: deque[tuple[int, int, float]] = deque()  # (sec, n, total)
        self._lock = san_lock("LastMinuteLatency._lock")

    def add(self, seconds: float) -> None:
        now = int(time.time())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == now:
                s, n, t = self._buckets[-1]
                self._buckets[-1] = (s, n + 1, t + seconds)
            else:
                self._buckets.append((now, 1, seconds))
            cutoff = now - 60
            while self._buckets and self._buckets[0][0] < cutoff:
                self._buckets.popleft()

    def stats(self) -> tuple[int, float]:
        now = int(time.time())
        cutoff = now - 60
        with self._lock:
            n = sum(b[1] for b in self._buckets if b[0] >= cutoff)
            t = sum(b[2] for b in self._buckets if b[0] >= cutoff)
        return n, t


HIST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class MetricsSys:
    def __init__(self):
        self._lock = san_lock("MetricsSys._lock")
        self.http_requests: dict[tuple[str, int], int] = defaultdict(int)
        self.api_calls: dict[str, int] = defaultdict(int)
        self.api_errors: dict[str, int] = defaultdict(int)
        self.api_latency: dict[str, LastMinuteLatency] = defaultdict(LastMinuteLatency)
        # Cumulative duration histogram per API (metrics-v2.go:977 TTFB
        # distribution role): [bucket counts..., +Inf], plus sum.
        self.api_hist: dict[str, list[int]] = defaultdict(
            lambda: [0] * (len(HIST_BUCKETS) + 1)
        )
        self.api_hist_sum: dict[str, float] = defaultdict(float)
        self.bytes_received = 0
        self.bytes_sent = 0
        self.encode_batches = 0
        self.encode_blocks = 0
        self.encode_device_ns = 0
        self.start_time = time.time()
        self.layer = None  # set by the server for storage gauges
        self.replication = None  # ReplicationSys for replication gauges
        # Node-level sources (wired by Node.build; None outside a server):
        self.node_url = ""  # this node's URL, the cluster-view server label
        self.notification = None  # NotificationSys: peer metrics fetch
        self.scanner = None  # DataScanner progress counters
        self.healmgr = None  # HealManager sequence counters
        self.mrf = None  # MRFQueue heal backlog
        self.disk_heal = None  # DiskHealMonitor completed trackers
        self.memcache = None  # MemObjectCache: hot-read tier counters
        self.poolmgr = None  # PoolManager: pool lifecycle gauges
        self.notifier = None  # EventNotifier: listen-hub drop disclosure

    # -- recording -----------------------------------------------------------

    def record_http(self, method: str, status: int) -> None:
        with self._lock:
            self.http_requests[(method, status)] += 1

    def record_api(self, api: str, seconds: float, ok: bool, rx: int = 0, tx: int = 0) -> None:
        with self._lock:
            self.api_calls[api] += 1
            if not ok:
                self.api_errors[api] += 1
            self.bytes_received += rx
            self.bytes_sent += tx
            hist = self.api_hist[api]
            for i, ub in enumerate(HIST_BUCKETS):
                if seconds <= ub:
                    hist[i] += 1
                    break
            else:
                hist[-1] += 1
            self.api_hist_sum[api] += seconds
        self.api_latency[api].add(seconds)

    def record_encode(self, blocks: int, device_ns: int) -> None:
        with self._lock:
            self.encode_batches += 1
            self.encode_blocks += blocks
            self.encode_device_ns += device_ns

    # -- exposition ----------------------------------------------------------

    def render(self) -> str:
        """Back-compat alias: the full node exposition."""
        return self.render_node()

    def render_node(self) -> str:
        lines: list[str] = []
        helped: set[str] = set()

        def metric(
            name: str,
            value,
            labels: dict | None = None,
            help_: str = "",
            type_: str = "counter",
        ):
            # HELP/TYPE go out once per series, before its first sample.
            if help_ and name not in helped:
                helped.add(name)
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {type_}")
            if labels:
                lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
                lines.append(f"{name}{{{lab}}} {value}")
            else:
                lines.append(f"{name} {value}")

        with self._lock:
            http = dict(self.http_requests)
            calls = dict(self.api_calls)
            errs = dict(self.api_errors)
            rx, tx = self.bytes_received, self.bytes_sent
            enc = (self.encode_batches, self.encode_blocks, self.encode_device_ns)

        metric("minio_tpu_uptime_seconds", round(time.time() - self.start_time, 1),
               help_="Server uptime.", type_="gauge")
        metric("minio_tpu_s3_traffic_received_bytes", rx, help_="Total S3 bytes received.")
        metric("minio_tpu_s3_traffic_sent_bytes", tx, help_="Total S3 bytes sent.")
        lines.append("# HELP minio_tpu_http_requests_total HTTP requests by method/status.")
        lines.append("# TYPE minio_tpu_http_requests_total counter")
        helped.add("minio_tpu_http_requests_total")
        for (method, status), n in sorted(http.items()):
            metric("minio_tpu_http_requests_total", n, {"method": method, "status": status})
        lines.append("# HELP minio_tpu_s3_requests_total S3 API calls.")
        lines.append("# TYPE minio_tpu_s3_requests_total counter")
        helped.add("minio_tpu_s3_requests_total")
        for api, n in sorted(calls.items()):
            metric("minio_tpu_s3_requests_total", n, {"api": api})
        for api, n in sorted(errs.items()):
            metric("minio_tpu_s3_requests_errors_total", n, {"api": api},
                   help_="S3 API calls that returned an error.")
        for api, lat in self.api_latency.items():
            n, t = lat.stats()
            if n:
                metric(
                    "minio_tpu_s3_request_seconds_last_minute",
                    round(t / n, 6),
                    {"api": api},
                    help_="Mean request latency over the trailing minute.",
                    type_="gauge",
                )
        lines.append(
            "# HELP minio_tpu_s3_request_duration_seconds Request duration distribution."
        )
        lines.append("# TYPE minio_tpu_s3_request_duration_seconds histogram")
        with self._lock:
            hists = {k: (list(v), self.api_hist_sum[k]) for k, v in self.api_hist.items()}
        for api, (buckets, total_s) in sorted(hists.items()):
            cum = 0
            for i, ub in enumerate(HIST_BUCKETS):
                cum += buckets[i]
                lines.append(
                    f'minio_tpu_s3_request_duration_seconds_bucket{{api="{api}",le="{ub}"}} {cum}'
                )
            cum += buckets[-1]
            lines.append(
                f'minio_tpu_s3_request_duration_seconds_bucket{{api="{api}",le="+Inf"}} {cum}'
            )
            lines.append(
                f'minio_tpu_s3_request_duration_seconds_sum{{api="{api}"}} {round(total_s, 6)}'
            )
            lines.append(f'minio_tpu_s3_request_duration_seconds_count{{api="{api}"}} {cum}')
        metric("minio_tpu_encode_batches_total", enc[0],
               help_="Device encode batches run.")
        metric("minio_tpu_encode_blocks_total", enc[1],
               help_="Blocks encoded via record_encode.")
        metric("minio_tpu_encode_device_seconds_total", round(enc[2] / 1e9, 6),
               help_="Device encode wall time via record_encode.")

        self._render_drives(metric)
        self._render_codec(metric)
        self._render_perf(lines)
        self._render_profiler(metric)
        self._render_heal_scanner(metric)
        self._render_chaos(metric)
        self._render_crash(metric)
        self._render_degrade(metric)
        self._render_san(metric)
        self._render_bufsan(metric)
        self._render_memcache(metric)
        self._render_pools(metric)
        self._render_timeseries(metric)
        self._render_flight(metric)

        if self.layer is not None:
            total = free = 0
            online = offline = 0
            for p in self.layer.pools:
                for d in p.disks:
                    if d is None or not d.is_online():
                        offline += 1
                        continue
                    online += 1
                    try:
                        di = d.disk_info()
                        total += di.total
                        free += di.free
                    except Exception:  # noqa: BLE001
                        offline += 1
            metric("minio_tpu_cluster_capacity_raw_total_bytes", total,
                   help_="Total raw capacity.", type_="gauge")
            metric("minio_tpu_cluster_capacity_raw_free_bytes", free,
                   help_="Free raw capacity.", type_="gauge")
            metric("minio_tpu_cluster_drives_online_total", online,
                   help_="Online drives.", type_="gauge")
            metric("minio_tpu_cluster_drives_offline_total", offline,
                   help_="Offline drives.", type_="gauge")

        repl = self.replication
        if repl is not None:
            st = repl.stats
            metric("minio_tpu_replication_completed_total", st.completed,
                   help_="Replica operations completed.")
            metric("minio_tpu_replication_failed_total", st.failed,
                   help_="Replica operations failed.")
            metric("minio_tpu_replication_sent_bytes", st.replicated_bytes,
                   help_="Bytes replicated to targets.")
            metric("minio_tpu_replication_pending_total", repl.pending,
                   help_="Replica operations pending.", type_="gauge")
            for bucket, targets in repl.bandwidth.report().items():
                for arn, row in targets.items():
                    labels = {"bucket": bucket, "arn": arn}
                    metric(
                        "minio_tpu_replication_link_limit_bytes_per_second",
                        row["limitInBytesPerSecond"], labels,
                        help_="Configured replication bandwidth limit.",
                        type_="gauge",
                    )
                    metric(
                        "minio_tpu_replication_link_bytes_per_second",
                        row["currentBandwidthInBytesPerSecond"], labels,
                        help_="Observed replication bandwidth.",
                        type_="gauge",
                    )
        return "\n".join(lines) + "\n"

    # -- node series sections ------------------------------------------------

    def _render_drives(self, metric) -> None:
        """Per-drive per-API series from MeteredDrive EWMAs (the seed
        collected these and never exported them)."""
        if self.layer is None:
            return
        for p in self.layer.pools:
            for d in p.disks:
                lat_fn = getattr(d, "api_latencies", None)
                ep_fn = getattr(d, "endpoint", None)
                if lat_fn is None or ep_fn is None:
                    continue
                try:
                    drive = ep_fn()
                    rows = lat_fn()
                except Exception:  # noqa: BLE001 - one bad drive, not the scrape
                    continue
                for api, row in rows.items():
                    labels = {"drive": drive, "api": api}
                    metric("minio_tpu_drive_latency_ms", row["ewma_ms"], labels,
                           help_="Per-drive per-API latency EWMA.", type_="gauge")
                    metric("minio_tpu_drive_calls_total", row["count"], labels,
                           help_="Per-drive StorageAPI calls.")
                    metric("minio_tpu_drive_errors_total", row["errors"], labels,
                           help_="Per-drive StorageAPI call failures.")

    _BREAKER_STATES = {"closed": 0, "open": 1, "half-open": 2}

    def _render_degrade(self, metric) -> None:
        """Degradation-ladder counters (hedges, deadline aborts, sheds,
        breaker trips) plus per-drive breaker state gauges."""
        snap = GLOBAL_DEGRADE.snapshot()
        metric("minio_tpu_hedge_launched_total", snap["hedge_launched"],
               help_="Hedge reads armed against slow erasure shards.")
        metric("minio_tpu_hedge_wins_total", snap["hedge_wins"],
               help_="Hedge reads that beat their straggling primary.")
        for stage, n in sorted(snap["deadline_aborts"].items()):
            metric("minio_tpu_deadline_aborts_total", n, {"stage": stage},
                   help_="Operations aborted by an expired request deadline.")
        for kind, n in sorted(snap["sheds"].items()):
            metric("minio_tpu_requests_shed_total", n, {"kind": kind},
                   help_="Work refused by admission control (read/write/drive).")
        metric("minio_tpu_breaker_trips_total", snap["breaker_trips"],
               help_="Drive circuit breakers tripped open.")
        metric("minio_tpu_breaker_closes_total", snap["breaker_closes"],
               help_="Drive circuit breakers re-closed after a probe.")
        if self.layer is None:
            return
        for p in self.layer.pools:
            for d in p.disks:
                state_fn = getattr(d, "breaker_state", None)
                ep_fn = getattr(d, "endpoint", None)
                if state_fn is None or ep_fn is None:
                    continue
                try:
                    st = state_fn()
                    drive = ep_fn()
                except Exception:  # noqa: BLE001 - one bad drive, not the scrape
                    continue
                metric(
                    "minio_tpu_drive_breaker_state",
                    self._BREAKER_STATES.get(st["state"], -1),
                    {"drive": drive},
                    help_="Breaker state: 0 closed, 1 open, 2 half-open.",
                    type_="gauge",
                )
                metric("minio_tpu_drive_breaker_trips_total", st["trips"],
                       {"drive": drive},
                       help_="Times this drive's breaker tripped open.")

    def _render_codec(self, metric) -> None:
        """Device/codec series: batch occupancy, queue depth, device-vs-host
        routing, per-kernel wall time, and the device probe outcome."""
        from .. import runtime
        from ..object import codec as codec_mod

        probe = runtime.probe_status()
        metric(
            "minio_tpu_device_probe_done", 1 if probe is not None else 0,
            help_="1 once the bounded device-init probe has run.", type_="gauge",
        )
        if probe is not None:
            metric(
                "minio_tpu_device_probe_ok", 1 if probe.ok else 0,
                {"platform": probe.platform or "none"},
                help_="1 when the probe found a usable accelerator.",
                type_="gauge",
            )
        # The JAX exposition also renders the probe's verdict flips and its
        # recovery re-probe cadence here; the port has neither (a failed
        # probe refuses the boot, ROADMAP.md Departures "Boot"), so the two
        # series are absent rather than stood in for.
        # Native host-kernel availability WITHOUT triggering a load: a
        # scrape must never kick off the g++ build path. Rendered before
        # the device-codec section so it exists on host-codec nodes too.
        from ..ops import native

        tried, loaded = native.status()
        metric("minio_tpu_native_codec_probe_done", 1 if tried else 0,
               help_="1 once the native host-kernel load was attempted.",
               type_="gauge")
        metric("minio_tpu_native_codec_available", 1 if loaded else 0,
               help_="1 when the host library (ops/native.py) is loaded; nothing falls back to numpy.",
               type_="gauge")
        codec = codec_mod._default  # read-only peek: a scrape must not install
        stats_fn = getattr(codec, "stats", None)
        if stats_fn is None:
            return
        st = stats_fn()
        metric("minio_tpu_codec_blocks_encoded_total", st["blocks_encoded"],
               help_="Blocks encoded on the device pipeline.")
        metric("minio_tpu_codec_encode_batches_total", st["batches_run"],
               help_="Device encode batches launched.")
        metric("minio_tpu_codec_blocks_reconstructed_total", st["blocks_reconstructed"],
               help_="Blocks rebuilt on the device pipeline.")
        metric("minio_tpu_codec_recon_batches_total", st["recon_batches_run"],
               help_="Device reconstruct batches launched.")
        metric("minio_tpu_codec_digests_verified_total", st["digests_verified"],
               help_="Chunks digest-verified on the device pipeline.")
        metric("minio_tpu_codec_verify_batches_total", st["verify_batches_run"],
               help_="Device verify batches launched.")
        padded = st["blocks_padded"]
        metric(
            "minio_tpu_codec_batch_occupancy",
            round(st["blocks_encoded"] / padded, 4) if padded else 0.0,
            help_="Real blocks per padded device-batch slot (1.0 = no padding waste).",
            type_="gauge",
        )
        for kind, key in (
            ("encode", "host_fallback_blocks"),
            ("reconstruct", "host_fallback_recon_blocks"),
            ("digest", "host_fallback_digest_chunks"),
        ):
            metric("minio_tpu_codec_host_fallback_total", st[key], {"kind": kind},
                   help_="Work routed to the host codec instead of the device.")
        for kernel, key in (
            ("encode", "device_encode_seconds"),
            ("reconstruct", "device_recon_seconds"),
            ("verify", "device_verify_seconds"),
        ):
            metric(
                "minio_tpu_codec_device_seconds_total", round(st[key], 6),
                {"kernel": kernel},
                help_="Wall time inside device kernels.",
            )
        if "compiled_verify_lens" in st:
            metric(
                "minio_tpu_codec_compiled_verify_lengths", st["compiled_verify_lens"],
                help_="Distinct non-standard chunk lengths admitted to the "
                      "device verify compile cache (capped at 8).",
                type_="gauge",
            )
        # Multi-chip fan-out: mesh width and per-chip share of encoded
        # blocks (per-chip occupancy -- exposes dp imbalance
        # when batch sizes don't tile the mesh).
        if "mesh_devices" in st:
            metric("minio_tpu_codec_mesh_devices", st["mesh_devices"],
                   help_="Devices the encode mesh fans batches over (1 = single-device).",
                   type_="gauge")
            for chip, blocks in enumerate(st.get("chip_blocks", [])):
                metric("minio_tpu_codec_chip_blocks_total", blocks,
                       {"chip": str(chip)},
                       help_="Real blocks encoded per data-parallel mesh group.")
        if "small_blocks_encoded" in st:
            metric("minio_tpu_codec_small_blocks_encoded_total",
                   st["small_blocks_encoded"],
                   help_="Sub-block objects encoded via the coalesced small-object path.")
            metric("minio_tpu_codec_small_batches_total", st["small_batches_run"],
                   help_="Coalesced small-object device batches launched.")
            metric("minio_tpu_codec_double_buffered_batches_total",
                   st["double_buffered_batches"],
                   help_="Encode batches whose dispatch overlapped the previous "
                         "batch's device->host readback.")
        depths_fn = getattr(codec, "queue_depths", None)
        if depths_fn is not None:
            for geom, depth in sorted(depths_fn().items()):
                metric("minio_tpu_codec_queue_depth", depth, {"geometry": geom},
                       help_="Pending encode requests per batch worker.",
                       type_="gauge")

    def _render_perf(self, lines: list[str]) -> None:
        """Stage-ledger exposition: one Prometheus histogram per
        (layer, stage) from the always-on perf ledger (control/perf.py).
        Hand-rendered like the s3 request histogram above -- cumulative
        buckets, +Inf, _sum/_count."""
        from .perf import BUCKET_LE_S, GLOBAL_PERF

        slow = GLOBAL_PERF.slow.stats()
        for mname, key, help_ in (
            ("minio_tpu_slow_requests_captured_total", "captured_total",
             "Requests whose full span tree was retained by the slow-request capture."),
            ("minio_tpu_slow_capture_evicted_spans_total", "evicted_spans",
             "Spans dropped by the slow-capture per-trace/ring caps."),
            ("minio_tpu_slow_capture_evicted_traces_total", "evicted_traces",
             "Whole traces evicted from the slow-capture ring."),
        ):
            lines.append(f"# HELP {mname} {help_}")
            lines.append(f"# TYPE {mname} counter")
            lines.append(f"{mname} {slow[key]}")

        snap = GLOBAL_PERF.ledger.snapshot()
        stages = snap.get("stages", {})
        if not stages:
            return
        name = "minio_tpu_stage_duration_seconds"
        lines.append(f"# HELP {name} Per-stage latency distribution (perf ledger).")
        lines.append(f"# TYPE {name} histogram")
        for layer in sorted(stages):
            for stage in sorted(stages[layer]):
                row = stages[layer][stage]
                counts = row["counts"]
                lab = f'layer="{layer}",stage="{stage}"'
                cum = 0
                for i, le in enumerate(BUCKET_LE_S):
                    cum += counts[i]
                    lines.append(f'{name}_bucket{{{lab},le="{le:.6g}"}} {cum}')
                cum += counts[-1]
                lines.append(f'{name}_bucket{{{lab},le="+Inf"}} {cum}')
                lines.append(f'{name}_sum{{{lab}}} {round(row["sum"], 6)}')
                lines.append(f'{name}_count{{{lab}}} {cum}')
        # CPU attribution alongside the wall histogram: thread_time()
        # seconds accumulated per stage. stage_cpu / stage_duration_sum
        # close to 1 means the stage burns the core; close to 0 means it
        # waits (GIL or I/O).
        cname = "minio_tpu_stage_cpu_seconds_total"
        lines.append(
            f"# HELP {cname} CPU (thread_time) seconds attributed per stage."
        )
        lines.append(f"# TYPE {cname} counter")
        for layer in sorted(stages):
            for stage in sorted(stages[layer]):
                row = stages[layer][stage]
                lines.append(
                    f'{cname}{{layer="{layer}",stage="{stage}"}} '
                    f'{round(row.get("cpu", 0.0), 6)}'
                )

    def _render_profiler(self, metric) -> None:
        """Continuous profiling plane (control/profiler.py). GIL/sampler
        gauges render only while the plane is armed; the copy ledger is
        always-on passive counters and renders whenever it has rows."""
        from .profiler import GLOBAL_PROFILER

        sampler = GLOBAL_PROFILER.sampler
        if GLOBAL_PROFILER.armed and sampler is not None:
            metric(
                "minio_tpu_gil_load", round(GLOBAL_PROFILER.gil_load(), 4),
                help_="Calibrated GIL-load estimate in [0,1] from the "
                      "scheduling-jitter probe (0 until calibrated).",
                type_="gauge",
            )
            metric(
                "minio_tpu_profiler_overhead_ratio",
                round(sampler.overhead_ratio(), 6),
                help_="Continuous-sampler self-time as a fraction of wall "
                      "time over the retained windows.",
                type_="gauge",
            )
            metric(
                "minio_tpu_profiler_samples_window",
                sum(w["samples"] for w in sampler.windows(top=0)),
                help_="Stack samples held across the retained profile windows.",
                type_="gauge",
            )
            metric(
                "minio_tpu_profiler_windows_rotated_total",
                sampler.windows_rotated,
                help_="Profile windows closed into the ring since start.",
            )
        hops = GLOBAL_PROFILER.copy.snapshot()["hops"]
        for hop, row in sorted(hops.items()):
            for kind, key in (("copied", "copied_bytes"), ("moved", "moved_bytes")):
                metric(
                    "minio_tpu_copy_bytes_total", row[key],
                    {"hop": hop, "kind": kind},
                    help_="Data-path bytes per hop, split copied (hop "
                          "materialized a new buffer) vs moved (zero-copy "
                          "pass-through).",
                )
        for hop, row in sorted(hops.items()):
            for kind, key in (("copied", "copied_ops"), ("moved", "moved_ops")):
                metric(
                    "minio_tpu_copy_ops_total", row[key],
                    {"hop": hop, "kind": kind},
                    help_="Data-path buffer operations per hop, by kind.",
                )

    def _render_heal_scanner(self, metric) -> None:
        """Heal + scanner progress counters (healmgr/MRF/disk-heal/scanner)."""
        mrf = self.mrf
        if mrf is not None:
            metric("minio_tpu_heal_mrf_healed_total", mrf.healed,
                   help_="Objects healed from the MRF queue.")
            metric("minio_tpu_heal_mrf_failed_total", mrf.failed,
                   help_="MRF heal attempts that failed.")
            metric("minio_tpu_heal_mrf_pending", mrf.pending(),
                   help_="Objects queued for MRF heal.", type_="gauge")
            metric("minio_tpu_heal_mrf_dropped_total", getattr(mrf, "dropped", 0),
                   help_="Heal requests dropped because the MRF queue was full "
                         "(the scanner sweep must find these later).")
        hm = self.healmgr
        if hm is not None:
            seqs = list(getattr(hm, "sequences", {}).values())
            metric("minio_tpu_heal_sequences_running",
                   sum(1 for s in seqs if s.running),
                   help_="Heal sequences currently running.", type_="gauge")
            metric("minio_tpu_heal_objects_scanned_total",
                   sum(s.scanned for s in seqs),
                   help_="Objects scanned by heal sequences.")
            metric("minio_tpu_heal_objects_healed_total",
                   sum(s.healed for s in seqs),
                   help_="Objects healed by heal sequences.")
            metric("minio_tpu_heal_objects_failed_total",
                   sum(s.failed for s in seqs),
                   help_="Objects heal sequences failed to heal.")
        dh = self.disk_heal
        if dh is not None:
            metric("minio_tpu_heal_drives_completed_total",
                   len(getattr(dh, "completed", ())),
                   help_="Fresh-drive heals completed since boot.")
        sc = self.scanner
        if sc is not None:
            metric("minio_tpu_scanner_cycles_completed_total", sc.cycles_completed,
                   help_="Data scanner full cycles completed.")
            metric("minio_tpu_scanner_objects_healed_total", sc.objects_healed,
                   help_="Objects queued for heal by the scanner.")
            metric("minio_tpu_scanner_objects_expired_total", sc.objects_expired,
                   help_="Objects expired by ILM rules.")
            metric("minio_tpu_scanner_uploads_aborted_total", sc.uploads_aborted,
                   help_="Stale multipart uploads aborted.")
            metric("minio_tpu_scanner_objects_transitioned_total",
                   sc.objects_transitioned,
                   help_="Objects transitioned to a remote tier.")
            usage = getattr(sc, "usage", None)
            if usage is not None:
                metric("minio_tpu_scanner_usage_last_update",
                       round(getattr(usage, "last_update", 0.0), 3),
                       help_="Unix time of the last usage snapshot.",
                       type_="gauge")

    def _render_chaos(self, metric) -> None:
        """Fault-injection plane counters (chaos/faults.py): how many faults
        each armed schedule has fired, by kind and target scope. Nothing is
        emitted on a node that never armed a fault."""
        from ..chaos.faults import REGISTRY

        counts = REGISTRY.injected_counts()
        armed = REGISTRY.list()
        if not counts and not armed:
            return
        metric("minio_tpu_chaos_faults_armed", len(armed),
               help_="Fault specs currently armed in the chaos registry.",
               type_="gauge")
        for (kind, target), n in sorted(counts.items()):
            metric("minio_tpu_chaos_injected_total", n,
                   {"kind": kind, "target": target},
                   help_="Faults injected by the chaos plane.")

    def _render_crash(self, metric) -> None:
        """Crash-consistency plane: recovery-scan sweep counters
        (storage/recovery.py) plus armed/fired crash points (chaos/crash.py).
        A node that never swept debris and never armed a crash point emits
        nothing."""
        from ..chaos.crash import REGISTRY
        from ..storage import recovery

        counts = recovery.counters()
        armed = REGISTRY.list()
        fired = REGISTRY.fired_counts()
        if not any(counts.values()) and not armed and not fired:
            return
        for key, n in sorted(counts.items()):
            if key == "scans":
                metric("minio_tpu_crash_recovery_scans_total", n,
                       help_="Recovery-scan passes completed.")
                continue
            metric("minio_tpu_crash_recovery_swept_total", n, {"kind": key},
                   help_="Crash debris swept by the recovery scan, by kind.")
        metric("minio_tpu_crash_points_armed", len(armed),
               help_="Crash specs currently armed in the crash registry.",
               type_="gauge")
        for point, n in sorted(fired.items()):
            metric("minio_tpu_crash_fired_total", n, {"point": point},
                   help_="Crash points fired, by point name.")

    def _render_pools(self, metric) -> None:
        """Pool lifecycle plane (object/poolmgr.py + control/rebalance.py):
        per-pool capacity/used/objects gauges, drain progress, and the
        process-wide lifecycle counters. Emitted only on nodes with a
        PoolManager (i.e. inside a built server)."""
        pm = self.poolmgr
        if pm is None:
            return
        from ..object.poolmgr import STATS
        from .rebalance import _budgets_lock, _live_budgets

        st = STATS.snapshot()
        metric("minio_tpu_pool_attached_total", st["pools_attached"],
               help_="Pools attached at runtime.")
        metric("minio_tpu_pool_epoch_bumps_total", st["epoch_bumps"],
               help_="Pool-config epoch bumps (attach/drain transitions).")
        metric("minio_tpu_pool_decommissions_started_total",
               st["decommissions_started"],
               help_="Decommission drains started.")
        metric("minio_tpu_pool_decommissions_resumed_total",
               st["decommissions_resumed"],
               help_="Decommission drains resumed from a checkpoint.")
        metric("minio_tpu_pool_decommissions_completed_total",
               st["decommissions_completed"],
               help_="Decommission drains completed.")
        metric("minio_tpu_pool_objects_moved_total", st["objects_moved"],
               help_="Objects migrated between pools (drain + rebalance).")
        metric("minio_tpu_pool_moved_bytes_total", st["bytes_moved"],
               help_="Bytes migrated between pools (drain + rebalance).")
        metric("minio_tpu_pool_move_failures_total", st["move_failures"],
               help_="Object moves that failed.")
        metric("minio_tpu_pool_checkpoints_total", st["checkpoints"],
               help_="Drain cursor checkpoints persisted.")
        metric("minio_tpu_pool_rebalance_rounds_total", st["rebalance_rounds"],
               help_="Rebalance rounds executed.")
        with _budgets_lock:
            waits = sum(b.throttle_waits for b in _live_budgets)
            secs = sum(b.throttled_seconds for b in _live_budgets)
            mig_ops = sum(b.ops for b in _live_budgets)
            mig_bytes = sum(b.bytes for b in _live_budgets)
        metric("minio_tpu_pool_throttle_waits_total", waits,
               help_="Migration ops delayed by the ops/bytes budget.")
        metric("minio_tpu_pool_throttled_seconds_total", round(secs, 6),
               help_="Seconds migration traffic spent throttled.")
        metric("minio_tpu_pool_migration_ops_total", mig_ops,
               help_="Moves charged against migration budgets.")
        metric("minio_tpu_pool_migration_budget_bytes_total", mig_bytes,
               help_="Bytes charged against migration budgets.")
        try:
            status = pm.status()
        except Exception:  # noqa: BLE001 - scrape must not die on a gauge walk
            return
        for row in status.get("pools", []):
            labels = {"pool": row["index"], "status": row["status"]}
            metric("minio_tpu_pool_capacity_bytes", row["capacity_bytes"],
                   labels, help_="Per-pool raw capacity.", type_="gauge")
            metric("minio_tpu_pool_free_bytes", row["free_bytes"], labels,
                   help_="Per-pool raw free bytes.", type_="gauge")
            metric("minio_tpu_pool_used_bytes", row["data_bytes"], labels,
                   help_="Per-pool object data bytes.", type_="gauge")
            metric("minio_tpu_pool_objects", row["objects"], labels,
                   help_="Per-pool object count.", type_="gauge")
            drain = row.get("drain")
            if drain:
                dl = {"pool": row["index"]}
                metric("minio_tpu_pool_drain_objects_moved", drain["objects_moved"],
                       dl, help_="Objects this pool's drain has moved out.",
                       type_="gauge")
                metric("minio_tpu_pool_drain_bytes_moved", drain["bytes_moved"],
                       dl, help_="Bytes this pool's drain has moved out.",
                       type_="gauge")
                metric("minio_tpu_pool_drain_finished", int(bool(drain["finished"])),
                       dl, help_="1 once this pool's drain completed.",
                       type_="gauge")

    def _render_timeseries(self, metric) -> None:
        """Always-on ops/s plane (control/perf.py OpsTimeSeries) plus the
        self-measurement probe counters (control/selftest.py SelfTestStats).
        Rates are trailing 60 s means per op class -- the gauge form of the
        per-second series /mtpu/admin/v1/timeseries serves raw."""
        from .perf import GLOBAL_PERF, OP_CLASSES
        from .selftest import STATS

        rates = GLOBAL_PERF.timeseries.rates(horizon_s=60)
        zero = {"ops_per_s": 0.0, "errors_per_s": 0.0, "bytes_per_s": 0.0}
        for cls in OP_CLASSES:
            row = rates.get(cls, zero)
            metric("minio_tpu_ops_per_second", row["ops_per_s"],
                   {"class": cls},
                   help_="Requests per second over the trailing minute, by op class.",
                   type_="gauge")
            metric("minio_tpu_op_errors_per_second", row["errors_per_s"],
                   {"class": cls},
                   help_="Failed requests per second over the trailing minute.",
                   type_="gauge")
            metric("minio_tpu_op_bytes_per_second", row["bytes_per_s"],
                   {"class": cls},
                   help_="Request+response bytes per second over the trailing minute.",
                   type_="gauge")
        st = STATS.snapshot()
        for probe, key in (("object", "object_runs"), ("drive", "drive_runs"),
                           ("net", "net_runs")):
            metric("minio_tpu_selftest_runs_total", st[key], {"probe": probe},
                   help_="Self-measurement probe runs, by probe kind.")
        metric("minio_tpu_selftest_probe_failures_total", st["probe_failures"],
               help_="Probe runs that reported a failed node/drive/link.")
        metric("minio_tpu_selftest_scratch_cleanups_total", st["scratch_cleanups"],
               help_="Scratch-bucket cleanup passes after speedtest rounds.")

    def _render_flight(self, metric) -> None:
        """Flight-recorder plane (control/flight.py FlightRecorder) plus the
        lossy-channel accounting the black box depends on: pub/sub hub drops
        (control/pubsub.py) and the webhook audit sink's queue counters
        (control/logging.py WebhookTarget)."""
        from .flight import GLOBAL_FLIGHT
        from .logging import GLOBAL_LOGGER
        from .pubsub import GLOBAL_TRACE

        st = GLOBAL_FLIGHT.stats()
        metric("minio_tpu_flight_armed", int(bool(st["armed"])),
               help_="1 when the flight-recorder trigger thread is running.",
               type_="gauge")
        metric("minio_tpu_flight_ring_spans", st["ring_spans"],
               help_="Root spans currently held in the flight ring.",
               type_="gauge")
        metric("minio_tpu_flight_ring_capacity", st["ring_max"],
               help_="Configured flight ring capacity.", type_="gauge")
        for reason, n in sorted(st["triggers"].items()):
            metric("minio_tpu_flight_triggers_total", n, {"reason": reason},
                   help_="Flight-recorder triggers fired, by reason.")
        metric("minio_tpu_flight_bundles_written_total", st["bundles_written"],
               help_="Diagnostic bundles written to disk.")
        metric("minio_tpu_flight_bundles_pruned_total", st["bundles_pruned"],
               help_="Bundles removed by the retention cap.")
        metric("minio_tpu_flight_suppressed_total", st["suppressed"],
               help_="Trigger firings muted by the cooldown window.")
        metric("minio_tpu_flight_capture_errors_total", st["capture_errors"],
               help_="Bundle captures that raised (black box stayed up).")
        metric("minio_tpu_flight_fanout_errors_total", st["fanout_errors"],
               help_="Cluster fan-outs that raised (local bundle still wrote).")
        metric("minio_tpu_flight_last_trigger_time", st["last_trigger_time"],
               help_="Wall-clock time of the last trigger (0 = never).",
               type_="gauge")
        # Loss disclosure for every hub a watcher might tail: a grown counter
        # means the stream had holes the watcher could not see.
        hubs = [("trace", GLOBAL_TRACE.hub), ("audit", GLOBAL_LOGGER.audit_hub)]
        if self.notifier is not None:
            hubs.append(("listen", self.notifier.listen_hub))
        for name, hub in hubs:
            metric("minio_tpu_pubsub_dropped_total", getattr(hub, "dropped", 0),
                   {"hub": name},
                   help_="Records dropped on slow subscribers, by hub.")
        dropped = failed = sent = 0
        for t in GLOBAL_LOGGER.audit_targets:
            stats = getattr(t, "stats", None)
            if stats is None:
                continue
            row = stats()
            dropped += row.get("dropped", 0)
            failed += row.get("failed", 0)
            sent += row.get("sent", 0)
        metric("minio_tpu_audit_dropped_total", dropped,
               help_="Audit entries lost to a full webhook queue.")
        metric("minio_tpu_audit_failed_total", failed,
               help_="Audit entries that exhausted webhook retries.")
        metric("minio_tpu_audit_sent_total", sent,
               help_="Audit entries delivered to webhook targets.")

    def _render_san(self, metric) -> None:
        """Concurrency-sanitizer plane (control/sanitizer.py). Emitted only
        when the process runs armed (MTPU_TSAN=1) -- a production node never
        pays for, or exposes, these series."""
        from ..control import sanitizer

        if not sanitizer.armed():
            return
        rep = sanitizer.GLOBAL_SAN.report()
        by_rule: dict[str, int] = {}
        for f in rep["findings"]:
            by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
        for rule, n in sorted(by_rule.items()):
            metric("minio_tpu_san_findings_total", n, {"rule": rule},
                   help_="Sanitizer findings recorded this process, by rule.")
        metric("minio_tpu_san_lock_order_edges", rep["lock_order_edges"],
               help_="Distinct lock-order edges observed.", type_="gauge")
        for name, st in rep["lock_profile"].items():
            metric("minio_tpu_san_lock_acquisitions_total",
                   st["acquisitions"], {"lock": name},
                   help_="Sanitized lock acquisitions, by lock class.")
            metric("minio_tpu_san_lock_contended_total",
                   st["contended"], {"lock": name},
                   help_="Acquisitions that had to wait, by lock class.")
            metric("minio_tpu_san_lock_hold_seconds_total",
                   st["hold_s"], {"lock": name},
                   help_="Cumulative time held, by lock class.")
            metric("minio_tpu_san_lock_hold_seconds_max",
                   st["hold_max_s"], {"lock": name},
                   help_="Longest single hold, by lock class.", type_="gauge")
            metric("minio_tpu_san_lock_wait_seconds_total",
                   st["wait_s"], {"lock": name},
                   help_="Cumulative time spent waiting to acquire, by lock class.")

    def _render_bufsan(self, metric) -> None:
        """Buffer-lifetime sanitizer plane (control/bufsan.py). Emitted only
        when the process runs armed (MTPU_BUFSAN=1) -- a production node
        never pays for, or exposes, these series."""
        from ..control import bufsan

        if not bufsan.armed():
            return
        rep = bufsan.GLOBAL_BUFSAN.report()
        by_rule: dict[str, int] = {}
        for f in rep["findings"]:
            by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
        for rule, n in sorted(by_rule.items()):
            metric("minio_tpu_bufsan_findings_total", n, {"rule": rule},
                   help_="Buffer-lifetime findings recorded this process, by rule.")
        c = rep["counters"]
        metric("minio_tpu_bufsan_acquires_total", c["acquires"],
               help_="Sanitized pool acquisitions tracked.")
        metric("minio_tpu_bufsan_views_total", c["views"],
               help_="Sanitized view() exports tracked.")
        metric("minio_tpu_bufsan_sentinel_fills_total", c["sentinel_fills"],
               help_="Free-list storages sentinel-poisoned on recycle.")
        metric("minio_tpu_bufsan_sentinel_checks_total", c["sentinel_checks"],
               help_="Sentinel verifications run on re-acquire.")
        metric("minio_tpu_bufsan_poisoned_free_buffers", c["poisoned_free"],
               help_="Free-list storages currently carrying a sentinel.",
               type_="gauge")
        metric("minio_tpu_bufsan_live_handles", c["live_handles"],
               help_="PooledBuffer handles currently tracked live.",
               type_="gauge")

    def _render_memcache(self, metric) -> None:
        """Hot-read memory cache tier (object/memcache.py). Absent when the
        node runs without MTPU_MEMCACHE_MB -- no tier, no series."""
        mc = self.memcache
        if mc is None:
            return
        st = mc.stats()
        metric("minio_tpu_memcache_limit_bytes", st["limit_bytes"],
               help_="Configured memory cache budget.", type_="gauge")
        metric("minio_tpu_memcache_used_bytes", st["bytes"],
               help_="Bytes currently cached.", type_="gauge")
        metric("minio_tpu_memcache_entries", st["entries"],
               help_="Entries currently cached.", type_="gauge")
        metric("minio_tpu_memcache_hits_total", st["hits"],
               help_="Reads served from the memory cache.")
        metric("minio_tpu_memcache_misses_total", st["misses"],
               help_="Reads that fell through to the erasure layer.")
        metric("minio_tpu_memcache_fills_total", st["fills"],
               help_="Entries admitted after a miss.")
        metric("minio_tpu_memcache_evictions_total", st["evictions"],
               help_="Entries evicted to stay under budget.")
        metric("minio_tpu_memcache_invalidations_total", st["invalidations"],
               help_="Entries dropped by write-path or peer invalidation.")
        metric("minio_tpu_memcache_singleflight_waits_total",
               st["singleflight_waits"],
               help_="Concurrent misses that waited on an in-flight fill.")

    # -- cluster view --------------------------------------------------------

    def render_cluster(self) -> str:
        """Own node text plus every reachable peer's, each sample labeled
        server=<url> (the reference's /minio/v2/metrics/cluster role: one
        scrape sees the whole deployment). Unreachable peers surface as
        minio_tpu_node_scrape_ok 0 rather than silently vanishing."""
        texts: list[tuple[str, str, bool]] = [
            (self.node_url or "local", self.render_node(), True)
        ]
        notification = self.notification
        if notification is not None:
            for p in notification.peers:
                try:
                    texts.append((p.url, p.node_metrics(timeout=5.0), True))
                except Exception:  # noqa: BLE001 - peer down is data, not an error
                    texts.append((p.url, "", False))
        return merge_node_texts(texts)


def _label_sample(line: str, server: str) -> str:
    """Prefix a sample line's label set with server="...". """
    esc = server.replace("\\", "\\\\").replace('"', '\\"')
    name_end = len(line)
    for i, ch in enumerate(line):
        if ch in ("{", " "):
            name_end = i
            break
    name = line[:name_end]
    rest = line[name_end:]
    if rest.startswith("{"):
        return f'{name}{{server="{esc}",{rest[1:]}'
    return f'{name}{{server="{esc}"}}{rest}'


def merge_node_texts(texts: list[tuple[str, str, bool]]) -> str:
    """Merge per-node exposition texts: HELP/TYPE emitted once per series,
    every sample labeled with its origin server."""
    out: list[str] = []
    seen_meta: set[str] = set()
    for server, text, ok in texts:
        esc = server.replace("\\", "\\\\").replace('"', '\\"')
        if "minio_tpu_node_scrape_ok" not in seen_meta:
            out.append(
                "# HELP minio_tpu_node_scrape_ok 1 when the node's metrics were fetched."
            )
            out.append("# TYPE minio_tpu_node_scrape_ok gauge")
            seen_meta.add("minio_tpu_node_scrape_ok")
        out.append(f'minio_tpu_node_scrape_ok{{server="{esc}"}} {1 if ok else 0}')
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                # "# HELP <name> ..." / "# TYPE <name> ..." -- once per series.
                parts = line.split(None, 3)
                key = " ".join(parts[:3])
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
            else:
                out.append(_label_sample(line, server))
    return "\n".join(out) + "\n"


GLOBAL_METRICS = MetricsSys()
