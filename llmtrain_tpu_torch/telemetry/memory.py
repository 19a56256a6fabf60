"""Device + host memory accounting for the telemetry subsystem (the port's
copy of ``llmtrain_tpu/telemetry/memory.py``).

The monitor samples at every log interval:

* ``mem/hbm_used`` / ``mem/hbm_peak`` / ``mem/hbm_limit`` from the CUDA
  caching allocator (``torch.cuda.memory_stats``: ``allocated_bytes.all``
  current and peak; the limit is the card's total memory), ``mem/source``
  ``"memory_stats"`` in the report. ``mem/live_arrays`` /
  ``mem/live_array_bytes`` are the allocator's live blocks and their bytes
  (``active.all.current``, ``active_bytes.all.current``), the counterpart
  of JAX's live ``jax.Array`` walk;
* on the CPU there is no allocator to read and no live-tensor inventory
  short of walking the garbage collector, which the monitor does not do at
  every interval: the device figures are the process's resident set
  (source ``"host_rss"``) and the live-array gauges read 0;
* ``mem/host_rss`` / ``mem/host_rss_peak`` from /proc/self (Linux) with a
  ``resource.getrusage`` fallback, as JAX reads them;
* a **headroom warning channel**: when used/limit crosses
  ``headroom_warn_frac`` the monitor logs a warning and records a
  ``hbm_headroom`` instant on the timeline — once per excursion, so a run
  sitting at 95% does not spam every interval.
"""

from __future__ import annotations

from typing import Any

import torch

from ..utils.logging import get_logger

logger = get_logger()


def _device_memory_stats(device: torch.device) -> dict[str, float] | None:
    """The CUDA allocator's counters for ``device`` under JAX's key names
    (bytes_in_use, peak_bytes_in_use, bytes_limit) plus the live blocks, or
    None off the card or when the allocator has not started."""
    if device.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:  # noqa: BLE001 — accounting must not kill the run it measures
        return None
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(limit),
        "live_blocks": float(stats.get("active.all.current", 0)),
        "live_bytes": float(stats.get("active_bytes.all.current", 0)),
    }


def _host_rss_bytes() -> tuple[float, float]:
    """(current RSS, peak RSS) in bytes; 0.0 when unreadable."""
    current = 0.0
    peak = 0.0
    try:
        with open("/proc/self/status", encoding="ascii", errors="ignore") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    current = float(line.split()[1]) * 1024.0
                elif line.startswith("VmHWM:"):
                    peak = float(line.split()[1]) * 1024.0
    except OSError:
        pass
    if peak == 0.0:
        try:
            import resource

            # ru_maxrss is KiB on Linux.
            peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
        except Exception:  # noqa: BLE001
            pass
    return current, max(peak, current)


class MemoryMonitor:
    """Interval-cadence sampler producing ``mem/*`` metrics + peaks.
    ``device`` is the run's device (the CPU when None)."""

    def __init__(
        self,
        *,
        headroom_warn_frac: float = 0.92,
        timeline: Any | None = None,  # EventTimeline; Any avoids the cycle
        device: torch.device | None = None,
    ) -> None:
        self._warn_frac = headroom_warn_frac
        self._timeline = timeline
        self._device = device if device is not None else torch.device("cpu")
        self._peak_hbm = 0.0
        self._peak_rss = 0.0
        self._peak_live_bytes = 0.0
        self._source = "unsampled"
        self._in_excursion = False
        self.headroom_warnings = 0
        self._opt_state: dict[str, float] = {}
        self._activations: dict[str, float] = {}

    @property
    def source(self) -> str:
        """Which estimator produced hbm numbers: memory_stats | host_rss."""
        return self._source

    def sample(self, step: int | None = None) -> dict[str, float]:
        """One metrics sample. Never raises — memory accounting must not be
        able to kill the run it measures."""
        out: dict[str, float] = {}
        stats = _device_memory_stats(self._device)
        live_count = stats["live_blocks"] if stats is not None else 0.0
        live_bytes = stats["live_bytes"] if stats is not None else 0.0
        self._peak_live_bytes = max(self._peak_live_bytes, live_bytes)
        out["mem/live_arrays"] = live_count
        out["mem/live_array_bytes"] = live_bytes

        rss, rss_peak = _host_rss_bytes()
        if rss:
            out["mem/host_rss"] = rss
        self._peak_rss = max(self._peak_rss, rss_peak, rss)
        if self._peak_rss:
            out["mem/host_rss_peak"] = self._peak_rss

        limit = 0.0
        if stats is not None:
            self._source = "memory_stats"
            used = stats["bytes_in_use"]
            peak = stats["peak_bytes_in_use"] or used
            limit = stats["bytes_limit"]
        else:
            # CPU: the process's resident set stands in for device memory.
            self._source = "host_rss"
            used = rss
            peak = rss_peak
        self._peak_hbm = max(self._peak_hbm, peak, used)
        out["mem/hbm_used"] = used
        out["mem/hbm_peak"] = self._peak_hbm
        if limit > 0:
            out["mem/hbm_limit"] = limit
            frac = used / limit
            out["mem/hbm_used_frac"] = frac
            self._check_headroom(frac, used, limit, step)
        return out

    def _check_headroom(
        self, frac: float, used: float, limit: float, step: int | None
    ) -> None:
        if frac >= self._warn_frac and not self._in_excursion:
            self._in_excursion = True
            self.headroom_warnings += 1
            logger.warning(
                "HBM headroom low: %.1f%% of the device limit in use "
                "(%.2f / %.2f GiB) — above the %.0f%% warning threshold; "
                "an OOM here kills the whole step, consider remat/chunked CE "
                "or a smaller micro batch",
                100.0 * frac,
                used / 2**30,
                limit / 2**30,
                100.0 * self._warn_frac,
            )
            if self._timeline is not None:
                self._timeline.instant(
                    "hbm_headroom",
                    cat="memory",
                    step=step,
                    used_frac=round(frac, 4),
                    bytes_in_use=used,
                    bytes_limit=limit,
                )
        elif frac < self._warn_frac:
            self._in_excursion = False

    def record_opt_state(self, info: dict[str, float]) -> None:
        """Static optimizer-state footprint (the trainer's
        ``_opt_state_memory``): ``opt_state_bytes`` (logical total),
        ``opt_state_bytes_per_device`` (resident on the card),
        ``opt_state_bytes_host`` (held on the host). Merged into the
        report's memory block."""
        self._opt_state = {k: float(v) for k, v in info.items()}

    def record_activations(self, info: dict[str, float]) -> None:
        """Analytic activation footprint (``activation_bytes``,
        ``activation_bytes_offloaded``). Merged into the report's memory
        block like the opt-state block."""
        self._activations = {k: float(v) for k, v in info.items()}

    def peaks(self) -> dict[str, float]:
        """End-of-run summary block for the report."""
        out = {
            "hbm_peak_bytes": self._peak_hbm,
            "host_rss_peak_bytes": self._peak_rss,
            "live_array_peak_bytes": float(self._peak_live_bytes),
            "headroom_warnings": float(self.headroom_warnings),
        }
        out.update(self._opt_state)
        out.update(self._activations)
        return out


__all__ = ["MemoryMonitor"]
