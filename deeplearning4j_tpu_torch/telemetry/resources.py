"""Resource watermarks: host RSS and the card's allocated bytes, current
and peak, sampled per report window. The port of
`deeplearning4j_tpu/telemetry/resources.py`: on a CUDA device the bytes
come from `torch.cuda.memory_stats` (the caching allocator's
`allocated_bytes.all.current`) and `torch.cuda.max_memory_allocated`; on
the CPU only the process RSS is sampled. Both are host reads with no
device sync.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

try:
    import resource as _resource
except ImportError:  # Windows has no stdlib resource module
    _resource = None

__all__ = ["ResourceWatermarks", "host_rss_mb", "host_peak_rss_mb",
           "device_memory"]

# ru_maxrss units differ: Linux reports KiB, macOS reports bytes
_MAXRSS_TO_MB = (1024.0 * 1024.0) if sys.platform == "darwin" else 1024.0


def host_peak_rss_mb() -> float:
    """Peak RSS of this process (0.0 where getrusage is unavailable)."""
    if _resource is None:
        return 0.0
    return (_resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
            / _MAXRSS_TO_MB)


def host_rss_mb() -> float:
    """Current RSS; falls back to the peak where /proc is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0)
    except Exception:
        return host_peak_rss_mb()


def device_memory(index: int) -> Optional[Dict[str, int]]:
    """{"bytes": allocated now, "peak": most allocated} of CUDA device
    `index`, or None where the device has no statistics."""
    import torch
    try:
        stats = torch.cuda.memory_stats(index)
        peak = int(torch.cuda.max_memory_allocated(index))
    except Exception:
        return None
    if not stats:
        return None
    return {"bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": peak}


def _cuda_devices():
    import torch
    if not torch.cuda.is_available():
        return ()
    return tuple(range(torch.cuda.device_count()))


class ResourceWatermarks:
    def __init__(self, registry):
        self._rss = registry.gauge(
            "dl4j_host_rss_mb", "host resident set size (MiB)")
        self._rss_peak = registry.gauge(
            "dl4j_host_rss_peak_mb", "peak host RSS (MiB)")
        self._dev = registry.gauge(
            "dl4j_device_bytes_in_use", "allocated device bytes",
            labels=("device",))
        self._dev_peak = registry.gauge(
            "dl4j_device_bytes_peak", "peak allocated device bytes",
            labels=("device",))

    def sample(self, devices=None) -> Dict:
        """Update the gauges (and peaks) and return the sample. `devices`
        (CUDA device indices) defaults to every visible card; without a
        card there is no device series."""
        rss = host_rss_mb()
        peak = host_peak_rss_mb()
        self._rss.set(rss)
        self._rss_peak.set_max(max(peak, rss))
        out = {"host_rss_mb": round(rss, 2),
               "host_rss_peak_mb": round(max(peak, rss), 2)}
        for dev in (_cuda_devices() if devices is None else devices):
            mem = device_memory(dev)
            if mem is None:
                continue
            key = str(dev)
            self._dev.set(mem["bytes"], device=key)
            self._dev_peak.set_max(max(mem["peak"], mem["bytes"]),
                                   device=key)
            out[f"device{key}_bytes"] = mem["bytes"]
            out[f"device{key}_peak_bytes"] = mem["peak"]
        return out

    def peak_rss_mb(self) -> float:
        return self._rss_peak.value()
