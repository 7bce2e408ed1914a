"""Device profiling: the card's memory gauges.

The part of the reference's ``runtime/devprof.py`` that the metrics plane
reads.  ``run --metrics-out`` registers :func:`device_memory_gauges` as
the ``device_mem`` sampler, bound to the run's device, so every snapshot
carries the card's memory in use, its peak and its total.  The bounded
capture window with per-stage attribution (``--devprof-out``) is not
ported yet (ROADMAP A5).
"""

from __future__ import annotations

#: the gauge keys, as the reference names them
GAUGE_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_gauges(device=None) -> dict:
    """``device_mem_bytes_in_use`` / ``_peak_bytes_in_use`` / ``_bytes_limit``.

    On a CUDA device: the caching allocator's allocated bytes now and at
    their peak (``torch.cuda.memory_stats``) and the card's total memory.
    The device is named explicitly, never taken from the calling thread's
    current device (the sampler runs on the ``ra-metrics`` thread), and
    nothing here synchronises a stream.  On the CPU (``device`` None or a
    CPU device) all three are None, as the reference gives on XLA:CPU: a
    dashboard shows "unsupported", never a fake zero.
    """
    if device is None:
        return {f"device_mem_{k}": None for k in GAUGE_KEYS}
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {f"device_mem_{k}": None for k in GAUGE_KEYS}
    if device.index is None:
        raise ValueError("device_memory_gauges needs an indexed CUDA device (cuda:N)")
    stats = torch.cuda.memory_stats(device)
    return {
        "device_mem_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "device_mem_peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "device_mem_bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
