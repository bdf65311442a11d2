"""Device-time breakdown of one call under ``torch.profiler``.

Counterpart of ``spmm_tpu.utils.profiling`` for the CUDA port: how much of
a call's wall time the device spends in kernels (its busy share), and which
kernels take that time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable

import torch


def device_breakdown(fn: Callable[[], object], top: int = 8) -> dict:
    """Run ``fn`` once under the profiler (the caller warms it up first).

    Returns the wall time, the summed duration of the device's kernels,
    memcpys and memsets (one stream, so they do not overlap), their share
    of the wall time, and the ``top`` kernels by device time.  Annotated
    ranges on the device's timeline (``Optimizer.step``'s, around the
    optimizer's kernels) are not counted.  With no device events in the
    trace the device numbers are None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        entry = per_name[ev.name]
        entry[0] += ev.time_range.elapsed_us()
        entry[1] += 1
    busy_us = sum(us for us, _ in per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6 if per_name else None,
        "busy_share": busy_us / 1e6 / wall if per_name else None,
        "device_events": sum(n for _, n in per_name.values()),
        "top": [{"name": name[:90], "ms": us / 1e3, "count": n}
                for name, (us, n) in ranked],
    }
