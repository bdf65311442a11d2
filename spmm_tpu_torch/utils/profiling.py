"""Profiling hooks (counterpart of ``spmm_tpu.utils.profiling`` for the CUDA
port).

``span`` (``utils/spans.py``) names a part of the program's work as a
range of the ``torch.profiler`` trace, while one is collecting.
``device_breakdown`` runs one call under ``torch.profiler``: how much of
its wall time the device spends in kernels (its busy share), and which
kernels take that time.  ``trace`` exports a ``torch.profiler`` trace of a
block; ``count_flops`` counts a call's FLOPs (``FlopCounterMode``) and
``mfu`` sets a step's FLOP rate against the H100's published peak for the
dtype that runs.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Callable, Optional

import torch

from spmm_tpu_torch.utils.spans import span  # noqa: F401

# published dense peaks of one H100 SXM (NVIDIA's data sheet): fp32 on the
# CUDA cores (TF32 off, as the port keeps it), bf16 on the tensor cores
H100_PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}

def count_flops(fn: Callable[[], object]) -> tuple[object, float]:
    """(``fn()``, the FLOPs it ran, its backward too if it calls one), by
    ``torch.utils.flop_counter.FlopCounterMode``: matmuls, convolutions
    and attention; elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, float(counter.get_total_flops())


def mfu(flops_per_step: Optional[float], step_time_s: float,
        n_chips: int = 1, peak_per_chip: float = H100_PEAK_FLOPS["fp32"]
        ) -> Optional[float]:
    """Model FLOPs utilization of a measured step (None if flops unknown)."""
    if not flops_per_step or not step_time_s or step_time_s <= 0:
        return None
    return flops_per_step / step_time_s / (n_chips * peak_per_chip)


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, else the name alone."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU and CUDA trace of the block into ``log_dir`` as a
    Chrome trace (``with trace('prof'): step(...)``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
