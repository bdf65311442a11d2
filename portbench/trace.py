"""The traced window: ``torch.profiler`` over a few batches, reduced to the
device's timeline and what the host did meanwhile.

``capture(run, n)`` runs ``run(j)`` for j < n, each batch inside a
``portbench.batch`` range, under the profiler, and returns a ``Trace``:

- ``device``: (name, start_us, end_us) of every kernel, copy and set on
  the device, by start;
- ``host``: (name, start_us, end_us) of the host's operations and ranges;
- ``batches``: the (start_us, end_us) of each batch's range;
- ``window_s``: the host clock's seconds over the traced batches, each
  ended by a synchronise;
- ``busy_s``: the seconds in which some operation ran on the device,
  within the batches;
- ``plain_s``: the host clock's seconds of each of the same batches run
  before, without the profiler (set by the run).

Per-layer readers (``portbench/metrics/<name>.py``) read a ``Trace``.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Callable, Optional

import torch

BATCH_RANGE = "portbench.batch"
TOP = 10


class Trace:
    def __init__(self, device: list, host: list, batches: list,
                 window_s: float):
        self.device, self.host, self.batches = device, host, batches
        self.window_s = window_s
        self.plain_s: list = []
        self.busy_s = sum(b - a for a, b in self.busy()) / 1e6

    def named(self, pattern: str) -> list:
        """Device operations whose name matches the regular expression."""
        rx = re.compile(pattern)
        return [ev for ev in self.device if rx.search(ev[0])]

    def busy(self, lo: Optional[float] = None, hi: Optional[float] = None
             ) -> list:
        """The union of the device's operations within [lo, hi] (by
        default the traced batches), as sorted (start, end) intervals."""
        if lo is None:
            lo, hi = self.batches[0][0], self.batches[-1][1]
        out = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def idle_us(self, lo: float, hi: float) -> float:
        return (hi - lo) - sum(b - a for a, b in self.busy(lo, hi))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing (the innermost host operation at a gap's
        middle), each summed by name, in seconds."""
        ops: dict = defaultdict(float)
        for name, a, b in self.device:
            ops[name[:120]] += (b - a) / 1e6
        starts = [ev[1] for ev in self.host]
        gaps: dict = defaultdict(float)
        lo, hi = self.batches[0][0], self.batches[-1][1]
        edge = lo
        for a, b in self.busy() + [[hi, hi]]:
            if a > edge:
                gaps[self.host_at((edge + a) / 2, starts)] += (a - edge) / 1e6
            edge = max(edge, b)
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}

    def host_at(self, t: float, starts: list) -> str:
        j = bisect.bisect_right(starts, t) - 1
        for _ in range(4096):
            if j < 0:
                break
            name, a, b = self.host[j]
            if b >= t and name != BATCH_RANGE:
                return name[:120]
            j -= 1
        return "harness (between operations)"


def _top(sums: dict) -> list:
    return [[name, s] for name, s in sorted(sums.items(),
                                           key=lambda kv: -kv[1])[:TOP]]


def capture(run: Callable[[int], object], n: int, device) -> tuple:
    """(results of ``run(j)`` for j < n, their ``Trace``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    results = []
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(n):
            with record_function(BATCH_RANGE):
                results.append(run(j))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev_events, host_events, batches = [], [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                dev_events.append(span)
        elif ev.name == BATCH_RANGE:
            batches.append(span[1:])
        else:
            host_events.append(span)
    dev_events.sort(key=lambda ev: ev[1])
    host_events.sort(key=lambda ev: ev[1])
    batches.sort()
    return results, Trace(dev_events, host_events, batches, window_s)
