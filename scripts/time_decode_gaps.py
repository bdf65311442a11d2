#!/usr/bin/env python3
"""Time a benchmark cell's decode steps without the profiler, and
optionally keep the same cell's traced window for reading offline.

    python3 scripts/time_decode_gaps.py --workload <cell> --seed <n>
        [--batches N] [--dump PATH.json.gz]

The cell is one of ``BENCHMARK.json``'s decode cells (a ``portbench``
driver that runs ``inference/decoding.py``'s graphs).  Its driver is built
and warmed up as ``portbench.run`` does it; then N batches (default 4) run
with the host clock read around each ``torch.cuda.CUDAGraph.replay`` (the
graph's launch) and each stop test (``_Decode.stopped``, the synchronising
read), and CUDA events recorded around each replay.  For every step after
the first it prints, in microseconds, the median and mean of:

- ``between``: the device's time from one graph's end to the next one's
  start (CUDA events), the per-step gap that the decode loop leaves;
- ``graph``: one replayed graph on the device;
- ``py_before``: the host from the stop test's return to the next launch;
- ``launch``: the host inside the launch;
- ``py_after``: the host from the launch's return to the stop test;
- ``stop``: the host inside the stop test (mostly waiting for the graph);
- ``period``: one step on the host clock;

and, a batch, its wall (a synchronise before and after), its graphs' device
time and its gaps between graphs (``batch_ms``, in milliseconds), so that
the wall less both is the batch's time outside the loop's graphs and gaps:
the prologue on the device and its idle, the result, the copy to the host
and detokenization; and what a ``span`` costs a call on this host, with
the profiler off and on (``span_us``).

With ``--dump``, the cell's ``trace_batches`` then run under
``portbench.trace.capture`` and the ``Trace`` is written as gzipped JSON
(``names``; ``device`` and ``host`` as [name index, start_us, end_us];
``batches``; ``window_s``; ``plain_s``, the same batches timed before
without the profiler), with each reader's value of the cell's
per-layer metrics printed.  Prints the card's name and power limit first.
Needs CUDA; run from the repo's root.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("between", "graph", "py_before", "launch", "py_after", "stop",
         "period")


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def timed_steps(run, batches: list) -> tuple:
    """Per-step parts (seconds) of ``run(x)`` for x in ``batches``, and
    per batch its wall, its graphs' device time and its gaps between
    graphs."""
    import torch

    from spmm_tpu_torch.inference import decoding

    log, events = [], []

    def on_clock(kind):
        def wrap(fn):
            def inner(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                log.append((kind, t0, time.perf_counter()))
                return out
            return inner
        return wrap

    def with_events(fn):
        def inner(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            events.append((e0, e1))
            return out
        return inner

    parts = {k: [] for k in PARTS}
    per_batch = {"wall": [], "graphs": [], "between": []}
    with patched(torch.cuda.CUDAGraph, "replay", on_clock("launch")), \
            patched(decoding._Decode, "stopped", on_clock("stop")), \
            patched(decoding.DecodeGraphs, "_replay", with_events):
        for x in batches:
            log.clear()
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(x)
            torch.cuda.synchronize()
            per_batch["wall"].append(time.perf_counter() - t0)
            launches = [e for e in log if e[0] == "launch"]
            stops = [e for e in log if e[0] == "stop"]
            for t in range(1, min(len(stops), len(launches))):
                parts["py_before"].append(launches[t][1] - stops[t - 1][2])
                parts["launch"].append(launches[t][2] - launches[t][1])
                parts["py_after"].append(stops[t][1] - launches[t][2])
                parts["stop"].append(stops[t][2] - stops[t][1])
                parts["period"].append(stops[t][2] - stops[t - 1][2])
            graphs = [a.elapsed_time(b) / 1e3 for a, b in events]
            between = [events[j][1].elapsed_time(events[j + 1][0]) / 1e3
                       for j in range(len(events) - 1)]
            parts["graph"] += graphs
            parts["between"] += between
            per_batch["graphs"].append(sum(graphs))
            per_batch["between"].append(sum(between))
    return parts, per_batch


def span_cost() -> dict:
    """Microseconds a ``span`` costs, entered and left: with the profiler
    off, under ``torch.profiler`` (CPU and CUDA), and the loop's own cost
    with the shared no-op entered directly."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spmm_tpu_torch.utils import spans

    def per(n: int, named: bool) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                with (spans.span("spmm.cost") if named else spans._OFF):
                    pass
            best = min(best, (time.perf_counter() - t0) / n)
        return best * 1e6

    out = {"loop": per(100_000, False), "off": per(100_000, True)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["on"] = per(5_000, True)
    return {k: round(v, 3) for k, v in out.items()}


def dump(trace, path: str) -> None:
    names: dict = {}

    def rows(evs):
        return [[names.setdefault(n, len(names)), a, b] for n, a, b in evs]

    out = {"device": rows(trace.device), "host": rows(trace.host),
           "batches": trace.batches, "window_s": trace.window_s,
           "plain_s": trace.plain_s}
    out["names"] = sorted(names, key=names.get)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(out, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=4,
                    help="batches timed without the profiler; 0 skips them, "
                    "so that a dump's window follows set-up as in "
                    "portbench.run")
    ap.add_argument("--dump")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    import torch

    from portbench import run as prun
    from portbench import trace as trace_mod
    from portbench import traffic as traffic_mod

    bench = prun.load_json(ROOT, "BENCHMARK.json")
    cell = prun.cell_of(bench, args.workload)
    config = prun.load_json(ROOT, "portbench", "configs",
                            f"{cell['config']}.json")
    traffic = prun.load_json(ROOT, "portbench", "traffic",
                             f"{cell['traffic']}.json")
    prun.cache_dirs(ROOT)
    dev = torch.device("cuda", 0)
    driver = prun.load_module(ROOT, "drivers", traffic["driver"]).Driver(
        config, traffic, args.seed, dev)
    driver.setup()
    if args.batches:
        inputs = [driver.inputs(traffic_mod.WINDOW, j)[1]
                  for j in range(args.batches)]
        parts, per_batch = timed_steps(driver.run, inputs)
        print(json.dumps({
            "workload": args.workload, "seed": args.seed,
            "batches": args.batches, "steps": len(parts["between"]),
            "median_us": {k: round(statistics.median(v) * 1e6, 1)
                          for k, v in parts.items()},
            "mean_us": {k: round(statistics.mean(v) * 1e6, 1)
                        for k, v in parts.items()},
            "batch_ms": {k: [round(x * 1e3, 3) for x in v]
                         for k, v in per_batch.items()},
            "span_us": span_cost()}), flush=True)
    if args.dump:
        n = traffic["trace_batches"]
        plain_s = [prun.timed(dev, driver.run,
                              driver.inputs(traffic_mod.WINDOW, j)[1])
                   for j in range(n)]
        results, trace = trace_mod.capture(
            lambda j: driver.run(driver.inputs(traffic_mod.WINDOW, j)[1]),
            n, dev)
        trace.plain_s = plain_s
        dump(trace, args.dump)
        works = [driver.work(driver.inputs(traffic_mod.WINDOW, j)[0], res)
                 for j, res in enumerate(results)]
        readings = {}
        for m in prun.reported(bench["per_layer"], cell["name"]):
            reader = prun.load_module(ROOT, "metrics", m["name"])
            readings[m["name"]] = reader.read(trace, works, cell)
        print(json.dumps({"traced": readings}), flush=True)


if __name__ == "__main__":
    main()
