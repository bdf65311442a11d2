"""Readings for the limits of a cell's comparison, on the card: the
program on many seeds and its lower-precision controls on a few, each over
a short window of the cell's own batches, all in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--controls kv_fp8] [--batches 2]
        [--out chiprun_out/calibrate.jsonl]

For each seed it runs ``--batches`` window batches of the cell through the
driver, frees the program's state and prints the driver's comparison, with
the calibration's further readings (``check(extra=True)``), as one JSON
line.  A control runs the same way on ``--control-seeds``: ``kv_fp8`` (the
program's e4m3 KV cache), ``ref_fp8`` (the reference's search in e4m3 in
the program's place), ``tf32`` (the program with TF32 products), or a fault
planted in the program (``FAULTS``).  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from portbench.run import ROOT, cache_dirs, cell_of, load_json, load_module


@contextlib.contextmanager
def drop_score():
    """A k-beam search that drops each parent's summed score: every step
    after the first ranks and scores candidates by their own
    log-probability alone."""
    from spmm_tpu_torch.inference import decoding

    step = decoding._BeamDecode.step

    def faulty(self, pos, attention=None):
        if pos > 0:
            self.logp.zero_()
        return step(self, pos, attention)

    decoding._BeamDecode.step = faulty
    try:
        yield
    finally:
        decoding._BeamDecode.step = step


FAULTS = {"drop_score": drop_score}


def readings(driver, n_batches: int, traffic_mod) -> list:
    driver.setup()
    batches = [(i, driver.run(driver.inputs(traffic_mod.WINDOW, i)[1]))
               for i in range(n_batches)]
    driver.free()
    return driver.check(batches, extra=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    config = load_json(ROOT, "portbench", "configs", f"{cell['config']}.json")
    traffic = load_json(ROOT, "portbench", "traffic",
                        f"{cell['traffic']}.json")
    cache_dirs(ROOT)
    import torch

    from portbench import traffic as traffic_mod

    dev = torch.device("cuda", 0)
    driver_mod = load_module(ROOT, "drivers", traffic["driver"])
    runs = [(None, int(s)) for s in args.seeds.split(",")]
    for control in filter(None, args.controls.split(",")):
        runs += [(control, int(s)) for s in args.control_seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for control, seed in runs:
        t0 = time.perf_counter()
        fault = FAULTS.get(control, contextlib.nullcontext)
        with fault():
            checks = readings(driver_mod.Driver(
                config, traffic, seed, dev,
                None if control in FAULTS else control), args.batches,
                traffic_mod)
        line = {"workload": cell["name"], "control": control, "seed": seed,
                "batches": args.batches, "seconds": time.perf_counter() - t0,
                **{name: value for name, value, _ in checks}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    sys.exit(main())
