"""The port's benchmark: one cell of ``BENCHMARK.json``, once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

A cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<traffic>.json``), whose ``driver`` names
the entry point's module (``portbench/drivers/<driver>.py``).  A run:

1. set-up: the driver builds the program's model with weights made on the
   card from the seed, and warms up the cell's one shape (every kernel
   built or loaded, every decode graph captured);
2. ``--trace 0``: the window: whole batches, fresh from the seed, back to
   back until ``--seconds`` have passed, each ended by its result's copy to
   the host and a synchronise; the traffic's ``rate_metric`` is every
   answered molecule over the time from the first batch's start to the
   last one's end.
   ``--trace 1``: instead the traffic's first ``trace_batches`` batches,
   once timed by the host clock alone (``Trace.plain_s``: the profiler
   slows a CUDA graph's launch) and once under ``torch.profiler``, read by
   each per-layer metric's reader (``portbench/metrics/<name>.py``);
3. the peak memory is read, the program's state freed, and the driver's
   comparison with the plain reference (``portbench/reference``) decides
   ``correct``;
4. the numbers compared and their limits go to standard error, then one
   JSON line to standard output.

It needs the cards the cell asks for: without them, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with another code than 0.  Build and kernel caches stay inside the
checkout, under ``build/``.
"""

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "spmm_tpu")


class RunError(Exception):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)


def load_json(root: str, *parts: str) -> dict:
    path = os.path.join(root, *parts)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise RunError(f"missing {os.path.relpath(path, root)}")


def load_module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` by path (a metric's name may hold
    dots); for a metric ``<base>.<cell>`` without a file of its own,
    ``<base>.py``."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if kind == "metrics" and not os.path.exists(path):
        path = os.path.join(root, "portbench", kind,
                            f"{name.split('.')[0]}.py")
    if not os.path.exists(path):
        raise RunError(f"missing portbench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (by default the
    process's), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn, x) -> float:
    """Host seconds of ``fn(x)``, ended by a synchronise."""
    sync(dev)
    t0 = time.perf_counter()
    fn(x)
    sync(dev)
    return time.perf_counter() - t0


def window(driver, traffic_mod, dev, seconds: float) -> tuple:
    """Whole batches back to back until ``seconds`` have passed: ([(i,
    result)], answered units, seconds from the first batch's start to the
    last one's end)."""
    sync(dev)
    batches, units = [], 0
    stamps = [time.perf_counter()]
    while True:
        i = len(batches)
        res = driver.run(driver.inputs(traffic_mod.WINDOW, i)[1])
        sync(dev)
        batches.append((i, res))
        units += driver.units(res)
        stamps.append(time.perf_counter())
        if stamps[-1] - stamps[0] >= seconds:
            each = sorted(b - a for a, b in zip(stamps, stamps[1:]))
            print(f"portbench: {len(each)} batches, seconds min "
                  f"{each[0]:.4f} median {each[len(each) // 2]:.4f} max "
                  f"{each[-1]:.4f}", file=sys.stderr)
            return batches, units, stamps[-1] - stamps[0]


def passes(checks: list) -> bool:
    """Every number compared lies within its limit."""
    return all(limit is not None and value <= limit
               for _, value, limit in checks)


def run(args, root: str, device=None) -> dict:
    bench = load_json(root, "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    config = load_json(root, "portbench", "configs", f"{cell['config']}.json")
    traffic = load_json(root, "portbench", "traffic",
                        f"{cell['traffic']}.json")
    cache_dirs(root)
    dev = device if device is not None else require_cards(cell["chips"])
    import torch

    from portbench import trace as trace_mod
    from portbench import traffic as traffic_mod

    try:
        import spmm_tpu_torch  # noqa: F401
    except ImportError as err:
        raise RunError(f"the program (spmm_tpu_torch) is not here: {err}")
    driver = load_module(root, "drivers", traffic["driver"]).Driver(
        config, traffic, args.seed, dev)
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in reported(bench["per_layer"], cell["name"])}
    t_setup = time.monotonic()
    driver.setup()
    sync(dev)
    print(f"portbench: imports {t_setup - _T0:.3f} s, driver set-up "
          f"{time.monotonic() - t_setup:.3f} s", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - _T0
    values, device_info, breakdown = {}, {}, None
    if args.trace:
        n = traffic["trace_batches"]
        plain_s = [timed(dev, driver.run, driver.inputs(traffic_mod.WINDOW,
                                                        j)[1])
                   for j in range(n)]
        results, trace = trace_mod.capture(
            lambda j: driver.run(driver.inputs(traffic_mod.WINDOW, j)[1]),
            n, dev)
        trace.plain_s = plain_s
        batches = list(enumerate(results))
        works = [driver.work(driver.inputs(traffic_mod.WINDOW, i)[0], res)
                 for i, res in batches]
        for name, reader in readers.items():
            value = reader.read(trace, works, cell)
            if value is None:
                print(f"portbench: no reading for {name}", file=sys.stderr)
            else:
                values[name] = value
        device_info = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        breakdown = trace.breakdown()
        units = sum(driver.units(res) for _, res in batches)
    else:
        batches, units, wall = window(driver, traffic_mod, dev, args.seconds)
        values = {"setup_s": setup_s, traffic["rate_metric"]: units / wall}
    attempted = len(batches) * traffic["batch"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    driver.free()
    checks = driver.check(batches)
    bad = forbidden_loaded()
    if bad:
        raise RunError(f"loaded in the run's process: {', '.join(bad)}", 4)
    correct = passes(checks) and units == attempted
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    wanted = (bench["per_layer"] if args.trace else bench["end_to_end"])
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in reported(wanted, cell["name"]) if m["name"] in values}
    if not args.trace:
        missing = [m["name"] for m in reported(wanted, cell["name"])
                   if m["name"] not in values]
        if missing:
            raise RunError(f"no value for {', '.join(missing)}", 3)
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": attempted - units, "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": cell["chips"], "memory_peak_bytes": int(peak),
                       **device_info}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return line


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: str = ROOT, device=None) -> int:
    args = parse(argv)
    sys.path.insert(0, root)
    try:
        line = run(args, root, device)
    except RunError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return err.code
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
