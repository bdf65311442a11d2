"""Drivers: one module an entry point of the program, named by a traffic
mix's ``driver`` key.  A driver module defines ``Driver(config, traffic,
seed, device, control=None)`` with:

- ``setup()``: the program's model with the benchmark's weights, and a
  warm-up batch of the cell's one shape (stream 0);
- ``inputs(stream, i)``: batch ``i`` of the traffic as host arrays, and
  what the entry point takes on the device;
- ``run(x)``: the entry point over one batch, its result on the host;
- ``units(result)``: molecules or reactions the result answers;
- ``work(host, result)``: the batch's needed FLOPs and kernel bounds
  (``portbench.counts``), for the per-layer readers;
- ``free()``: drop the program's state;
- ``check(batches, extra=False)``: the comparison with the plain
  reference, over a sample of the window's batches [(i, result)], as
  ``[(name, value, limit)]``.

The window's rate is the traffic's ``rate_metric``.

``control`` puts a lower precision in the program's place, for the
calibration of the limits and the control tests (``portbench.calibrate``);
the benchmark's runs never set it.
"""
