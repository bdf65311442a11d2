"""The device's idle share of a batch, in percent: the traced batches'
busy seconds (kernels, copies and sets) against the seconds of the same
batches by the host clock without the profiler (``Trace.plain_s``), which
slows the launch of a CUDA graph by about 1.5 ms."""


def read(trace, works, cell):
    if not trace.plain_s or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / sum(trace.plain_s))
