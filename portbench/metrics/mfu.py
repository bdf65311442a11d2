"""The whole batch's share of the chip's peak, in percent: the batches'
needed FLOPs (``portbench.counts``) over their seconds by the host clock
without the profiler (``Trace.plain_s``), over the peak of the cell's
stated dtype."""


def read(trace, works, cell):
    if not works or not trace.plain_s:
        return None
    flops = sum(w["model_flops"] for w in works)
    return 100.0 * flops / sum(trace.plain_s) / works[0]["peak_flops"]
