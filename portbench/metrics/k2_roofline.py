"""Kernel 2's share of its roofline, in percent, over its three entry
points: the summed bound of its launches in the traced batches
(``portbench.counts.k2_launch``) over their summed device time."""

from portbench.metrics import roofline

NAMES = r"fused_mha(_long|_stream)?_kernel"


def read(trace, works, cell):
    return roofline(trace, works, NAMES, "k2")
