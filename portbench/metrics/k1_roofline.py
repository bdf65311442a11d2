"""Kernel 1's share of its roofline, in percent: the summed bound of its
launches in the traced batches (``portbench.counts.k1_launch``) over their
summed device time."""

from portbench.metrics import roofline

NAMES = r"beam_decode_attention_kernel"


def read(trace, works, cell):
    return roofline(trace, works, NAMES, "k1")
