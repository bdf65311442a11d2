"""Kernel 3's share of its roofline, in percent: the summed bound of its
launches in the traced batches (``portbench.lm_counts.k3_turn_bound_s``:
each row's live latent rows read once a layer a step, q read and the
output written, against its FLOPs at the bf16 peak) over the summed device
time of its attention and combine launches.  None where the batches ran
no kernel 3 (the parent of the change that brought it)."""

from portbench.metrics import roofline

NAMES = r"mla_decode_(attention|combine)_kernel"


def read(trace, works, cell):
    return roofline(trace, works, NAMES, "k3")
