"""The expert products' share of their roofline, in percent: the summed
bound of the ``moe_product_kernel`` launches (the gated up-projection and
the weighted down-projection) in the traced batches
(``portbench.lm_counts.moe_turn_bound_s``: each touched expert's weights
read once a launch, against the pairs' FLOPs at the bf16 peak) over their
summed device time."""

from portbench.metrics import roofline

NAMES = r"moe_product_kernel"


def read(trace, works, cell):
    return roofline(trace, works, NAMES, "moe_product")
