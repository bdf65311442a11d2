"""Device milliseconds a batch in the expert layers: routing, dispatch,
expert products and the pairs' sum.  An expert layer's routed part runs on
one stream from the router's kernel (``moe_route_kernel``) to the pairs'
sum (``moe_combine_kernel``); between them lie the dispatch's small
PyTorch operations (``ops.moe._align``) and the two ``moe_product_kernel``
launches.  Every device operation from each router kernel's start to the
end of the next sum kernel is counted.  The shared experts run before the
router, on library GEMMs (``gemm_ms``), and are not counted.  None where
the trace holds no such pair of kernels."""

import bisect
import re

FIRST = re.compile(r"moe_route_kernel")
LAST = re.compile(r"moe_combine_kernel")


def read(trace, works, cell):
    device = sorted(trace.device, key=lambda ev: ev[1])
    starts = [a for _, a, _ in device]
    ends = [b for name, _, b in device if LAST.search(name)]
    total, layers = 0.0, 0
    for i, (name, a, _) in enumerate(device):
        if not FIRST.search(name):
            continue
        j = bisect.bisect_left(ends, a)
        if j == len(ends):
            continue
        stop = bisect.bisect_left(starts, ends[j], lo=i)
        total += sum(min(eb, ends[j]) - ea for _, ea, eb in device[i:stop])
        layers += 1
    if not layers or not trace.batches:
        return None
    return total / 1e3 / len(trace.batches)
