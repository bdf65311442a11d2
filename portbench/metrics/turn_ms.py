"""Device milliseconds a batch of the turn's prefill, read from the
program's spans and the device's timeline: for each ``spmm.lm.prefill``
span, from the first device operation that starts after the span opens to
the first that starts after the first ``cudaGraphLaunch`` that follows it
(the first decode graph).  The host runs ahead of the device, so the span's
own end is not the prefill's.  None where there is no such span or no
graph launch after it."""

import bisect

PREFILL = "spmm.lm.prefill"
LAUNCH = "cudaGraphLaunch"


def read(trace, works, cell):
    spans = sorted(a for name, a, _ in trace.host if name == PREFILL)
    launches = sorted(a for name, a, _ in trace.host
                      if name.startswith(LAUNCH))
    starts = [a for _, a, _ in trace.device]
    out = []
    for a in spans:
        j = bisect.bisect_left(launches, a)
        first = bisect.bisect_left(starts, a)
        if j == len(launches) or first == len(starts):
            continue
        graph = bisect.bisect_left(starts, launches[j])
        if graph < len(starts):
            out.append(starts[graph] - starts[first])
    if not out:
        return None
    return sum(out) / 1e3 / len(out)
