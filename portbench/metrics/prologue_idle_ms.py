"""The device's idle time in an entry point's prologue, in milliseconds a
batch, read from the program's spans: from the start of each root span
(``spmm.<entry point>.batch``: the encoder, the cross K/V, the decode
state's load) to the start of the ``spmm.decode.loop`` inside it.  None
where the trace holds no device work or no root span with a loop."""

import re

ROOT = re.compile(r"^spmm\.\w+\.batch$")
LOOP = "spmm.decode.loop"


def read(trace, works, cell):
    roots = [(a, b) for name, a, b in trace.host if ROOT.match(name)]
    loops = sorted(a for name, a, _ in trace.host if name == LOOP)
    idle = []
    for lo, hi in roots:
        start = next((a for a in loops if lo <= a <= hi), None)
        if start is not None:
            idle.append(trace.idle_us(lo, start))
    if not trace.device or not idle:
        return None
    return sum(idle) / 1e3 / len(idle)
