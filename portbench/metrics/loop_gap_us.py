"""The host's time a decoder step from the stop test's read coming back to
the next graph's launch, in microseconds: the part of the device's gap
between two graphs that the decode loop's own Python takes (its
bookkeeping, the next step's feed, the launch's preparation).

Read on the host's clock alone, from the program's spans and the CUDA
runtime's ranges: for each ``spmm.decode.stop_test`` of a traced
``spmm.decode.loop`` that a step follows, from the end of the last
``cudaStreamSynchronize`` inside it to the start of the first
``cudaGraphLaunch`` inside the next ``spmm.decode.step``; the median over
those steps.  The profiler slows both calls (a launch by about 1.5 ms, a
synchronise's return by up to 0.5 ms, by the run) and the trace can place
the device's clock a millisecond off the host's, so neither call and no
device idle time is read.  None where no step holds a graph launch."""

import bisect
import statistics

LOOP, STEP = "spmm.decode.loop", "spmm.decode.step"
STOP = "spmm.decode.stop_test"
LAUNCH, SYNC = "cudaGraphLaunch", "cudaStreamSynchronize"


def within(ranges: list, lo: float, hi: float) -> list:
    """The ranges (sorted by start) that start within [lo, hi]."""
    starts = [a for a, _ in ranges]
    return ranges[bisect.bisect_left(starts, lo):
                  bisect.bisect_right(starts, hi)]


def read(trace, works, cell):
    ranges = {LOOP: [], STEP: [], STOP: [], LAUNCH: [], SYNC: []}
    for name, a, b in trace.host:
        key = LAUNCH if name.startswith(LAUNCH) else name
        if key in ranges:
            ranges[key].append((a, b))
    gaps = []
    for lo, hi in ranges[LOOP]:
        steps = within(ranges[STEP], lo, hi)
        for s_lo, s_hi in within(ranges[STOP], lo, hi):
            syncs = within(ranges[SYNC], s_lo, s_hi)
            after = [s for s in steps if s[0] >= s_hi]
            if not syncs or not after:
                continue
            launches = within(ranges[LAUNCH], *after[0])
            if launches:
                gaps.append(launches[0][0] - syncs[-1][1])
    return statistics.median(gaps) if gaps else None
