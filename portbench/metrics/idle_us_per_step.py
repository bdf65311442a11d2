"""A decode batch's device idle time over its decoder steps, in
microseconds: the batches' seconds by the host clock without the profiler
(``Trace.plain_s``) less the device's busy seconds in the same batches
under it, over the steps they ran.  It holds the gaps between steps (the
graph's launch, the stop test's read) and the batch's idle outside the
loop (its prologue's launches, the copy to the host, the detokenization),
spread over the steps.  (The profiler slows a CUDA graph's launch by about
1.5 ms, so the gaps are not read from the trace's own timeline.)"""


def read(trace, works, cell):
    steps = sum(w.get("steps") or 0 for w in works)
    if not steps or not trace.plain_s or not trace.device:
        return None
    return 1e6 * (sum(trace.plain_s) - trace.busy_s) / steps
