"""Per-layer readers: ``<metric>.py`` defines ``read(trace, works, cell)``,
the metric's value from a traced window (``portbench.trace.Trace``) and the
traced batches' needed work (the drivers' ``work``), or None where there is
nothing to read: then the metric is left out of the line.  A metric named
``<base>.<cell>`` without a file of its own is read by ``<base>.py``: one
quantity split by the end-to-end metric it moves."""


def roofline(trace, works, pattern: str, key: str):
    """100 x the summed bound over the summed device time of the launches
    named by ``pattern``; None where the batches need none of them or the
    trace holds another number of them."""
    if any(key not in w for w in works):
        return None
    launches = sum(w[key][0] for w in works)
    bound_s = sum(w[key][1] for w in works)
    events = trace.named(pattern)
    if launches == 0 or len(events) != launches:
        return None
    return 100.0 * bound_s / (sum(b - a for _, a, b in events) / 1e6)
