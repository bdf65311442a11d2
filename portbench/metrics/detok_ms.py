"""Host milliseconds a batch in detokenization, read from the program's
spans: the summed ``spmm.detokenize`` spans (``SmilesTokenizer.decode``,
one a string) over the traced batches.  The result is on the host by then,
so the device is idle throughout.  None where there is no such span."""

DETOK = "spmm.detokenize"


def read(trace, works, cell):
    spans = [b - a for name, a, b in trace.host if name == DETOK]
    if not spans or not trace.batches:
        return None
    return sum(spans) / 1e3 / len(trace.batches)
