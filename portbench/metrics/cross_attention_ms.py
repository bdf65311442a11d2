"""Device milliseconds a batch in the decoder step's cross-attention kernel
(``decode_cross_attention_kernel``, ``ops/decode_cross_attention.py``): one
launch a fusion layer and step of the beam decode.  None where the trace
holds no such launch (a program without the kernel)."""

NAMES = r"decode_cross_attention"


def read(trace, works, cell):
    launches = trace.named(NAMES)
    if not launches or not trace.batches:
        return None
    return sum(b - a for _, a, b in launches) / 1e3 / len(trace.batches)
