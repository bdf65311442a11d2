"""Device milliseconds a batch in the latent attention prefill kernel
(``mla_prefill_attention_kernel``, ``ops/mla_prefill.py``): one launch a
layer and group of rows of the turn's prefill.  The expansions by W_kvb
before each launch are library GEMMs (``gemm_ms``) and are not counted.
None where the trace holds no such launch (a program without the kernel)."""

NAMES = r"mla_prefill_attention"


def read(trace, works, cell):
    launches = trace.named(NAMES)
    if not launches or not trace.batches:
        return None
    return sum(b - a for _, a, b in launches) / 1e3 / len(trace.batches)
