"""Device milliseconds a batch in the library's matrix-product kernels
(cuBLAS and CUTLASS kernels on an H100, named below)."""

NAMES = r"gemm|nvjet|cutlass|xmma|cublas"


def read(trace, works, cell):
    gemms = trace.named(NAMES)
    if not gemms:
        return None
    return sum(b - a for _, a, b in gemms) / 1e3 / len(trace.batches)
