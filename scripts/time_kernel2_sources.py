#!/usr/bin/env python3
"""Time versions of kernel 2's source against each other on one GPU.

    python3 scripts/time_kernel2_sources.py NAME=DIR [NAME=DIR ...]

Each DIR holds a version of ``spmm_tpu_torch/csrc/fused_attention.cu`` under
the same path as the repo (a checkout of another commit, or a copy of this
one with a change to try).  Every version is built with the repo's flags,
all at once, and put in place of the port's kernel-2 library in turn; each
is timed (device time of CUDA-graph replays, ``chip_smoke.cuda_ms``) at
three inputs past 256 keys, fp32, h=12, D=64:

  - B=64 512x512 with no mask: every key of every row is live;
  - the fine-tune eval's mixed batch: one 505-token text among 63 SMILES,
    Lk 512, its padding mask (``chip_smoke.mixed_eval_inputs``);
  - B=16 288x288 with one 275-token source among sources of 20-95 tokens,
    as the reaction encoder sees a long source.

The versions run in turns, first to last and then last to first, and each
row reports the mean of a version's two timings.  The compiler's report of
each version's long kernels (registers, spills) is printed first.  Needs
CUDA and nvcc; run from the repo's root.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("time_kernel2_sources: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spmm_tpu_torch.ops import _build, fused_attention
    from spmm_tpu_torch.ops.fused_attention import fused_mha
    from spmm_tpu_torch.ops.masks import extend_attention_mask

    versions = dict(arg.split("=", 1) for arg in argv)
    if not versions:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(versions)) as pool:
        libs = dict(zip(versions, pool.map(cs.parent_library,
                                           versions.values())))
    for name, where in versions.items():
        source = Path(where) / "spmm_tpu_torch" / "csrc" / "fused_attention.cu"
        report = _build.library_path("fused_attention", source)
        for entry, usage in cs.ptxas_usage(
                report.with_suffix(".log").read_text()):
            if "long_kernel<float, 64" in entry:
                print(f"{name}: {entry} {usage}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    lens = torch.randint(20, 96, (16,), generator=g, device=dev)
    lens[5] = 275
    q, k, v, _ = cs.mha_inputs(dev, 16, 12, 288, 288, 64, torch.float32,
                               "none", seed=2)
    rxn_mask = extend_attention_mask(
        (torch.arange(288, device=dev)[None] < lens[:, None]).int())
    rows = [("B=64 512x512, all keys live", cs.mha_inputs(
                dev, 64, 12, 512, 512, 64, torch.float32, "none", seed=1)),
            ("B=64 Lk 512, mixed eval batch", cs.mixed_eval_inputs(dev)),
            ("B=16 288x288, one 275-token source", (q, k, v, rxn_mask))]
    order = list(versions) + list(versions)[::-1]
    own = fused_attention._library()
    try:
        for label, (q, k, v, mask) in rows:
            ms = {name: [] for name in versions}
            for name in order:
                fused_attention._lib = libs[name]
                ms[name].append(cs.cuda_ms(lambda i: fused_mha(q, k, v, mask),
                                           iters=20))
            print(f"{label}: " + ", ".join(
                f"{name} {sum(t) / len(t):.4f} ms" for name, t in ms.items()),
                flush=True)
    finally:
        fused_attention._lib = own
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
