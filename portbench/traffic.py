"""The one traffic generator: a mix is a data file of parameters
(``portbench/traffic/<name>.json``) and this module turns it and a seed into
batches.

Every batch ``i`` of a run draws from its own ``numpy`` generator, seeded by
(seed, stream, i): stream 0 is the warm-up's, stream 1 the measured
window's.  The same seed gives the same batches.  Where lengths vary, every
batch holds the same multiset of lengths (the quantiles of the mix's
distribution) in an order drawn from the seed, so every seed runs the same
amount of work.

Input kinds (``inputs.kind``):

- ``pv``: normalised property vectors [batch, n_properties] ~ N(0, 1);
- ``tokens``: token ids drawn uniformly from [low, high) [batch, L], [CLS]
  (``cls_id``) first with ``cls_first``, zeros past each row's length and a
  mask of ones up to it.  ``length`` is ``{"fixed": n}`` or
  ``{"lognormal": {"median", "sigma", "min", "max"}}``.  With ``buckets``
  L is the smallest bucket that holds the longest row, else the longest
  row.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

WARM_UP, WINDOW = 0, 1


def rng(seed: int, stream: int, i: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream, i])


def lengths(spec: dict, batch: int) -> list[int]:
    """The multiset of row lengths of one batch, in ascending order."""
    if "fixed" in spec:
        return [int(spec["fixed"])] * batch
    ln = spec["lognormal"]
    dist = statistics.NormalDist()
    out = []
    for j in range(batch):
        z = dist.inv_cdf((j + 0.5) / batch)
        n = round(ln["median"] * math.exp(ln["sigma"] * z))
        out.append(min(max(n, ln["min"]), ln["max"]))
    return out


def make_batch(traffic: dict, seed: int, stream: int, i: int,
               n_properties: int = 53) -> dict:
    """Batch ``i`` of ``stream`` as host arrays: {"pv"} or {"ids", "mask",
    "lengths"}."""
    spec, batch = traffic["inputs"], traffic["batch"]
    g = rng(seed, stream, i)
    if spec["kind"] == "pv":
        return {"pv": g.normal(size=(batch, n_properties)).astype(np.float32)}
    if spec["kind"] != "tokens":
        raise ValueError(f"unknown input kind {spec['kind']!r}")
    lens = np.array(lengths(spec["length"], batch))
    lens = lens[g.permutation(batch)]
    longest = int(lens.max())
    width = next((b for b in sorted(spec.get("buckets", ())) if b >= longest),
                 longest)
    ids = g.integers(spec["low"], spec["high"], size=(batch, width),
                     dtype=np.int32)
    if spec.get("cls_first"):
        ids[:, 0] = spec["cls_id"]
    mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
    return {"ids": ids * mask, "mask": mask, "lengths": lens}
