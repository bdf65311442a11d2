"""What every driver shares: the program's configuration objects, its
model built on the card with the benchmark's weights, and the set-up's
phases logged."""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench import weights


def bert_arch(arch: dict):
    from spmm_tpu_torch.configs import BertArchConfig

    return BertArchConfig(**arch)


@contextlib.contextmanager
def phase(what: str, device):
    """Log a set-up phase's seconds to standard error."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"portbench: {what} {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)


def on_device(cls, config: dict, seed: int, device, *archs):
    """The program's model class built on ``device`` with the benchmark's
    weights for ``config``: its own init runs there, then every tensor is
    overwritten."""
    with torch.device(device):
        model = cls(*archs)
    return weights.load_into(model, weights.make(config, seed, device))


def sample(rows: list, size, seed: int, n: int) -> list:
    """``n`` of ``rows`` drawn from the seed, the one with the largest
    ``size(row)`` first: a run's sample for the comparison."""
    longest = max(range(len(rows)), key=lambda j: size(rows[j]))
    rest = [j for j in range(len(rows)) if j != longest]
    g = np.random.default_rng([seed, 2])
    pick = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [rows[longest]] + [rows[rest[j]] for j in sorted(pick)]
