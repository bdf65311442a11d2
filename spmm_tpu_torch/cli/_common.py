"""Shared CLI helpers (counterpart of ``spmm_tpu.cli._common``)."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from spmm_tpu_torch.chem.normalize import PropertyStats
from spmm_tpu_torch.tokenizer import SmilesTokenizer, load_vocab


def seed_everything(seed: Optional[int]) -> int:
    """Random seed per run unless given (the reference seeds randomly in
    most scripts, d_smiles2pv.py:113); seeds Python, numpy and torch."""
    if seed is None:
        seed = random.randint(0, 1000)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print("seed:", seed)
    return seed


def make_tokenizer(vocab_path: Optional[str] = None) -> SmilesTokenizer:
    vocab = load_vocab(vocab_path) if vocab_path else None
    return SmilesTokenizer(vocab)


def load_stats(path: Optional[str] = None) -> PropertyStats:
    return PropertyStats.load(path)


def inference_devices(dev: torch.device,
                      batch: int) -> tuple[Optional[list], int]:
    """(every visible card, the batch rounded up to divide over them) when
    the run is on the GPU and there are two cards or more
    (``parallel.mesh.auto_mesh``: no flag, as JAX's CLIs); else (None,
    batch), the unsharded path."""
    from spmm_tpu_torch.parallel.mesh import auto_mesh

    devices = auto_mesh() if dev.type == "cuda" else None
    if devices is None:
        return None, batch
    print(f"data-parallel over {len(devices)} devices")
    return devices, batch + (-batch % len(devices))
