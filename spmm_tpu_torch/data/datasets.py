"""Dataset loaders (the part of ``spmm_tpu.data.datasets`` that
``cli/smiles2pv`` needs).

``PretrainDataset`` reads SMILES lines and their raw property vectors from a
precomputed ``.npz`` property cache.  Without a cache the JAX package
featurizes with RDKit; the port has no featurizer, so an item then raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spmm_tpu_torch.chem.featurizer import canonicalize
from spmm_tpu_torch.chem.normalize import PropertyStats


class PretrainDataset:
    """SMILES lines -> (normalized 53-PV, '[CLS]'+canonical smiles)
    (reference SMILESDataset_pretrain, dataset.py:13-40).

    ``property_cache``: .npz with array 'pv' [N, 53] of RAW (un-normalized)
    property values aligned with the non-empty lines of ``path``."""

    def __init__(self, path: str, property_cache: Optional[str] = None,
                 stats: Optional[PropertyStats] = None):
        with open(path) as f:
            self.smiles = [line.strip() for line in f if line.strip()]
        self.stats = stats or PropertyStats.load()
        self._pv_cache = None
        if property_cache is not None:
            self._pv_cache = np.load(property_cache)["pv"].astype(np.float32)
            if len(self._pv_cache) != len(self.smiles):
                raise ValueError(
                    f"property cache has {len(self._pv_cache)} rows for "
                    f"{len(self.smiles)} SMILES")

    def __len__(self) -> int:
        return len(self.smiles)

    def __getitem__(self, i: int) -> tuple[np.ndarray, str]:
        if self._pv_cache is None:
            raise RuntimeError(
                "property featurization is not in the PyTorch port; supply "
                "property_cache")
        s = self.smiles[i]
        text = "[CLS]" + (canonicalize(s) or s)
        return self.stats.normalize(self._pv_cache[i]), text
