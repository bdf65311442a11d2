"""Dataset loaders (the part of ``spmm_tpu.data.datasets`` that the port's
CLIs need).

Every loader yields texts as ``'[CLS]' + smiles``: the literal prefix is
what anchors wordpiece tokenization.

  - ``PretrainDataset`` reads SMILES lines and their raw property vectors
    from a precomputed ``.npz`` property cache.  Without a cache the JAX
    package featurizes with RDKit; the port has no featurizer there, so an
    item then raises.
  - ``USPTODataset`` / ``USPTORetroDataset``: the reaction pairs of
    USPTO-480k (forward) and USPTO-50k (retro), with the reference's
    randomized-SMILES augmentation at p=0.5 per item (reference
    dataset.py:243-296).
"""

from __future__ import annotations

import pickle
import random
from typing import Optional

import numpy as np

from spmm_tpu_torch.chem.featurizer import (
    canonicalize, randomized_smiles, require_rdkit)
from spmm_tpu_torch.chem.normalize import PropertyStats


class PretrainDataset:
    """SMILES lines -> (normalized 53-PV, '[CLS]'+canonical smiles)
    (reference SMILESDataset_pretrain, dataset.py:13-40).

    ``data_range`` (start, stop) keeps those lines of ``path``;
    ``property_cache``: .npz with array 'pv' [N, 53] of RAW (un-normalized)
    property values aligned with the non-empty lines kept."""

    def __init__(self, path: str, property_cache: Optional[str] = None,
                 stats: Optional[PropertyStats] = None, data_range=None):
        with open(path) as f:
            lines = [line.strip() for line in f]
        if data_range is not None:
            lines = lines[data_range[0]: data_range[1]]
        self.smiles = [line for line in lines if line]
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


class USPTODataset:
    """Forward synthesis: tab-separated 'reactants<TAB>product' lines."""

    def __init__(self, path: str, data_range=None, augment: bool = False,
                 seed: int = 0):
        with open(path) as f:
            lines = [line.strip() for line in f if line.strip()]
        if data_range:
            lines = lines[data_range[0]: data_range[1]]
        self.pairs = [tuple(line.split("\t")) for line in lines]
        self.augment = augment
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> tuple[str, str]:
        rs, ps = self.pairs[i]
        if self.augment and self._rng.random() > 0.5:
            rs = randomized_smiles(rs, self._rng) or rs
            ps = randomized_smiles(ps, self._rng) or ps
        return "[CLS]" + rs, "[CLS]" + ps


class USPTORetroDataset:
    """Retro synthesis from the pickled USPTO-50k DataFrame (reference
    dataset.py:269-296): items are (product, reactants).  Needs RDKit, whose
    mol objects the pickle holds."""

    def __init__(self, pickle_path: str, split: str = "train",
                 augment: bool = False, seed: int = 0):
        require_rdkit("USPTO-50k mol-object deserialization")
        from rdkit import Chem

        with open(pickle_path, "rb") as f:
            df = pickle.load(f)
        rows = [df.iloc[i] for i in range(len(df))]
        self.rows = [r for r in rows if r["set"] == split]
        self.augment = augment
        self._rng = random.Random(seed)
        self._chem = Chem

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> tuple[str, str]:
        d = self.rows[i]
        p_mol, r_mol = d["products_mol"], d["reactants_mol"]
        do_aug = self.augment and self._rng.random() > 0.5

        def shuffled(mol):
            idx = list(range(mol.GetNumAtoms()))
            self._rng.shuffle(idx)
            return self._chem.RenumberAtoms(mol, idx)

        if do_aug:
            p_mol, r_mol = shuffled(p_mol), shuffled(r_mol)

        def to_s(m) -> str:
            return self._chem.MolToSmiles(m, canonical=not do_aug,
                                          isomericSmiles=False)
        return "[CLS]" + to_s(p_mol), "[CLS]" + to_s(r_mol)
