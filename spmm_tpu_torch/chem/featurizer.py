"""RDKit-gated chemistry helpers (counterpart of
``spmm_tpu.chem.featurizer``).

Every function works without RDKit, as in the JAX package:
  - ``canonicalize`` and ``randomized_smiles`` fall back to the identity for
    syntactically valid SMILES and None otherwise;
  - ``is_valid_smiles`` falls back to the pure-Python syntax parser;
  - ``calculate_property`` (the 53 descriptors, reference
    calc_property.py:14-28) and ``calculate_properties_batch`` (the same
    over a process pool, spmm_tpu/chem/featurizer.py:76-104) raise
    RuntimeError: property vectors then come from a precomputed cache
    (``data.datasets.PretrainDataset``).
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Optional, Sequence

import numpy as np

from spmm_tpu_torch.chem.normalize import PropertyStats
from spmm_tpu_torch.chem.smiles import is_valid_syntax

try:
    from rdkit import Chem, RDLogger
    from rdkit.Chem import QED, Descriptors

    RDLogger.DisableLog("rdApp.*")
    HAS_RDKIT = True
except ImportError:
    HAS_RDKIT = False


def _descriptor_fns(names: Sequence[str]) -> list:
    """Descriptor functions by name, ``QED`` from ``rdkit.Chem.QED``."""
    return [QED.qed if n == "QED" else getattr(Descriptors, n)
            for n in names]


def require_rdkit(what: str = "descriptor computation") -> None:
    if not HAS_RDKIT:
        raise RuntimeError(
            f"RDKit is required for {what} but is not installed; supply "
            "precomputed properties (a .npz property cache) instead")


def calculate_property(smiles: str,
                       stats: Optional[PropertyStats] = None) -> np.ndarray:
    """Raw (un-normalized) 53-dim property vector of one SMILES."""
    require_rdkit()
    stats = stats or PropertyStats.load()
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        raise ValueError(f"invalid SMILES: {smiles!r}")
    return np.asarray([f(mol) for f in _descriptor_fns(stats.names)],
                      np.float32)


def _worker(args: tuple) -> Optional[np.ndarray]:
    """One molecule's raw vector, None where RDKit rejects the SMILES."""
    smiles, names = args
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    return np.asarray([f(mol) for f in _descriptor_fns(names)], np.float32)


def calculate_properties_batch(smiles_list: Sequence[str],
                               stats: Optional[PropertyStats] = None,
                               n_workers: Optional[int] = None
                               ) -> list[Optional[np.ndarray]]:
    """Raw vectors of many SMILES, None for those RDKit rejects: in this
    process below 64 molecules or with one worker, else over a pool of
    ``n_workers`` (at most 16 by default) spawned processes, as the 53
    descriptors are CPU-heavy and must not starve the training loop."""
    require_rdkit()
    stats = stats or PropertyStats.load()
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, 16)
    work = [(s, stats.names) for s in smiles_list]
    if n_workers <= 1 or len(smiles_list) < 64:
        return [_worker(w) for w in work]
    with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
        return pool.map(_worker, work, chunksize=64)


def canonicalize(smiles: str, isomeric: bool = False) -> Optional[str]:
    """RDKit canonical SMILES (reference dataset.py:37); identity fallback."""
    if not HAS_RDKIT:
        return smiles if is_valid_syntax(smiles) else None
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    return Chem.MolToSmiles(mol, isomericSmiles=isomeric, canonical=True)


def randomized_smiles(smiles: str, rng) -> Optional[str]:
    """Randomized-SMILES augmentation (reference dataset.py:261-265): a
    random atom order and non-canonical output; identity fallback."""
    if not HAS_RDKIT:
        return smiles if is_valid_syntax(smiles) else None
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    idx = list(range(mol.GetNumAtoms()))
    rng.shuffle(idx)
    mol = Chem.RenumberAtoms(mol, idx)
    return Chem.MolToSmiles(mol, canonical=False, isomericSmiles=False)


def is_valid_smiles(smiles: str) -> bool:
    """Chemical validity with RDKit; syntax only without."""
    if not smiles:
        return False
    if HAS_RDKIT:
        return Chem.MolFromSmiles(smiles) is not None
    return is_valid_syntax(smiles)
