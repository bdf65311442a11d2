"""RDKit-gated chemistry helpers (the part of ``spmm_tpu.chem.featurizer``
that the port's CLIs and datasets need).

Every function works without RDKit, as in the JAX package:
  - ``canonicalize`` and ``randomized_smiles`` fall back to the identity for
    syntactically valid SMILES and None otherwise;
  - ``is_valid_smiles`` falls back to the pure-Python syntax parser;
  - ``calculate_property`` (the 53 descriptors, reference
    calc_property.py:14-28) raises RuntimeError: property vectors then come
    from a precomputed cache (``data.datasets.PretrainDataset``).
"""

from __future__ import annotations

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
