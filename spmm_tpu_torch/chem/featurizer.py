"""RDKit-gated chemistry helpers (the part of ``spmm_tpu.chem.featurizer``
that ``cli/smiles2pv`` needs).

``canonicalize`` is RDKit's canonical SMILES; without RDKit it falls back to
the identity for syntactically valid SMILES and None otherwise, as the JAX
package does.  Descriptor featurization is not carried over: property
vectors come from a precomputed cache (``data.datasets.PretrainDataset``).
"""

from __future__ import annotations

from typing import Optional

from spmm_tpu_torch.chem.smiles import is_valid_syntax

try:
    from rdkit import Chem, RDLogger

    RDLogger.DisableLog("rdApp.*")
    HAS_RDKIT = True
except ImportError:
    HAS_RDKIT = False


def canonicalize(smiles: str, isomeric: bool = False) -> Optional[str]:
    """RDKit canonical SMILES (reference dataset.py:37); identity fallback."""
    if not HAS_RDKIT:
        return smiles if is_valid_syntax(smiles) else None
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    return Chem.MolToSmiles(mol, isomericSmiles=isomeric, canonical=True)
