"""Dataset loaders (counterpart of ``spmm_tpu.data.datasets``).

Every loader yields texts as ``'[CLS]' + smiles``: the literal prefix is
what anchors wordpiece tokenization.

  - ``SupervisedDataset`` and the ten MoleculeNet / DILI loaders of
    ``DOWNSTREAM_LOADERS`` (reference dataset.py:43-241), reading CSVs with
    the standard library's ``csv`` (the card's machine has no pandas) with
    pandas' semantics where the JAX loaders rely on them: blank lines
    skipped, empty and NA cells NaN, columns in file order (SIDER's labels
    are every column after the first).  The reference's quirks are kept:
    hard-coded label mean/std per dataset (``LABEL_STATS``); only Freesolv
    normalizes its targets in the dataset (dataset.py:181) while eval
    de-normalizes every regression set; BBBP drops unparseable SMILES
    (dataset.py:128), every other loader raises on one.

  - ``PretrainDataset`` reads SMILES lines and their raw property vectors
    from a precomputed ``.npz`` property cache, which
    ``build_property_cache`` writes with RDKit (``chem.featurizer.
    calculate_properties_batch``).  Without a cache the JAX package
    featurizes each item with RDKit; the port reads caches only, so an
    item then raises.
  - ``USPTODataset`` / ``USPTORetroDataset``: the reaction pairs of
    USPTO-480k (forward) and USPTO-50k (retro), with the reference's
    randomized-SMILES augmentation at p=0.5 per item (reference
    dataset.py:243-296).
"""

from __future__ import annotations

import csv
import dataclasses
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

    def build_property_cache(self, out_path: str, n_workers: int = 8) -> None:
        """Write the raw property table of the canonical SMILES to
        ``out_path`` (``.npz``, array ``pv`` [N, 53]): one-off, RDKit
        required (spmm_tpu/data/datasets.py:126-134)."""
        from spmm_tpu_torch.chem.featurizer import calculate_properties_batch

        canon = [_canon(s) for s in self.smiles]
        pvs = calculate_properties_batch(canon, self.stats, n_workers)
        if any(p is None for p in pvs):
            raise ValueError("the corpus holds SMILES that RDKit rejects")
        np.savez_compressed(out_path, pv=np.stack(pvs))


# (mean, std) label stats hard-coded by the reference (dataset.py)
LABEL_STATS = {
    "bace_r": (6.420878294545455, 1.345219669175284),
    "lipo": (2.162904761904762, 1.210992810122257),
    "clearance": (51.503692077727955, 53.50834365711207),
    "esol": (-2.8668758314855878, 2.066724108076815),
    "freesolv": (-3.2594736842105267, 3.2775297233608893),
}

# cells pandas.read_csv reads as NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}


@dataclasses.dataclass
class SupervisedDataset:
    """texts: '[CLS]'-prefixed SMILES; targets: scalar or vector labels."""

    texts: list[str]
    targets: np.ndarray
    value_mean: float = 0.0
    value_std: float = 1.0
    n_output: int = 1

    def __len__(self):
        return len(self.texts)


class _Table:
    """A CSV file's header and rows, blank lines skipped."""

    def __init__(self, path: str):
        with open(path, newline="") as f:
            rows = [row for row in csv.reader(f) if row]
        self.header, self.rows = rows[0], rows[1:]

    def column(self, col) -> list[str]:
        """The cells of a column, by name or by position."""
        j = col if isinstance(col, int) else self.header.index(col)
        return [row[j] for row in self.rows]

    def floats(self, *cols) -> np.ndarray:
        """The columns as float64, [N] for one column, else [N, k]."""
        vals = [[np.nan if v.strip() in _NA else float(v)
                 for v in self.column(c)] for c in cols]
        out = np.asarray(vals, np.float64).reshape(len(cols), -1).T
        return out[:, 0] if len(cols) == 1 else out


def _canon(smiles: str) -> str:
    out = canonicalize(smiles, isomeric=False)
    if out is None:
        raise ValueError(f"unparseable SMILES: {smiles!r}")
    return out


def load_bace_c(path: str) -> SupervisedDataset:
    t = _Table(path)
    texts = ["[CLS]" + _canon(r) for r in t.column("mol")]
    return SupervisedDataset(texts, t.floats("Class").astype(np.int32),
                             n_output=2)


def load_bbbp(path: str) -> SupervisedDataset:
    t = _Table(path)
    texts, ys = [], []
    for smiles, y in zip(t.column("smiles"), t.floats("p_np")):
        try:
            texts.append("[CLS]" + _canon(smiles))
        except ValueError:
            continue  # reference filters unparseable rows (dataset.py:128)
        ys.append(int(y))
    return SupervisedDataset(texts, np.asarray(ys, np.int32), n_output=2)


def load_dili(path: str) -> SupervisedDataset:
    t = _Table(path)
    texts = ["[CLS]" + _canon(r) for r in t.column("Smiles")]
    return SupervisedDataset(texts, t.floats("Liver").astype(np.int32),
                             n_output=2)


def _regression(path: str, smiles_col: str, target_col: str, stats_key: str,
                normalize_targets: bool = False) -> SupervisedDataset:
    t = _Table(path)
    mean, std = LABEL_STATS[stats_key]
    texts = ["[CLS]" + _canon(r) for r in t.column(smiles_col)]
    y = t.floats(target_col).astype(np.float32)
    if normalize_targets:       # ONLY freesolv (reference dataset.py:181)
        y = (y - mean) / std
    return SupervisedDataset(texts, y, value_mean=mean, value_std=std)


def load_bace_r(path):
    return _regression(path, "smiles", "target", "bace_r")


def load_lipo(path):
    return _regression(path, "smiles", "exp", "lipo")


def load_clearance(path):
    return _regression(path, "smiles", "target", "clearance")


def load_esol(path):
    return _regression(
        path, "smiles", "ESOL predicted log solubility in mols per litre",
        "esol")


def load_freesolv(path):
    return _regression(path, "smiles", "target", "freesolv",
                       normalize_targets=True)


def load_clintox(path: str) -> SupervisedDataset:
    t = _Table(path)
    texts = ["[CLS]" + _canon(r) for r in t.column("smiles")]
    y = t.floats("FDA_APPROVED", "CT_TOX").astype(np.float32)
    return SupervisedDataset(texts, y, n_output=2)


def load_sider(path: str) -> SupervisedDataset:
    t = _Table(path)
    texts = ["[CLS]" + _canon(r) for r in t.column("smiles")]
    y = t.floats(*range(1, len(t.header))).astype(np.float32)
    y = y.reshape(len(texts), -1)
    return SupervisedDataset(texts, y, n_output=y.shape[1])


DOWNSTREAM_LOADERS = {
    "bace": load_bace_c,
    "bbbp": load_bbbp,
    "lidi": load_dili,
    "bace_r": load_bace_r,
    "lipo": load_lipo,
    "clearance": load_clearance,
    "esol": load_esol,
    "freesolv": load_freesolv,
    "clintox": load_clintox,
    "sider": load_sider,
}


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
