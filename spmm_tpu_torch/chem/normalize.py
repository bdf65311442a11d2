"""Property-vector normalization stats (copy of ``spmm_tpu.chem.normalize``).

The reference z-normalizes the 53-dim PV with a pickled (mean, std) tuple
(reference dataset.py:26-28); the same statistics ship as
``spmm_tpu_torch/assets/property_stats.json`` with the 53 descriptor names.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "property_stats.json")


@dataclasses.dataclass(frozen=True)
class PropertyStats:
    names: tuple[str, ...]
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def load(cls, path: str | None = None) -> "PropertyStats":
        with open(path or _ASSET) as f:
            raw = json.load(f)
        return cls(
            names=tuple(raw["property_names"]),
            mean=np.asarray(raw["mean"], np.float32),
            std=np.asarray(raw["std"], np.float32),
        )

    @property
    def n_properties(self) -> int:
        return len(self.names)

    def normalize(self, pv: np.ndarray) -> np.ndarray:
        return (np.asarray(pv, np.float32) - self.mean) / self.std

    def denormalize(self, pv: np.ndarray) -> np.ndarray:
        return np.asarray(pv, np.float32) * self.std + self.mean

    def index_of(self, name: str) -> int:
        return self.names.index(name)
