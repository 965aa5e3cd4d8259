"""Table generators, one module per configuration's ``generator``.

Each module has ``generate(sizes, seed) -> Data``: numpy columns made in
bulk from the seed.  Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Data:
    """Tables as ``{table: {column: int64 array}}``."""

    tables: Dict[str, Dict[str, np.ndarray]]

    def rows(self, table: str) -> int:
        return len(next(iter(self.tables[table].values())))


def generate(cfg: dict, seed: int) -> Data:
    """The tables of configuration ``cfg`` for run seed ``seed``."""
    mod = importlib.import_module(f"gjbench.data.{cfg['generator']}")
    return mod.generate(cfg["sizes"], int(cfg.get("data_seed", 0)), seed)
