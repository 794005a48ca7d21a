"""Host-side file IO — the port of the JAX package's `data/io.py`, format
parity with the reference's `data/loader.py`.

Interaction files: one header line (skipped), then `user<TAB>item[...]`
or comma-separated; only the first two columns are read, the weight is
forced to 1.0 (data/loader.py:24-38). KG files: one header line, then
`h<TAB>r<TAB>t` (data/loader.py:66-78).

Both loaders parse with the port's native library (`native.load_columns`);
`plain=True` reads the file in Python and numpy instead, the version the
tests hold the library against.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from ..native import load_columns


def load_data_set(path: str, plain: bool = False) -> np.ndarray:
    """Interactions -> int64 array [n, 2] of (user, item) raw ids."""
    return load_columns(path, 2, plain)


def load_kg_data(path: str, plain: bool = False) -> pd.DataFrame:
    """KG triples -> DataFrame with int64 columns h, r, t."""
    return pd.DataFrame(load_columns(path, 3, plain), columns=["h", "r", "t"])


def write_interactions(path: str, data: np.ndarray, header: str = "user\titem") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(header + "\n")
        for u, i in data[:, :2]:
            f.write(f"{int(u)}\t{int(i)}\n")


def write_kg(path: str, triples: np.ndarray, header: str = "h\tr\tt") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(header + "\n")
        for h, r, t in triples:
            f.write(f"{int(h)}\t{int(r)}\t{int(t)}\n")
