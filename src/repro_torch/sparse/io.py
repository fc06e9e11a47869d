"""FROSTT ``.tns`` sparse-tensor text format reader/writer.

Format: one nonzero per line, 1-based coordinates followed by the value:
``i_1 i_2 ... i_N v``. Lines beginning with ``#`` are comments.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.tensor import SparseTensor


def read_tns(path: str, dims: tuple[int, ...] | None = None) -> SparseTensor:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(t) for t in line.split()])
    if not rows:
        raise ValueError(f"{path}: empty tensor file")
    arr = np.asarray(rows)
    coords = arr[:, :-1].astype(np.int64) - 1  # 1-based -> 0-based
    values = arr[:, -1].astype(np.float32)
    if dims is None:
        dims = tuple(int(coords[:, n].max()) + 1
                     for n in range(coords.shape[1]))
    return SparseTensor(dims, coords.astype(np.int32), values)


def write_tns(path: str, x: SparseTensor) -> None:
    with open(path, "w") as f:
        for c, v in zip(x.coords, x.values):
            f.write(" ".join(str(int(i) + 1) for i in c) + f" {float(v)}\n")
