"""Frozen, seeded tensor generators that run on the card.

Copies of the port's `sparse.synthetic.uniform_tensor` and
`blocked_tensor` distributions, drawn with a `torch.Generator` on the
tensor's device in a few large calls. They are frozen here so that a later
change to the port's generators cannot change the benchmark's inputs.

Unlike the originals, a draw does not sum duplicate coordinates: it keeps
each coordinate's first draw, and keeps drawing in batches until exactly
``nnz`` distinct coordinates are reached. The tensor is the first ``nnz``
distinct coordinates in draw order, so the same seed on the same kind of
device gives the same tensor, and values stay in their stated range.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

MAX_BATCHES = 64


def stream_seed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit generator seed for one purpose of one run, mixed from the
    run's ``seed`` so that streams of different purposes or indices are
    unrelated."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}:{int(index)}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def generator(seed: int, purpose: str, device, index: int = 0
              ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, purpose, index))
    return g


@dataclasses.dataclass
class Coo:
    """A sparse tensor in coordinate form on one device."""
    dims: tuple[int, ...]
    coords: torch.Tensor     # (nnz, N) int64
    values: torch.Tensor     # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def _strides(dims) -> list[int]:
    out, s = [], 1
    for d in reversed(dims):
        out.append(s)
        s *= int(d)
    if s >= 2 ** 63:
        raise ValueError(f"dims {dims} do not fit one int64 key")
    return out[::-1]


def _first_distinct(keys: torch.Tensor) -> torch.Tensor:
    """Positions of the first occurrence of each distinct key, ascending."""
    sk, order = torch.sort(keys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return torch.sort(order[first]).values


def _draw_distinct(dims, nnz: int, draw, device) -> Coo:
    """Batches of ``draw(count) -> (coords, values)`` until ``nnz``
    distinct coordinates are drawn; the first ``nnz`` in draw order."""
    strides = torch.tensor(_strides(dims), dtype=torch.int64, device=device)
    coords, values = draw(nnz)
    for _ in range(MAX_BATCHES):
        keep = _first_distinct((coords * strides).sum(dim=1))
        have = int(keep.shape[0])
        coords, values = coords[keep], values[keep]
        if have >= nnz:
            return Coo(tuple(int(d) for d in dims), coords[:nnz].contiguous(),
                       values[:nnz].contiguous())
        # Collisions thin each batch: draw an eighth more than is missing.
        c, v = draw((nnz - have) + (nnz - have) // 8 + 1024)
        coords = torch.cat([coords, c])
        values = torch.cat([values, v])
    raise RuntimeError(f"{nnz} distinct coordinates not reached in "
                       f"{MAX_BATCHES} batches of dims {dims}")


def uniform_tensor(dims, nnz: int, seed: int, device, count_max: int = 9
                   ) -> Coo:
    """i.i.d. uniform coordinates, counts uniform in 1..``count_max``."""
    g = generator(seed, "tensor", device)

    def draw(k):
        coords = torch.stack([torch.randint(0, int(d), (k,), generator=g,
                                            device=device) for d in dims], 1)
        values = torch.randint(1, count_max + 1, (k,), generator=g,
                               device=device).float()
        return coords, values
    return _draw_distinct(dims, nnz, draw, device)


def blocked_tensor(dims, nnz: int, seed: int, device, block: int = 16,
                   n_blocks: int = 512, count_max: int = 14,
                   layout_seed: int = 0) -> Coo:
    """Coordinates clustered in ``n_blocks`` random blocks of side
    ``block``: a block's corner is uniform in [0, max(1, I − block)) per
    mode, an offset uniform in [0, min(block, I)); counts uniform in
    1..``count_max``.

    The corners come from ``layout_seed``, the points from ``seed``: every
    seed samples the same blocks, so the work (fiber reuse, the recursive
    traversal's Temp) does not change from seed to seed."""
    g = generator(layout_seed, "blocked layout", device)
    base = torch.stack([torch.randint(0, max(1, int(d) - block), (n_blocks,),
                                      generator=g, device=device)
                        for d in dims], 1)
    g = generator(seed, "tensor", device)

    def draw(k):
        which = torch.randint(0, n_blocks, (k,), generator=g, device=device)
        offs = torch.stack([torch.randint(0, min(block, int(d)), (k,),
                                          generator=g, device=device)
                            for d in dims], 1)
        values = torch.randint(1, count_max + 1, (k,), generator=g,
                               device=device).float()
        return base[which] + offs, values
    return _draw_distinct(dims, nnz, draw, device)


GENERATORS = {"uniform": uniform_tensor, "blocked": blocked_tensor}


def make_tensor(config: dict, seed: int, device) -> Coo:
    """The configuration's tensor: ``config["generator"]`` names the
    distribution and its parameters (`GENERATORS`)."""
    gen = dict(config["generator"])
    kind = gen.pop("kind")
    return GENERATORS[kind](tuple(config["dims"]), int(config["nnz"]),
                            seed, device, **gen)
