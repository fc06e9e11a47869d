"""ALTO tensor: linearized storage, balanced partitioning, traversal views.

Format generation (paper §3.1) is linearize (bit gather), sort by the
linearized index, then the balanced partitioning of §4.1. It exists
twice, bit-identically:

* ``build`` / ``oriented_view`` — host numpy, the parity reference; the
  result is moved to ``device`` at the end;
* ``build_device`` / ``oriented_view_device`` — torch on the device: a
  linearize and ONE stable key sort carrying values and coordinates.

`AltoTensor` and `OrientedView` are plain dataclasses holding tensors;
`AltoMeta` is frozen and hashable, so plans and launch caches key on it.
The meta (temp_rows, fiber_reuse) is data-dependent, so the device build
ends with one small host transfer — the (L, N) bounding boxes and N fiber
counts — while the O(nnz) stream stays on the device.

Partitioning: the sorted nonzero list is cut into L equal-size segments.
Each segment's bounding box ``T_l`` (per-mode closed intervals) is exact;
boxes of different partitions may overlap (paper Fig. 7) and the pull
reduction resolves the overlap. The largest interval per mode sizes the
recursive kernel's ``Temp``.

`device_ingest_traces` counts the distinct shape keys the device build,
view and merge have run: the port's counterpart of the JAX package's jit
traces of its ingest cores (the serving layer's stats report it).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core import encoding as enc_mod
from repro_torch.core.encoding import AltoEncoding, make_encoding
from repro_torch.device import resolve_device
from repro_torch.sparse.tensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class AltoMeta:
    """Hashable static metadata of a built tensor."""
    enc: AltoEncoding
    nnz: int                        # real nonzeros (before padding)
    n_partitions: int
    temp_rows: tuple[int, ...]      # per mode: max partition interval length
    fiber_reuse: tuple[float, ...]  # per mode: avg nnz per fiber

    @property
    def dims(self) -> tuple[int, ...]:
        return self.enc.dims


@dataclasses.dataclass
class AltoTensor:
    """Linearized sparse tensor, sorted by ALTO index, padded to L·chunk."""

    meta: AltoMeta
    words: torch.Tensor        # (Mp, n_words) int32 word bits, ascending
    values: torch.Tensor       # (Mp,)
    part_start: torch.Tensor   # (L, N) int32 — T_l^s per partition/mode
    part_end: torch.Tensor     # (L, N) int32 — T_l^e (inclusive)

    @property
    def dims(self) -> tuple[int, ...]:
        return self.meta.dims

    @property
    def nnz(self) -> int:
        return self.meta.nnz

    @property
    def n_partitions(self) -> int:
        return self.meta.n_partitions

    @property
    def device(self) -> torch.device:
        return self.words.device

    def coords(self) -> torch.Tensor:
        return enc_mod.delinearize(self.meta.enc, self.words)


@dataclasses.dataclass
class OrientedView:
    """Output-oriented traversal copy for one mode (paper Fig. 8 right).

    Nonzeros permuted into ascending order of the target mode (ALTO order
    within a row), so conflict-free updates become a sorted segment
    reduction.
    """
    meta: AltoMeta
    mode: int
    rows: torch.Tensor     # (Mp,) int32 target-mode index, ascending
    words: torch.Tensor    # (Mp, n_words) int32 permuted ALTO words
    values: torch.Tensor   # (Mp,)
    perm: torch.Tensor     # (Mp,) int32 position in ALTO order


def _meta(enc: AltoEncoding, nnz: int, L: int, ps: np.ndarray,
          pe: np.ndarray, fibers) -> AltoMeta:
    temp_rows = tuple(int((pe[:, n] - ps[:, n]).max()) + 1
                      for n in range(enc.ndim))
    if fibers is None:
        reuse = tuple(float("nan") for _ in range(enc.ndim))
    else:
        reuse = tuple(float(nnz) / max(1, int(f)) for f in fibers)
    return AltoMeta(enc=enc, nnz=nnz, n_partitions=L, temp_rows=temp_rows,
                    fiber_reuse=reuse)


# ---------------------------------------------------------------------------
# Format generation (host side)
# ---------------------------------------------------------------------------

def fiber_counts_np(enc: AltoEncoding, words_np: np.ndarray) -> list[int]:
    """Fibers per mode: distinct indices with that mode's bits masked."""
    masks = enc.mode_masks()
    return [enc_mod.count_distinct_np(words_np & ~masks[n][None, :])
            if words_np.shape[0] else 1 for n in range(enc.ndim)]


def fiber_reuse_stats(enc: AltoEncoding, words_np: np.ndarray,
                      nnz: int) -> tuple[float, ...]:
    """Average nonzeros per fiber along each mode (paper §4.2)."""
    return tuple(float(nnz) / max(1, f)
                 for f in fiber_counts_np(enc, words_np[:nnz]))


def build(x: SparseTensor, n_partitions: int = 8,
          compute_reuse: bool = True, device=None) -> AltoTensor:
    """ALTO format generation on the host: linearize -> sort -> partition,
    then the result moves to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    enc = make_encoding(x.dims)
    L = max(1, int(n_partitions))
    words = enc_mod.linearize_np(enc, x.coords)
    order = enc_mod.sort_key_np(words)
    words = words[order]
    values = np.asarray(x.values)[order]
    coords = x.coords[order]
    M = x.nnz

    # Pad to a multiple of L with value-0 copies of the last element so the
    # padded tail stays inside the final partition's bounding box.
    chunk = -(-max(M, L) // L)
    Mp = chunk * L
    if Mp > M:
        pad = Mp - M
        if M == 0:
            pad_words = np.zeros((pad, enc.n_words), dtype=np.uint32)
            pad_coords = np.zeros((pad, enc.ndim), dtype=coords.dtype)
        else:
            pad_words = np.repeat(words[-1:], pad, axis=0)
            pad_coords = np.repeat(coords[-1:], pad, axis=0)
        words = np.concatenate([words, pad_words], axis=0)
        values = np.concatenate(
            [values, np.zeros(pad, dtype=values.dtype)], axis=0)
        coords = np.concatenate([coords, pad_coords], axis=0)
    cc = coords.reshape(L, chunk, enc.ndim)
    part_start = cc.min(axis=1).astype(np.int32)          # (L, N)
    part_end = cc.max(axis=1).astype(np.int32)
    fibers = fiber_counts_np(enc, words[:M]) if compute_reuse else None
    meta = _meta(enc, M, L, part_start, part_end, fibers)
    return AltoTensor(meta=meta,
                      words=enc_mod.words_from_np(words).to(dev),
                      values=torch.from_numpy(values).to(dev),
                      part_start=torch.from_numpy(part_start).to(dev),
                      part_end=torch.from_numpy(part_end).to(dev))


def oriented_view(at: AltoTensor, mode: int) -> OrientedView:
    """The output-oriented permutation for ``mode``, built on the host and
    placed on the tensor's device."""
    words_np = enc_mod.words_to_np(at.words)
    values_np = at.values.cpu().numpy()
    rows = enc_mod.extract_mode_np(at.meta.enc, words_np, mode)
    # stable sort by row keeps ALTO order within each row (input locality)
    order = np.argsort(rows, kind="stable")
    dev = at.device
    return OrientedView(
        meta=at.meta, mode=mode,
        rows=torch.from_numpy(rows[order].astype(np.int32)).to(dev),
        words=enc_mod.words_from_np(words_np[order]).to(dev),
        values=torch.from_numpy(values_np[order]).to(dev),
        perm=torch.from_numpy(order.astype(np.int32)).to(dev))


# ---------------------------------------------------------------------------
# Format generation (device side)
# ---------------------------------------------------------------------------

_INGEST_KEYS: dict[str, set] = {"build": set(), "view": set(),
                                "merge": set()}
_INGEST_LOCK = threading.Lock()


def note_ingest(kind: str, key: tuple) -> None:
    """Record one run of the device ``kind`` ("build", "view", "merge")
    at the shape ``key``."""
    with _INGEST_LOCK:
        _INGEST_KEYS[kind].add(key)


def device_ingest_traces() -> dict[str, int]:
    """Distinct shape keys (encoding, partitions, lengths, dtype, device
    type) that the device build, the device view and the ingest merge
    have run in this process."""
    with _INGEST_LOCK:
        return {k: len(v) for k, v in _INGEST_KEYS.items()}

def build_device(x: SparseTensor, n_partitions: int = 8,
                 compute_reuse: bool = True, device=None) -> AltoTensor:
    """ALTO format generation in torch on ``device`` (default ``cuda``).

    Linearize → ONE stable multi-word key sort carrying values and the
    coordinate columns (`encoding.sort_by_key`) → min/max partition
    boxes. Bit-identical to `build`: same element order (stable sort, so
    duplicate keys keep COO input order), same padding, same meta.
    """
    dev = resolve_device(device)
    enc = make_encoding(x.dims)
    L = max(1, int(n_partitions))
    M = x.nnz
    N, W = enc.ndim, enc.n_words
    note_ingest("build", (enc, L, M, bool(compute_reuse),
                          str(np.asarray(x.values).dtype), dev.type))
    coords = torch.from_numpy(x.coords).to(dev)
    values = torch.from_numpy(np.asarray(x.values)).to(dev)
    words = enc_mod.linearize(enc, coords)
    words, values, coords = enc_mod.sort_by_key(words, values, coords)
    chunk = -(-max(M, L) // L)
    Mp = chunk * L
    if Mp > M:
        # Same padding rule as build(): value-0 copies of the last element.
        pad = Mp - M
        if M == 0:
            pw = torch.zeros((pad, W), dtype=torch.int32, device=dev)
            pc = torch.zeros((pad, N), dtype=coords.dtype, device=dev)
        else:
            pw = words[-1:].expand(pad, W)
            pc = coords[-1:].expand(pad, N)
        words = torch.cat([words, pw])
        values = torch.cat([values, values.new_zeros(pad)])
        coords = torch.cat([coords, pc])
    cc = coords.reshape(L, chunk, N)
    part_start = cc.amin(dim=1).to(torch.int32)
    part_end = cc.amax(dim=1).to(torch.int32)
    fibers = None
    if compute_reuse:
        not_masks = enc_mod.words_from_np(~enc.mode_masks()).to(dev)
        fibers = ([enc_mod.count_distinct(words[:M] & not_masks[n])
                   for n in range(N)] if M else [1] * N)
    meta = _meta(enc, M, L, part_start.cpu().numpy(),
                 part_end.cpu().numpy(), fibers)
    return AltoTensor(meta=meta, words=words.contiguous(), values=values,
                      part_start=part_start, part_end=part_end)


def oriented_view_device(at: AltoTensor, mode: int) -> OrientedView:
    """Output-oriented permutation for ``mode``, built in torch on the
    tensor's device: a masked bit extract of the target mode, then ONE
    stable sort by row whose permutation carries words and values.
    Bit-identical to the host `oriented_view`."""
    note_ingest("view", (at.meta.enc, mode, at.words.shape[0],
                         str(at.values.dtype), at.words.device.type))
    rows = enc_mod.extract_mode(at.meta.enc, at.words, mode)
    rows, perm = torch.sort(rows, stable=True)
    return OrientedView(meta=at.meta, mode=mode, rows=rows,
                        words=at.words[perm].contiguous(),
                        values=at.values[perm],
                        perm=perm.to(torch.int32))


def to_sparse(at: AltoTensor) -> SparseTensor:
    """Back to COO (drops padding)."""
    coords = at.coords()[:at.nnz].cpu().numpy()
    values = at.values[:at.nnz].cpu().numpy()
    return SparseTensor(at.dims, coords, values)


# ---------------------------------------------------------------------------
# Incremental-ingest host reference (`core.ingest`'s parity oracle)
# ---------------------------------------------------------------------------

MERGE_POLICIES = ("sum", "last")


def grown_dims(dims, coords, override=None) -> tuple[int, ...]:
    """Smallest extents covering ``dims`` and every delta coordinate;
    ``override`` fixes them (it must cover both). Growth can change
    `make_encoding`'s bit assignment, so the merges re-linearize the
    resident stream when the encoding moves."""
    coords = np.asarray(coords)
    need = [int(d) for d in dims]
    if coords.size:
        mx = coords.reshape(-1, len(need)).max(axis=0)
        need = [max(d, int(m) + 1) for d, m in zip(need, mx)]
    if override is None:
        return tuple(need)
    out = tuple(int(d) for d in override)
    if len(out) != len(need) or any(o < n for o, n in zip(out, need)):
        raise ValueError(f"dims override {out} does not cover required "
                         f"extents {tuple(need)}")
    return out


def merge_coo(x: SparseTensor, coords, values, policy: str = "sum",
              dims=None) -> SparseTensor:
    """The merged COO an append denotes: the resident entries, then the
    delta in input order, with the duplicate policy applied over whole
    coordinates (equal linearized keys).

    * ``"sum"``: every entry is kept; duplicates sit adjacent after the
      key sort and add up in every reduction, as `build` treats
      duplicate input.
    * ``"last"``: the last-written entry of each duplicate group keeps its
      value, every earlier one is masked to 0 (a mask, no arithmetic; a
      value 0 acts as a delete).

    The entry count is always ``x.nnz + len(values)``."""
    if policy not in MERGE_POLICIES:
        raise ValueError(f"policy {policy!r}: expected one of "
                         f"{MERGE_POLICIES}")
    coords = np.asarray(coords, dtype=np.int32).reshape(-1, x.ndim)
    values = np.asarray(values).astype(x.values.dtype, copy=False)
    new_dims = grown_dims(x.dims, coords, dims)
    all_c = np.concatenate([x.coords, coords], axis=0)
    all_v = np.concatenate([x.values, values], axis=0)
    if policy == "last" and all_v.shape[0] > 1:
        words = enc_mod.linearize_np(make_encoding(new_dims), all_c)
        order = enc_mod.sort_key_np(words)
        srt = words[order]
        is_last = np.concatenate(
            [np.any(srt[1:] != srt[:-1], axis=-1), [True]])
        keep = np.zeros(all_v.shape[0], dtype=bool)
        keep[order] = is_last
        all_v = np.where(keep, all_v, np.zeros_like(all_v))
    return SparseTensor(new_dims, all_c, all_v)


def merge_reference(at: AltoTensor, coords, values, policy: str = "sum",
                    dims=None, n_partitions: int | None = None,
                    compute_reuse: bool = True) -> AltoTensor:
    """The from-scratch host rebuild an append must equal bit for bit:
    `build` over `merge_coo` under the grown dims, placed on ``at``'s
    device."""
    x = to_sparse(at)
    merged = merge_coo(x, coords, values, policy=policy,
                       dims=grown_dims(x.dims, coords, dims))
    L = at.meta.n_partitions if n_partitions is None else n_partitions
    return build(merged, n_partitions=L, compute_reuse=compute_reuse,
                 device=at.device)
