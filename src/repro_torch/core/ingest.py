"""Incremental ingest: merge a delta into the resident ALTO stream on the
device, and warm-start the drivers from the previous solve.

Nonzeros keep arriving; a from-scratch `alto.build_device` per delta
throws away the one expensive property the resident tensor has: its
stream is sorted. `append_delta` linearizes the delta, concatenates it
after the resident stream and runs the same stable multi-word key sort
`build_device` uses (`encoding.sort_by_key`) over the whole, then takes
the partition boxes from the decoded, padded stream, as `build_device`
does. Only the (L, N) boxes and N fiber counts come back to the host.

Bit for bit the host rebuild (`alto.merge_reference`): the resident
stream is the stable sort of the old COO, so the stable sort of
``[resident; delta]`` is the stable sort of the concatenated COO —
order, padding, boxes and meta. The duplicate policies keep that:

* ``"sum"`` keeps every entry (a permutation);
* ``"last"`` masks all but the last entry of each equal key to value 0,
  from sorted adjacency, with no arithmetic.

Growth re-encodes: when the delta pushes a mode past its extent,
`encoding.make_encoding` may move the index bits, so the resident words
go through the K4 decode (`kernels.ops.delinearize`) and
`encoding.linearize` into the new encoding, an exact integer transform.

`grow_factors` backs ``warm_start=`` on `cpals.cp_als` and
`cpapr.cp_apr`: the previous factors, with rows for the grown extents.

`dist.cpd.sharded_append_delta` linearizes a delta across the ranks of a
process group and hands the gathered words to `append_linearized`.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import alto, faults
from repro_torch.core import encoding as enc_mod
from repro_torch.core import views as views_mod
from repro_torch.core.alto import AltoTensor
from repro_torch.core.encoding import AltoEncoding, make_encoding
from repro_torch.kernels import ops

POLICIES = alto.MERGE_POLICIES


def _merge_device(at: AltoTensor, delta: torch.Tensor,
                  delta_values: torch.Tensor, new_enc: AltoEncoding, L: int,
                  policy: str, compute_reuse: bool, delta_form: str):
    """The merge on ``at``'s device: ``delta`` is (D, N) int32
    coordinates (``"coords"``) or (D, W) words under ``new_enc``
    (``"words"``). Returns (words, values, part_start, part_end, fiber
    counts or None)."""
    old_enc = at.meta.enc
    M = at.meta.nnz
    D = int(delta.shape[0])
    N, W = new_enc.ndim, new_enc.n_words
    alto.note_ingest("merge", (old_enc, new_enc, L, M, D, policy,
                               bool(compute_reuse), delta_form,
                               str(at.values.dtype), at.words.device.type))
    MD = M + D
    chunk = -(-max(MD, L) // L)
    Mp = chunk * L
    rw = at.words[:M]
    if new_enc != old_enc:
        # Growth moved the index bits: an exact integer round trip.
        rw = enc_mod.linearize(new_enc, ops.delinearize(old_enc, rw))
    dw = delta if delta_form == "words" else enc_mod.linearize(new_enc,
                                                               delta)
    words = torch.cat([rw, dw.to(torch.int32)])
    values = torch.cat([at.values[:M], delta_values])
    # [sorted resident; delta] stably sorted is the stable sort of the
    # concatenated COO: ties keep resident first, then delta input order.
    words, values = enc_mod.sort_by_key(words, values)
    if policy == "last" and MD > 1:
        is_last = torch.cat([(words[1:] != words[:-1]).any(dim=-1),
                             torch.ones(1, dtype=torch.bool,
                                        device=words.device)])
        values = torch.where(is_last, values, torch.zeros_like(values))
    if Mp > MD:
        # build()'s padding rule: value-0 copies of the last element.
        pad = Mp - MD
        pw = (torch.zeros((pad, W), dtype=torch.int32, device=words.device)
              if MD == 0 else words[-1:].expand(pad, W))
        words = torch.cat([words, pw])
        values = torch.cat([values, values.new_zeros(pad)])
    words = words.contiguous()
    # The K4 decode inverts linearize: these are the coordinates build()
    # takes its boxes from.
    cc = ops.delinearize(new_enc, words).reshape(L, chunk, N)
    part_start = cc.amin(dim=1).to(torch.int32)
    part_end = cc.amax(dim=1).to(torch.int32)
    fibers = None
    if compute_reuse:
        not_masks = enc_mod.words_from_np(~new_enc.mode_masks()).to(
            words.device)
        fibers = ([enc_mod.count_distinct(words[:MD] & not_masks[n])
                   for n in range(N)] if MD else [1] * N)
    return words, values, part_start, part_end, fibers


def _finalize(out, new_enc: AltoEncoding, MD: int, L: int) -> AltoTensor:
    """The merged tensor and its meta, from the (L, N) boxes and N fiber
    counts: the only host transfer, never the O(nnz) stream."""
    words, values, part_start, part_end, fibers = out
    meta = alto._meta(new_enc, MD, L, part_start.cpu().numpy(),
                      part_end.cpu().numpy(), fibers)
    return AltoTensor(meta=meta, words=words, values=values,
                      part_start=part_start, part_end=part_end)


def _append(at: AltoTensor, delta, delta_values, new_dims, delta_form: str,
            policy: str, n_partitions, compute_reuse,
            invalidate_stale: bool) -> AltoTensor:
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r}: expected one of {POLICIES}")
    new_enc = make_encoding(new_dims)
    L = (at.meta.n_partitions if n_partitions is None
         else max(1, int(n_partitions)))
    if compute_reuse is None:
        # The resident tensor's choice (NaN reuse: it was off).
        compute_reuse = not math.isnan(at.meta.fiber_reuse[0])
    # The merge is functional (the resident tensor is never written), so
    # an interruption here leaves `at` serviceable and a retry re-runs it.
    faults.inject("ingest.merge")
    out = _merge_device(at, delta, delta_values, new_enc, L, policy,
                        bool(compute_reuse), delta_form)
    new_at = _finalize(out, new_enc, at.meta.nnz + int(delta.shape[0]), L)
    if invalidate_stale:
        # Only modes whose content fingerprint moved lose their views: an
        # empty "sum" delta drops nothing.
        views_mod.invalidate_changed(at, new_at)
    return new_at


def _values(at: AltoTensor, values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values)).to(
        device=at.device, dtype=at.values.dtype).reshape(-1)


def append_delta(at: AltoTensor, coords, values, *, policy: str = "sum",
                 dims: Sequence[int] | None = None,
                 n_partitions: int | None = None,
                 compute_reuse: bool | None = None,
                 invalidate_stale: bool = True) -> AltoTensor:
    """Merge a COO delta into ``at`` on its device; bit for bit
    `alto.merge_reference(at, coords, values, ...)`.

    Extents grow to cover the delta (``dims`` overrides, e.g. to reserve
    headroom so the encoding stays across appends); ``n_partitions``
    defaults to the resident tiling. The new meta counts ``at.nnz +
    len(values)`` entries: duplicates add up ("sum") or are masked
    ("last"), never compacted."""
    coords = np.asarray(coords, dtype=np.int32).reshape(-1, len(at.dims))
    new_dims = alto.grown_dims(at.dims, coords, dims)
    return _append(at, torch.from_numpy(coords).to(at.device),
                   _values(at, values), new_dims, "coords", policy,
                   n_partitions, compute_reuse, invalidate_stale)


def append_linearized(at: AltoTensor, delta_words, values,
                      dims: Sequence[int], *, policy: str = "sum",
                      n_partitions: int | None = None,
                      compute_reuse: bool | None = None,
                      invalidate_stale: bool = True) -> AltoTensor:
    """`append_delta` for a delta already linearized under
    ``make_encoding(dims)``: (D, W) uint32 words, or the port's int32 word
    tensor (`encoding.linearize`), taken to ``at``'s device as it is.
    ``dims`` is explicit (words carry no extents) and must cover the
    resident dims."""
    new_dims = alto.grown_dims(at.dims, np.empty((0, len(at.dims))), dims)
    W = make_encoding(new_dims).n_words
    if isinstance(delta_words, torch.Tensor):
        if delta_words.dtype != torch.int32:
            raise ValueError(f"word tensor of dtype {delta_words.dtype}, "
                             f"expected torch.int32")
        words = delta_words.reshape(-1, W).to(at.device)
    else:
        words = enc_mod.words_from_np(np.asarray(
            delta_words, np.uint32).reshape(-1, W)).to(at.device)
    return _append(at, words, _values(at, values), new_dims, "words",
                   policy, n_partitions, compute_reuse, invalidate_stale)


# ---------------------------------------------------------------------------
# Warm-start factor growth (the drivers' ``warm_start=``)
# ---------------------------------------------------------------------------

def grow_factors(warm, dims: Sequence[int], rank: int, *, seed: int = 0,
                 dtype=None, device=None, positive: bool = False):
    """A previous solve's factors at (possibly grown) ``dims``.

    ``warm`` is a `CpalsResult` / `CpaprResult`, ``(lam, factors)`` or a
    factor list. Existing rows are kept as they are; rows of grown extents
    come from `cpals.init_factors` with ``seed``. Returns ``(lam,
    factors)``, ``lam`` None when ``warm`` has no weights. A shrunk extent
    or another rank raises. ``positive=True`` (CP-APR) fills grown rows
    small and positive, clamps every entry to at least 1e-10 and rescales
    the columns to sum 1, the form the multiplicative updates expect."""
    lam = getattr(warm, "lam", None)
    factors = getattr(warm, "factors", None)
    if factors is None:
        if isinstance(warm, tuple) and len(warm) == 2:
            lam, factors = warm
        else:
            factors = warm
    factors = [torch.as_tensor(A) for A in factors]
    dims = tuple(int(d) for d in dims)
    if len(factors) != len(dims):
        raise ValueError(f"warm start has {len(factors)} factors for "
                         f"{len(dims)} modes")
    dtype = dtype or factors[0].dtype
    device = device or factors[0].device
    fresh = None
    out = []
    for n, (A, I) in enumerate(zip(factors, dims)):
        A = A.to(device=device, dtype=dtype)
        if A.dim() != 2 or A.shape[1] != rank:
            raise ValueError(f"warm factor {n} has shape {tuple(A.shape)}; "
                             f"expected (*, {rank})")
        if A.shape[0] > I:
            raise ValueError(f"mode {n} shrank: warm factor has "
                             f"{A.shape[0]} rows, dims say {I}")
        if A.shape[0] < I:
            if fresh is None:
                from repro_torch.core import cpals  # the drivers import us
                fresh = cpals.init_factors(dims, rank, seed=seed,
                                           dtype=dtype, device=device)
            grown = fresh[n][A.shape[0]:I]
            if positive:
                # Small positive mass: the converged model moves little
                # and the multiplicative updates' domain stays open.
                grown = grown.clamp_min(0.1) / max(1, I)
            A = torch.cat([A, grown])
        if positive:
            A = A.clamp_min(1e-10)
            A = A / A.sum(dim=0, keepdim=True)
        out.append(A.contiguous())
    if lam is not None:
        lam = torch.as_tensor(lam).to(device=device, dtype=dtype)
    return lam, out
