"""Cached oriented views: (tensor, mode) -> OrientedView.

Every consumer of the oriented traversal needs the same row-sorted copy
of the stream per (tensor, mode). This is the single materialization
point: views are built once per (tensor content, mode) per process and
every caller shares the cached tensors (`plan.build_views` routes here).

* **Route** — a miss builds with `alto.oriented_view_device` (torch
  sort on the tensor's device, ``route="device"``, the default), so
  views of a card-resident tensor never leave the card, or with the host
  numpy `alto.oriented_view` (``route="host"``). The two are
  bit-identical, so the cache never keys on the route. The process
  default comes from ``$REPRO_INGEST`` ("device" | "host").
* **Fingerprint** — the key is content-based: the hashable `AltoMeta`
  plus two order-sensitive 32-bit checksums over the words and over the
  values' bits (native width), reduced on the device and memoized on the
  tensor object, plus the device. Two tensors holding the same built data
  on one device share views; any change to the data changes the key.
* **Latches and bounds** — a miss registers a per-key build latch under
  the global lock and builds outside it, so concurrent drivers build each
  key once without a hit on one tensor waiting behind another tensor's
  build. The cache is LRU-bounded by entry count and by bytes
  (``$REPRO_VIEW_CACHE_SIZE``, default 64; ``$REPRO_VIEW_CACHE_BYTES``,
  default 2 GiB): one view is a full O(nnz) copy. `cache_stats` counts
  hits, misses and builds.
* **Host streams** — a streaming plan's out-of-core copies
  (`core.stream.HostStream`, in host memory) live in the same cache under
  keys tagged ``"stream"``, and count against the same bounds.
* **Pull orders** — the recursive routes' fixed-order pull
  (`kernels.ops.pull_reduction`) sorts the same ``L·T`` Temp rows for
  every call on a (tensor, mode); `get_pull_order` keeps that order under
  keys tagged ``"pull"``, which also carry the partitioning (`AltoMeta`).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading

import torch

from repro_torch.core import alto, faults, heuristics
from repro_torch.core import mttkrp as mttkrp_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.stream import HostStream

DEFAULT_CACHE_SIZE = 64
DEFAULT_CACHE_BYTES = 2 * 1024 ** 3

_CACHE: "collections.OrderedDict[tuple, OrientedView]" = \
    collections.OrderedDict()
_CACHE_BYTES: dict[tuple, int] = {}
_STATS = {"hits": 0, "misses": 0, "builds": 0, "invalidated": 0}
_LOCK = threading.Lock()
_PENDING: dict[tuple, threading.Event] = {}

_FP_ATTR = "_ingest_fingerprint"
_MASK32 = 0xFFFFFFFF


def default_route() -> str:
    """Process-wide view build route: ``$REPRO_INGEST`` or "device"."""
    route = os.environ.get("REPRO_INGEST", "device")
    if route not in ("device", "host"):
        raise ValueError(f"REPRO_INGEST={route!r}: expected device|host")
    return route


def _limits() -> tuple[int, int]:
    return (int(os.environ.get("REPRO_VIEW_CACHE_SIZE", DEFAULT_CACHE_SIZE)),
            int(os.environ.get("REPRO_VIEW_CACHE_BYTES",
                               DEFAULT_CACHE_BYTES)))


@dataclasses.dataclass(frozen=True)
class PullOrder:
    """The pull's pieces of one (tensor, mode): the global row of each
    Temp row in sorted order, ``(L·T, 1)`` int32 (the fix-up's one-slot
    layout), and the permutation of the ``L·T`` Temp rows that sorts them
    (`core.mttkrp.pull_pieces`)."""
    rows: torch.Tensor
    order: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.order))


def _view_bytes(v) -> int:
    if isinstance(v, (HostStream, PullOrder)):
        return v.nbytes()
    return sum(a.numel() * a.element_size()
               for a in (v.rows, v.words, v.values, v.perm))


def _u32_mix(x: torch.Tensor, salt: int) -> int:
    """Order-sensitive 32-bit checksum of a 1-D int32 tensor (wrapping
    arithmetic in int64; only the low 32 bits of each product are kept)."""
    u = x.to(torch.int64) & _MASK32
    idx = torch.arange(u.shape[0], dtype=torch.int64, device=u.device)
    mixed = ((u ^ ((idx * 0x9E3779B1) & _MASK32)) * salt) & _MASK32
    return int(mixed.sum()) & _MASK32


def fingerprint(at: AltoTensor) -> tuple:
    """Content fingerprint of a built tensor, memoized on the object:
    (meta, padded length, words checksum, values checksum)."""
    fp = getattr(at, _FP_ATTR, None)
    if fp is None:
        w = _u32_mix(at.words.reshape(-1), 0x85EBCA6B)
        v = _u32_mix(at.values.contiguous().view(torch.int32).reshape(-1),
                     0xC2B2AE35)
        fp = (at.meta, at.words.shape[0], w, v)
        setattr(at, _FP_ATTR, fp)
    return fp


def mode_fingerprint(at: AltoTensor, mode: int) -> tuple:
    """Per-(tensor content, device, mode) key. Excludes the partitioning
    fields of `AltoMeta`: a view is a permutation of the padded stream, so
    a re-tile of the same stream keeps every cached view valid. The device
    is part of the key: equal content on the CPU and on the card are two
    views."""
    meta, Mp, w, v = fingerprint(at)
    return (meta.enc, meta.nnz, Mp, w, v, str(at.device), int(mode))


def _rebind_meta(key: tuple, entry: OrientedView,
                 at: AltoTensor) -> OrientedView:
    """A re-tile can hit an entry built under another `AltoMeta`; the
    tensors are identical, only the meta tag is stale. Rebind it and store
    the rebound entry so repeated gets return the identical object."""
    if entry.meta == at.meta:
        return entry
    entry = dataclasses.replace(entry, meta=at.meta)
    with _LOCK:
        if key in _CACHE:
            _CACHE[key] = entry
    return entry


def _get_or_build(key: tuple, build):
    """Latched lookup: the first thread to miss ``key`` builds it outside
    the global lock; concurrent misses on the same key wait on its event;
    every other key proceeds."""
    while True:
        with _LOCK:
            view = _CACHE.get(key)
            if view is not None:
                _STATS["hits"] += 1
                _CACHE.move_to_end(key)
                return view
            event = _PENDING.get(key)
            if event is None:
                _PENDING[key] = threading.Event()
                _STATS["misses"] += 1
                _STATS["builds"] += 1
        if event is not None:
            event.wait()
            continue
        try:
            view = build()
        except BaseException:
            with _LOCK:
                _PENDING.pop(key).set()   # unblock waiters; one re-builds
            raise
        with _LOCK:
            _CACHE[key] = view
            _CACHE_BYTES[key] = _view_bytes(view)
            max_entries, max_bytes = _limits()
            while len(_CACHE) > max(1, max_entries) or (
                    len(_CACHE) > 1
                    and sum(_CACHE_BYTES.values()) > max_bytes):
                old, _ = _CACHE.popitem(last=False)
                _CACHE_BYTES.pop(old, None)
            _PENDING.pop(key).set()
        return view


def get_view(at: AltoTensor, mode: int,
             route: str | None = None) -> OrientedView:
    """The oriented view for ``(at, mode)``: cached, built on a miss by
    ``route`` (default `default_route`; the ``views.build`` fault site
    fails the build: the latch releases its waiters and the next caller
    builds)."""
    key = ("view", *mode_fingerprint(at, mode))

    def build():
        faults.inject("views.build")
        route_ = route or default_route()
        return (alto.oriented_view_device(at, mode) if route_ == "device"
                else alto.oriented_view(at, mode))

    return _rebind_meta(key, _get_or_build(key, build), at)


def get_stream(at: AltoTensor, mode: int) -> HostStream:
    """The host-resident stream for ``(at, mode)``: cached, built on a
    miss (`stream.host_stream`), under a key tagged ``"stream"`` so a
    tensor decomposed both in core and out of core keeps the two apart.
    Eviction is safe mid-flight: a chunked executor holds the stream's
    tensors, which outlive the cache entry."""
    key = ("stream", *mode_fingerprint(at, mode))

    def build():
        faults.inject("views.build")
        return stream_mod.host_stream(at, mode)

    return _rebind_meta(key, _get_or_build(key, build), at)


def get_pull_order(at: AltoTensor, mode: int) -> PullOrder:
    """The pull order of ``(at, mode)``: cached, sorted on a miss. The key
    adds the tensor's `AltoMeta` to the mode's content key, since the
    order follows the partition boxes and ``temp_rows``."""
    key = ("pull", *mode_fingerprint(at, mode), at.meta)

    def build():
        rows, order = mttkrp_mod.pull_pieces(
            at.part_start[:, mode], at.meta.temp_rows[mode],
            at.meta.dims[mode])
        return PullOrder(rows.to(torch.int32)[:, None].contiguous(), order)
    return _get_or_build(key, build)


def build_views(at: AltoTensor, plan, route: str | None = None) -> dict:
    """Cached views for exactly the modes ``plan`` routes oriented, built
    on a miss by ``route`` (`get_view`); host streams in their place when
    the plan streams; every mode's view under a sharded plan, whose modes
    all cut the row-sorted stream."""
    sharded = getattr(plan, "shards", None) is not None
    modes = [m.mode for m in plan.modes
             if sharded or heuristics.is_oriented(m.traversal)]
    if getattr(plan, "streaming", None):
        return {m: get_stream(at, m) for m in modes}
    return {m: get_view(at, m, route=route) for m in modes}


def invalidate(at: AltoTensor, modes=None) -> int:
    """Drop the cached views and streams of ``at`` (all modes, or only
    ``modes``); returns how many entries were evicted."""
    if modes is None:
        modes = range(len(at.dims))
    fps = {mode_fingerprint(at, int(m)) for m in modes}
    with _LOCK:
        dead = [k for k in _CACHE
                if k[1:] in fps or (k[0] == "pull" and k[1:-1] in fps)]
        for k in dead:
            del _CACHE[k]
            _CACHE_BYTES.pop(k, None)
        _STATS["invalidated"] += len(dead)
    return len(dead)


def invalidate_changed(old_at: AltoTensor, new_at: AltoTensor) -> int:
    """After an append: drop ``old_at``'s cached entries only for the modes
    whose `mode_fingerprint` changed between the two tensors. An empty
    "sum" delta or a re-tile changes none, so every view keeps serving; a
    content change stales every mode (each view permutes the whole
    stream), released at once instead of aging out of the LRU."""
    stale = [m for m in range(len(old_at.dims))
             if mode_fingerprint(old_at, m) != mode_fingerprint(new_at, m)]
    return invalidate(old_at, modes=stale) if stale else 0


def cache_stats() -> dict[str, int]:
    """Hit/miss/build counters plus current size and bytes."""
    with _LOCK:
        out = dict(_STATS)
        out["size"] = len(_CACHE)
        out["bytes"] = sum(_CACHE_BYTES.values())
    return out


def cache_clear() -> None:
    with _LOCK:
        _CACHE.clear()
        _CACHE_BYTES.clear()
        for k in _STATS:
            _STATS[k] = 0
