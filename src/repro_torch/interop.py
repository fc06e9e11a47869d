"""Carry state from the JAX package into the port.

The JAX package's objects are handed over as numpy arrays plus plain ints
and tuples — this module imports nothing of that package — and come back
as the port's `AltoTensor`, `OrientedView`, `HostStream` and factor
tensors on ``device`` (default ``cuda``; a host stream stays on the
CPU), an LM `Model` and its optimizer's state. With these, both packages
compute on the same inputs. `lm_train_tree` goes the other way: a
model's parameters and optimizer state in the JAX trainer's layout.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.alto import AltoMeta, AltoTensor, OrientedView
from repro_torch.core.encoding import make_encoding, words_from_np
from repro_torch.core.stream import HostStream
from repro_torch.device import resolve_device


def alto_meta(dims: Sequence[int], nnz: int, n_partitions: int,
              temp_rows: Sequence[int],
              fiber_reuse: Sequence[float]) -> AltoMeta:
    return AltoMeta(enc=make_encoding(dims), nnz=int(nnz),
                    n_partitions=int(n_partitions),
                    temp_rows=tuple(int(t) for t in temp_rows),
                    fiber_reuse=tuple(float(f) for f in fiber_reuse))


def alto_tensor(words, values, part_start, part_end, *, dims, nnz,
                n_partitions, temp_rows, fiber_reuse,
                device=None) -> AltoTensor:
    """An `AltoTensor` from (Mp, W) u32 words, (Mp,) values, (L, N) int32
    partition boxes and the meta fields."""
    dev = resolve_device(device)
    return AltoTensor(
        meta=alto_meta(dims, nnz, n_partitions, temp_rows, fiber_reuse),
        words=words_from_np(np.asarray(words)).to(dev),
        values=torch.from_numpy(np.array(values)).to(dev),
        part_start=torch.from_numpy(np.array(part_start, np.int32)).to(dev),
        part_end=torch.from_numpy(np.array(part_end, np.int32)).to(dev))


def oriented_view(meta: AltoMeta, mode: int, rows, words, values, perm,
                  device=None) -> OrientedView:
    """An `OrientedView` of ``mode`` from its row-sorted arrays."""
    dev = resolve_device(device)
    return OrientedView(
        meta=meta, mode=int(mode),
        rows=torch.from_numpy(np.array(rows, np.int32)).to(dev),
        words=words_from_np(np.asarray(words)).to(dev),
        values=torch.from_numpy(np.array(values)).to(dev),
        perm=torch.from_numpy(np.array(perm, np.int32)).to(dev))


def host_stream(meta: AltoMeta, mode: int, length: int, rows, words,
                values, checksum: int | None = None) -> HostStream:
    """A `HostStream` from the JAX package's padded host arrays (rows
    int32, words uint32, values): copies in (unpinned) CPU tensors."""
    return HostStream(
        meta=meta, mode=int(mode), length=int(length),
        rows=torch.from_numpy(np.array(rows, np.int32)),
        words=words_from_np(np.array(words)),
        values=torch.from_numpy(np.array(values)), checksum=checksum)


def factors(arrays, device=None) -> list[torch.Tensor]:
    """Factor matrices (or ``lam``) as contiguous tensors on ``device``."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) or tensor as a
    CPU tensor of its dtype."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params(cfg, tree, device=None, dtype=None):
    """A port `models.model.Model` holding the JAX package's parameter tree.

    ``tree`` is `model_def`'s layout as nested dicts of numpy arrays (the
    JAX package's ``jax.tree.map(np.asarray, params)``, bfloat16
    included) or CPU tensors (`lm_train_tree`'s): each
    ``blocks_{pos}`` leaf's leading axis is unstacked into layer ``r ·
    len(block_pattern) + pos``, ``enc_blocks`` into the encoder's layers.
    ``load_state_dict`` checks every shape and raises on a missing or extra
    leaf. ``dtype`` (default: the arrays' own) and ``device`` (default
    ``cuda``) are the parameters'."""
    from repro_torch.models.model import Model
    dev = resolve_device(device)
    plen = len(cfg.block_pattern)
    stacked = {f"blocks_{pos}": cfg.n_repeats for pos in range(plen)}
    if cfg.is_encdec:
        stacked["enc_blocks"] = cfg.encoder_layers

    def flat(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{prefix}.{k}")
        else:
            yield prefix, _tensor(t)

    state = {}
    for top, sub in tree.items():
        for name, a in flat(sub, top):
            if top not in stacked:
                state[name] = a
                continue
            n, rest = stacked[top], name[len(top) + 1:]
            if a.ndim == 0 or a.shape[0] != n:
                raise ValueError(f"{name}: leading axis {a.shape[:1]}, "
                                 f"expected {n} stacked layers")
            for r in range(n):
                layer = (f"enc_layers.{r}" if top == "enc_blocks"
                         else f"layers.{r * plen + int(top[7:])}")
                state[f"{layer}.{rest}"] = a[r]
    model = Model(cfg)
    model.load_state_dict({k: a.to(device=dev, dtype=dtype)
                           for k, a in state.items()}, assign=True)
    return model


def _stage_leaves(tree, fn):
    """``tree`` with ``fn`` on each ``blocks_{pos}`` leaf (numpy arrays or
    tensors), every other leaf as it is."""
    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else fn(t)
    return {k: walk(v) if k.startswith("blocks_") else v
            for k, v in tree.items()}


def lm_pipeline_params(cfg, tree, n_stages: int, device=None, dtype=None):
    """The JAX package's pipeline tree (`dist.pipeline.to_pipeline_params`:
    each ``blocks_{pos}`` leaf ``(n_stages, per, ...)``) as the port's
    `dist.pipeline.PipelineParams`, via `lm_params`."""
    from repro_torch.dist.pipeline import to_pipeline_params

    def merge(a):
        a = _tensor(a)
        if a.shape[0] != n_stages:
            raise ValueError(f"leading axis {a.shape[0]}, expected "
                             f"{n_stages} stages")
        return a.reshape((-1,) + tuple(a.shape[2:]))
    model = lm_params(cfg, _stage_leaves(tree, merge), device=device,
                      dtype=dtype)
    return to_pipeline_params(cfg, model, n_stages)


def lm_pipeline_tree(cfg, pp) -> dict:
    """Inverse of `lm_pipeline_params`: the JAX pipeline tree as CPU
    tensors (the stages' layers stacked ``(n_stages, per, ...)``)."""
    from repro_torch.models.model import jax_leaves
    n = pp.n_stages
    params: dict = {}
    for leaf in jax_leaves(pp.model):
        ps = [p.detach().cpu() for p in leaf.params]
        if leaf.stacked:
            t = torch.stack(ps)
            _put(params, leaf.name, t.reshape((n, -1) + tuple(t.shape[1:])))
        else:
            _put(params, leaf.name, ps[0])
    return params


def _put(tree: dict, path: str, value) -> None:
    *heads, last = path.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def _get(tree: dict, path: str):
    for h in path.split("."):
        tree = tree[h]
    return tree


def lm_train_tree(model, optimizer) -> tuple[dict, dict]:
    """``(params, opt_state)`` in the JAX trainer's layout, as CPU tensors:
    `model_def`'s tree with each stacked leaf's layers stacked, and the
    optimizer's ``{"count", "m", "v"}`` (AdamW) or ``{"count", "m",
    "vr", "vc"}`` (Adafactor) over the same tree; ``count`` int32. This
    is the tree the JAX launcher checkpoints."""
    from repro_torch.models.model import jax_leaves
    params: dict = {}
    for leaf in jax_leaves(model):
        ps = [p.detach().cpu() for p in leaf.params]
        _put(params, leaf.name, torch.stack(ps) if leaf.stacked else ps[0])
    state: dict = {"count": torch.tensor(optimizer.count,
                                         dtype=torch.int32)}
    for group in optimizer.param_groups:
        for key in _state_keys(group):
            _put(state.setdefault(key, {}), group["leaf"],
                 group[key].detach().cpu())
    return params, state


def _state_keys(group: dict) -> list[str]:
    return [k for k in ("m", "v", "vr", "vc") if k in group]


def lm_opt_state(optimizer, tree: dict) -> None:
    """Load the JAX optimizer state ``tree`` (``{"count", "m", "v"}`` or
    ``{"count", "m", "vr", "vc"}``, numpy arrays or CPU tensors, each leaf
    in the stacked shape, bfloat16 included) into ``optimizer`` in place;
    raises on a missing leaf or a wrong shape."""
    for group in optimizer.param_groups:
        for key in _state_keys(group):
            t = _tensor(_get(tree[key], group["leaf"]))
            if tuple(t.shape) != tuple(group[key].shape):
                raise ValueError(f"{key}.{group['leaf']}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(group[key].shape)}")
            group[key].copy_(t)
    optimizer.count = int(np.asarray(tree["count"]))
