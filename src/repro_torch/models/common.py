"""Parameter definitions, the module that holds them, and shared layers.

Each model module first builds a tree (nested dicts) of `ParamDef` (shape,
logical axes, init law), as the JAX package does. `ParamModule` turns a def
tree into an `nn.Module` whose leaves are parameters and whose dicts are
submodules, under the same names, so ``p["wq"]`` reads as the JAX
``params["wq"]``. `materialize` draws a def tree's tensors; over
`named_defs` it gives a model's `state_dict`.

The mesh helpers map a def tree (`model_def`, an optimizer's
`state_defs`, or `named_defs`'s flat dict) leaf by leaf: `abstract` to
``meta`` tensors (the dry run's stand-ins, never allocated), `shardings`
and `shardings_inference` to `sharding.Sharding`s, `specs` to specs, and
`bytes_per_device` to the bytes one device holds under them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import sharding as shd

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "fan_in"      # fan_in | zeros | ones | normal | embed
    axis: int = -2            # fan-in axis for fan_in init

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"{self.shape} vs {self.logical}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def def_paths(defs: Tree, prefix: str = "") -> dict:
    """A def tree's leaves by dotted path, in sorted-key order (JAX's
    flatten order)."""
    if is_def(defs):
        return {prefix: defs}
    out = {}
    for k in sorted(defs):
        out.update(def_paths(defs[k], f"{prefix}.{k}" if prefix else k))
    return out


def n_params(defs: Tree) -> int:
    return sum(int(np.prod(d.shape)) for d in def_paths(defs).values())


def map_defs(fn, defs: Tree) -> Tree:
    """``fn`` on every `ParamDef` of a def tree, the tree kept."""
    if is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def abstract(defs: Tree, dtype=torch.float32) -> Tree:
    """The def tree's tensors on ``meta``: shapes and dtype, no storage."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def shardings(defs: Tree, mesh) -> Tree:
    return map_defs(lambda d: shd.sharding_for(mesh, d.logical, d.shape),
                    defs)


def shardings_inference(defs: Tree, mesh, keep_fsdp: bool = False) -> Tree:
    """Param shardings for serving: TP/EP axes only. FSDP sharding is a
    *training* trade (it turns every step into a param all-gather); for
    decode it makes the collective term the bottleneck, so unless the
    model cannot fit per-device without it (``keep_fsdp=True``) params
    replicate across data/pod."""
    if keep_fsdp:
        return shardings(defs, mesh)

    def one(d):
        logical = tuple(None if ax == "fsdp" else ax for ax in d.logical)
        return shd.sharding_for(mesh, logical, d.shape)
    return map_defs(one, defs)


def bytes_per_device(defs: Tree, mesh, dtype_bytes: int = 2,
                     keep_fsdp: bool = False) -> int:
    """Exact per-device param bytes under the given sharding policy."""
    shape = shd.mesh_shape(mesh)
    shds = (shardings(defs, mesh) if keep_fsdp
            else shardings_inference(defs, mesh, False))
    total = 0
    for path, d in def_paths(defs).items():
        s = def_paths_get(shds, path)
        shard = 1
        for entry in s.spec:
            for ax in shd.spec_axes(entry):
                shard *= shape[ax]
        total += int(np.prod(d.shape)) * dtype_bytes // max(1, shard)
    return total


def def_paths_get(tree: Tree, path: str):
    """The leaf at a `def_paths` path of a tree of the same layout."""
    for k in path.split(".") if path else ():
        tree = tree[k]
    return tree


def specs(defs: Tree, mesh) -> Tree:
    return map_defs(lambda d: shd.spec_for(mesh, d.logical, d.shape), defs)


def _init_one(d: ParamDef, generator: torch.Generator, dtype,
              device) -> torch.Tensor:
    """One tensor under ``d``'s init law, drawn in ``dtype`` on ``device``
    (a full-size expert stack is never staged in float32)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    t = torch.randn(d.shape, generator=generator, dtype=dtype, device=device)
    if d.init == "normal":
        return t.mul_(0.02)
    if d.init == "embed":
        return t
    fan_in = d.shape[d.axis] if len(d.shape) > 1 else d.shape[0]
    return t.mul_(1.0 / np.sqrt(max(1, fan_in)))


def materialize(defs: Tree, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Tree:
    """The def tree's tensors, drawn from ``generator`` one at a time in
    sorted-key order (``device`` default ``cuda``; the generator must live
    on that device). JAX's PRNG cannot be reproduced: the same seed gives
    other weights than the JAX package's `materialize`."""
    dev = resolve_device(device)

    def one(t):
        if is_def(t):
            return _init_one(t, generator, dtype, dev)
        return {k: one(t[k]) for k in sorted(t)}
    return one(defs)


class ParamModule(nn.Module):
    """A def tree as a module: each `ParamDef` a parameter, created empty on
    ``meta``, each dict a submodule. Fill it with ``load_state_dict(...,
    assign=True)``, which raises on a missing or extra key and on a wrong
    shape. Parameters are created frozen (serving); a trainer turns them
    on with ``requires_grad_(True)``."""

    def __init__(self, defs: dict):
        super().__init__()
        self.defs = {}
        for name, d in defs.items():
            if is_def(d):
                self.defs[name] = d
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, device="meta"),
                    requires_grad=False))
            else:
                self.add_module(name, ParamModule(d))

    def __getitem__(self, name: str):
        return getattr(self, name)


def named_defs(module: nn.Module) -> dict:
    """Every parameter's def below ``module``, keyed by its `state_dict`
    name."""
    return {f"{prefix}.{k}" if prefix else k: d
            for prefix, mod in module.named_modules()
            if isinstance(mod, ParamModule) for k, d in mod.defs.items()}


# -----------------------------------------------------------------------
# layers
# -----------------------------------------------------------------------

def einsum(eq: str, *ops):
    """`torch.einsum` with JAX's dtype promotion: mixed operands (a float32
    recurrence output against bfloat16 weights, a bfloat16 cache read in a
    float32 model) are computed in their common dtype. Under a mesh,
    DTensor operands contract by `sharding.einsum`'s rule."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    if shd.current_mesh() is not None:
        return shd.einsum(eq, *(o.to(dt) for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def rmsnorm_def(dim: int) -> Tree:
    return {"scale": ParamDef((dim,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_def(dim: int) -> Tree:
    return {"scale": ParamDef((dim,), ("embed",), init="ones"),
            "bias": ParamDef((dim,), ("embed",), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def embed_def(vocab: int, dim: int) -> Tree:
    return {"tokens": ParamDef((vocab, dim), ("vocab", "fsdp"),
                               init="embed")}


def _gather_rows(table, ids):
    return table[ids]


# under a mesh each device gathers its own rows' tokens from the whole
# table (DTensor's rule for the gather's backward, an indexed put, fails
# on sharded indices in some torch releases)
_embed_rows = shd.local_map(_gather_rows, ((None, None), ("batch",)),
                            (("batch",),))


def embed(p, ids):
    return _embed_rows(p["tokens"], ids)


def unembed(p, x):
    """Logits in float32."""
    return einsum("...d,vd->...v", x.float(), p["tokens"].float())


def swiglu(x_gate, x_up):
    return F.silu(x_gate) * x_up
