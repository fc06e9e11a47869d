"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) over a DeviceMesh.

Parameters and activations are annotated with *logical* axis names; a rule
table maps them to mesh dimensions. Any mapping whose dimension size is not
divisible by the mesh-axis product is dropped (8 KV heads cannot shard over
a 16-way model axis, so they replicate), so one rule table serves every
architecture × mesh combination.

A spec is what the JAX package's ``PartitionSpec`` holds, as a tuple: per
tensor dimension a mesh-dimension name, a tuple of names, or ``None``.
`placements_for` turns it into DTensor placements, `sharding_for` into a
`Sharding` (mesh + placements), and `act` / `constrain` redistribute an
activation to it. Without an active mesh (`use_mesh`) `act` returns its
argument object itself, so every single-device path is untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# logical axis -> preferred mesh axes (in priority order)
RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # DP
    "fsdp": ("pod", "data"),        # param/optimizer ZeRO-3 axis
    "heads": ("model",),            # TP
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),           # EP over the TP axis
    "expert_dp": ("data",),         # EP over the data axis (weights stay
                                    # put; token all-to-all — 1T-class MoE)
    "vocab": ("model",),
    "seq_sharded": ("model",),      # SP for long-context KV caches
    "seq_full": ("data", "model"),  # SP when batch cannot shard (B=1)
    # unsharded logicals
    "layers": (), "seq": (), "embed_act": (), "head_dim": (), "state": (),
    "embed": (), "conv": (), "capacity": (), "any": (),
}

Spec = tuple


def mesh_shape(mesh) -> dict:
    """``{name: size}`` of a `DeviceMesh` (or of any object with a
    ``shape`` dict, as the JAX mesh has)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _mesh_axes(shape: dict, names: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(n for n in names if n in shape)


def spec_for(mesh, logical: Sequence[str | None],
             dims: Sequence[int] | None = None) -> Spec:
    """The spec for logical axes, dropping non-divisible mappings and
    deduplicating mesh axes across dims (first dim wins); the entries of
    the JAX package's ``PartitionSpec``."""
    shape = mesh_shape(mesh)
    out = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in _mesh_axes(shape, RULES.get(name, ()))
                     if a not in used)
        if not axes:
            out.append(None)
            continue
        size = dims[i] if dims is not None else None
        if size is not None:
            shard = 1
            for a in axes:
                shard *= shape[a]
            if size % shard:
                # try progressively fewer axes (suffix first)
                ok = None
                for k in range(len(axes) - 1, 0, -1):
                    s = 1
                    for a in axes[:k]:
                        s *= shape[a]
                    if size % s == 0:
                        ok = axes[:k]
                        break
                axes = ok or ()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
            used.add(axes[0])
        else:
            out.append(tuple(axes))
            used.update(axes)
    return tuple(out)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_for(mesh, spec: Spec, ndim: int) -> tuple:
    """DTensor placements for ``spec``: ``Shard(d)`` on each mesh dim that
    tensor dim ``d`` maps to, ``Replicate()`` elsewhere. A tuple entry
    shards its dim over its mesh dims major to minor, as JAX does; DTensor
    splits in mesh-dim order, so the tuple must follow it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: what the JAX package's ``NamedSharding`` holds."""
    mesh: object
    spec: Spec

    def placements(self, ndim: int) -> tuple:
        return placements_for(self.mesh, self.spec, ndim)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The local shard's shape (every mapping divides: `spec_for`
        dropped those that do not)."""
        ms = mesh_shape(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in spec_axes(entry):
                out[d] //= ms[a]
        return tuple(out)

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` (the whole value, the same on every rank) as a
        DTensor: each rank keeps its own shard, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh,
                                 self.placements(tensor.ndim),
                                 src_data_rank=None)

    def from_local(self, local: torch.Tensor, shape: Sequence[int]):
        """A DTensor of global ``shape`` from this rank's shard."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh,
                                  self.placements(len(shape)),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def sharding_for(mesh, logical: Sequence[str | None],
                 dims: Sequence[int] | None = None) -> Sharding:
    return Sharding(mesh, spec_for(mesh, logical, dims))


def constrain(x, mesh, logical: Sequence[str | None]):
    """``x`` (a DTensor) redistributed to its logical axes' placements."""
    placements = placements_for(mesh, spec_for(mesh, logical, x.shape),
                                x.ndim)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


_MESH_CTX: list = [None]


class use_mesh:
    """Context manager: activation constraints apply under this mesh.

    Model code calls `act(x, logical)` unconditionally; without an active
    mesh it returns ``x`` itself, under a mesh it redistributes the
    DTensor ``x`` to the logical axes' placements (the JAX package's
    ``with_sharding_constraint``) — same model code for both paths.
    """

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _MESH_CTX.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _MESH_CTX.pop()


def current_mesh():
    return _MESH_CTX[-1]


def act(x, logical: Sequence[str | None]):
    """Constrain an activation by logical axes (``x`` itself without a
    mesh, or when ``x`` is not a DTensor)."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    return constrain(x, mesh, logical)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_map(fn, in_logical: Sequence, out_logical: Sequence):
    """``fn`` run on each device's local shards: a region of model code
    whose ops DTensor has no sharding rule for (the MoE's sort, gather and
    scatter, the SSD and xLSTM scans, the cross-entropy's gather), and
    which is independent along the dims its logical axes shard (rows of a
    batch, heads). Each DTensor argument is redistributed to its
    ``in_logical`` axes (every axis not named is gathered), ``fn`` runs on
    the local tensors, and each output becomes a DTensor under its
    ``out_logical`` axes; a plain tensor with sharded axes is taken as
    replicated first. Other arguments pass through.
    Without a mesh, or when no argument is a DTensor, it is ``fn``
    itself, so the single-device path runs the same operations."""
    def run(*args):
        mesh = current_mesh()
        if mesh is None or not any(_is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate
        ms = mesh_shape(mesh)
        local, axes_of = [], {}
        for a, log in zip(args, in_logical):
            if isinstance(a, torch.Tensor) and not _is_dtensor(a) \
                    and log is not None and any(n is not None for n in log):
                a = DTensor.from_local(a, mesh, [Replicate()] * len(ms),
                                       run_check=False)
            if _is_dtensor(a):
                spec = spec_for(mesh, log, a.shape)
                for name, entry in zip(log, spec):
                    if name is not None and axes_of.setdefault(
                            name, entry) != entry:
                        raise ValueError(f"local_map: {name} shards as "
                                         f"{axes_of[name]} and {entry}")
                a = constrain(a, mesh, log).to_local()
            local.append(a)
        outs = fn(*local)
        single = not isinstance(outs, tuple)
        wrapped = []
        for o, log in zip((outs,) if single else outs, out_logical):
            # an output dim shards as the inputs' dim of the same name did
            spec = tuple(None if n is None else axes_of.get(n) for n in log)
            shape = list(o.shape)
            for d, entry in enumerate(spec):
                for ax in spec_axes(entry):
                    shape[d] *= ms[ax]
            wrapped.append(DTensor.from_local(
                o, mesh, placements_for(mesh, spec, o.ndim),
                run_check=False, shape=torch.Size(shape),
                stride=_contiguous_stride(shape)))
        return wrapped[0] if single else tuple(wrapped)
    return run


def einsum(eq: str, *ops):
    """`torch.einsum` over DTensor operands by a fixed rule, on the local
    shards (DTensor's own einsum may shard an output dim that the einsum's
    internal reshape then cannot split). For each mesh dim, in operand
    order: the first output letter an operand shards there stays sharded
    (every operand holding that letter is sharded on it, the others
    replicated); else a contracted letter that every operand holding it
    shards there stays sharded, and the output is a partial sum; else the
    operands are replicated there. Partial operands are reduced first.
    ``torch.einsum`` itself when no operand is a DTensor."""
    mesh = current_mesh()
    if mesh is None or not any(_is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out_letters = eq.replace(" ", "").split("->")
    letters = lhs.split(",")
    if "..." in eq:                      # name the ellipsis dims
        n = max(o.ndim - len(ls) + 3 for o, ls in zip(ops, letters)
                if "..." in ls)
        fresh = "".join(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        if c not in eq)[:n]
        letters = [ls.replace("...", fresh[n - (o.ndim - len(ls) + 3):])
                   for o, ls in zip(ops, letters)]
        out_letters = out_letters.replace("...", fresh)
        eq = ",".join(letters) + "->" + out_letters
    names = list(mesh.mesh_dim_names)
    ops = [o if _is_dtensor(o) else DTensor.from_local(
        o, mesh, [Replicate()] * len(names), run_check=False) for o in ops]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o
           for o in ops]
    want = [[Replicate()] * len(names) for _ in ops]
    out_pl = [Replicate()] * len(names)
    for m in range(len(names)):
        sharded = []                     # (letter, operand) sharded on m
        for i, o in enumerate(ops):
            p = o.placements[m]
            if isinstance(p, Shard) and type(p) is Shard:
                sharded.append((letters[i][p.dim], i))
        pick, partial = None, False
        for letter, _ in sharded:
            if letter in out_letters:
                pick = letter
                break
        if pick is None:
            for letter, _ in sharded:
                holders = [i for i, ls in enumerate(letters) if letter in ls]
                if all((letter, i) in sharded for i in holders):
                    pick, partial = letter, True
                    break
        if pick is None:
            continue
        for i, ls in enumerate(letters):
            if pick in ls:
                want[i][m] = Shard(ls.index(pick))
        out_pl[m] = Partial() if partial else Shard(out_letters.index(pick))
    local = [o.redistribute(mesh, w).to_local() if tuple(o.placements)
             != tuple(w) else o.to_local() for o, w in zip(ops, want)]
    y = torch.einsum(eq, *local)
    sizes = {}
    for o, ls in zip(ops, letters):
        for letter, n in zip(ls, o.shape):
            sizes[letter] = n
    shape = tuple(sizes[letter] for letter in out_letters)
    return DTensor.from_local(y, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def tree_shardings(mesh, logical_tree, shape_tree):
    """Map a tree of logical-axis tuples + shapes (objects with
    ``.shape``) to `Sharding`s; dicts, lists and tuples of trees recurse,
    a tuple of names (or ``None``) is a leaf."""
    def is_leaf(x):
        return isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x)

    def one(log, shp):
        if is_leaf(log):
            return sharding_for(mesh, log, tuple(shp.shape))
        if isinstance(log, dict):
            return {k: one(log[k], shp[k]) for k in log}
        return type(log)(one(a, b) for a, b in zip(log, shp))
    return one(logical_tree, shape_tree)
