"""AdamW and Adafactor over the JAX package's parameter leaves.

Each optimizer is a `torch.optim.Optimizer` with one parameter group a
leaf of the JAX parameter tree (`models.model.jax_leaves`, in JAX's
flatten order): a ``blocks_{pos}`` group holds that position's layers in
repeat order. The group's state tensors have the JAX package's shapes
for the *stacked* leaf and live in the group (``group["m"]`` ...), so
they round-trip through ``state_dict`` and `interop.lm_train_tree` gives
JAX's optimizer tree as it is. The formulas are the JAX package's
(`repro/optim/optimizers.py`), not `torch.optim`'s: AdamW's update is
``mh / (sqrt(vh) + eps) + wd·p`` and Adafactor factors a leaf when the
stacked leaf has two axes or more, so a per-layer vector (a norm scale,
a bias) of a stacked leaf is factored across the repeats as in JAX.

One ``count`` is shared by the leaves; ``lr(count)`` is taken in float32
on the host; each update runs in float32 and is cast back to the
parameter's dtype; moments are kept in ``moment_dtype`` (AdamW) or
bfloat16 (Adafactor's ``m``). Gradients are handed to `step` as a list
of lists (one list a group, one tensor a parameter) in any float dtype,
or read from ``p.grad``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.models.common import ParamDef, map_defs

Tree = dict


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's scalar arithmetic)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _chunks(n: int, chunks: int) -> list[range]:
    per = -(-n // max(1, chunks))
    return [range(i, min(n, i + per)) for i in range(0, n, per)]


class _LeafOptimizer(torch.optim.Optimizer):
    """The shared machinery: groups from `jax_leaves`, group-held state in
    the stacked leaf's shape, the shared count and the schedule."""

    def __init__(self, leaves, lr, defaults: dict):
        groups = [{"params": list(leaf.params), "leaf": leaf.name,
                   "stacked": leaf.stacked} for leaf in leaves]
        super().__init__(groups, defaults)
        self.lr_fn = lr if callable(lr) else (lambda step: lr)
        self.count = 0
        for group in self.param_groups:
            p = group["params"][0]
            shape = ((len(group["params"]),) if group["stacked"]
                     else ()) + tuple(p.shape)
            for key, (shp, dtype) in self._state_shapes(shape).items():
                group[key] = torch.zeros(shp, dtype=dtype, device=p.device)

    def _state_shapes(self, shape: tuple) -> dict:
        raise NotImplementedError

    def lr_at(self, count: int) -> float:
        """The learning rate at ``count`` as a float32 value."""
        return _f32(float(self.lr_fn(torch.tensor(count,
                                                  dtype=torch.float32))))

    @torch.no_grad()
    def step(self, grads=None, chunks: int = 1):
        """One update of every leaf with the count advanced once.
        ``grads`` (default each ``p.grad``) is a list per group; ``chunks``
        updates the leaves in that many groups, one after the other, as
        the JAX step's ``opt_update_chunks`` does (there to bound the
        float32 temporaries live at once): eager per-leaf updates already
        keep one leaf's live, so every count gives the same bits."""
        if grads is None:
            grads = [[p.grad for p in g["params"]]
                     for g in self.param_groups]
        count = self.count + 1
        lr = self.lr_at(count)
        for idx in _chunks(len(self.param_groups), chunks):
            for i in idx:
                self._update(self.param_groups[i], grads[i], lr, count)
        self.count = count

    def _update(self, group: dict, grads: list, lr: float, count: int):
        raise NotImplementedError

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def _piece(t: torch.Tensor, group: dict, r: int) -> torch.Tensor:
    """Layer ``r``'s slice of a stacked state tensor (the whole tensor for
    a leaf that is not stacked)."""
    return t[r] if group["stacked"] else t


class AdamW(_LeafOptimizer):
    """The JAX package's `adamw`: elementwise, so each layer's parameter
    is updated on its own slice of the stacked moments."""

    def __init__(self, leaves, lr: Callable | float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype=torch.float32):
        self.moment_dtype = moment_dtype
        super().__init__(leaves, lr, dict(b1=b1, b2=b2, eps=eps,
                                          weight_decay=weight_decay))

    def _state_shapes(self, shape):
        return {"m": (shape, self.moment_dtype),
                "v": (shape, self.moment_dtype)}

    @staticmethod
    def state_defs(param_defs: Tree) -> Tree:
        """The state's `ParamDef` tree over `model_def`'s (JAX's)."""
        mom = map_defs(lambda d: ParamDef(d.shape, d.logical, init="zeros"),
                        param_defs)
        return {"m": mom, "v": mom,
                "count": ParamDef((), (), init="zeros")}

    def _update(self, group, grads, lr, count):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        wd = group["weight_decay"]
        stepf = torch.tensor(count, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf)
        for r, (p, g) in enumerate(zip(group["params"], grads)):
            m, v = _piece(group["m"], group, r), _piece(group["v"], group, r)
            # JAX's operations in its order; each float32 temporary is
            # dropped once read, so few copies of a leaf are live
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            del g
            delta = m_new / bc1
            m.copy_(m_new)
            del m_new
            denom = torch.sqrt(v_new / bc2).add_(eps)
            v.copy_(v_new)
            del v_new
            delta.div_(denom)
            del denom
            if wd:
                delta.add_(wd * p.float())
            p.copy_(p.float() - delta.mul_(lr))


class Adafactor(_LeafOptimizer):
    """The JAX package's `adafactor`: factored second moment over the
    stacked leaf, bfloat16 first moment. A leaf of two axes or more keeps
    ``vr`` (its shape without the last axis) and ``vc`` (without the
    second last); a vector leaf keeps ``vr`` elementwise and a scalar
    ``vc``. On a stacked leaf whose layers are matrices or larger the
    statistics are per layer, so each layer is updated on its slices; on
    one whose layers are vectors (or scalars) the leaf couples its repeats
    (``vc`` averages over them, ``vr`` is normalised by their mean), so
    the layers are stacked and updated together."""

    def __init__(self, leaves, lr: Callable | float, b1: float = 0.9,
                 decay: float = 0.99, eps: float = 1e-30,
                 weight_decay: float = 0.0):
        super().__init__(leaves, lr, dict(b1=b1, decay=decay, eps=eps,
                                          weight_decay=weight_decay))

    def _state_shapes(self, shape):
        f32 = torch.float32
        if len(shape) >= 2:
            return {"m": (shape, torch.bfloat16), "vr": (shape[:-1], f32),
                    "vc": (shape[:-2] + shape[-1:], f32)}
        return {"m": (shape, torch.bfloat16), "vr": (shape, f32),
                "vc": ((), f32)}

    @staticmethod
    def state_defs(param_defs: Tree) -> Tree:
        def vr(d):
            if len(d.shape) >= 2:
                return ParamDef(d.shape[:-1], d.logical[:-1], init="zeros")
            return ParamDef(d.shape, d.logical, init="zeros")

        def vc(d):
            if len(d.shape) >= 2:
                return ParamDef(d.shape[:-2] + d.shape[-1:],
                                d.logical[:-2] + d.logical[-1:],
                                init="zeros")
            return ParamDef((), (), init="zeros")

        mom = map_defs(lambda d: ParamDef(d.shape, d.logical, init="zeros"),
                        param_defs)
        return {"m": mom, "vr": map_defs(vr, param_defs),
                "vc": map_defs(vc, param_defs),
                "count": ParamDef((), (), init="zeros")}

    def _update(self, group, grads, lr, count):
        params = group["params"]
        if group["stacked"] and params[0].dim() < 2:
            # the repeats share the statistics: update the stacked leaf
            p = torch.stack(params)
            self._one(group, torch.stack([g.float() for g in grads]), p,
                      group["m"], group["vr"], group["vc"], lr)
            for r, q in enumerate(params):
                q.copy_(p[r])
            return
        for r, (p, g) in enumerate(zip(params, grads)):
            vc = group["vc"] if params[0].dim() < 2 else _piece(
                group["vc"], group, r)
            self._one(group, g.float(), p, _piece(group["m"], group, r),
                      _piece(group["vr"], group, r), vc, lr)

    @staticmethod
    def _one(group, g, p, m, vr, vc, lr):
        """JAX's ``upd`` on one tensor ``p`` (a layer, a whole leaf, or a
        stack of vector layers) and its state slices, in place."""
        b1, decay, eps = group["b1"], group["decay"], group["eps"]
        wd = group["weight_decay"]
        g2 = g * g + eps
        if g.dim() >= 2:
            vr_new = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            vc_new = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            denom = (vr_new[..., None] * vc_new[..., None, :]
                     / torch.clamp_min(torch.mean(
                         vr_new, dim=-1, keepdim=True)[..., None], eps))
            pre = g * torch.rsqrt(torch.clamp_min(denom, eps))
            vc.copy_(vc_new)
        else:
            vr_new = decay * vr + (1 - decay) * g2
            pre = g * torch.rsqrt(torch.clamp_min(vr_new, eps))
        m_new = b1 * m.float() + (1 - b1) * pre
        delta = m_new
        if wd:
            delta = delta + wd * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        vr.copy_(vr_new)


def warmup_cosine(peak_lr: float, warmup: int = 1000,
                  total: int = 100_000, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine to ``floor·peak_lr``
    at ``total``; a float32 step in, a float32 rate out, each operation in
    the JAX package's order."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def get_optimizer(name: str, leaves, lr=3e-4, **kw) -> _LeafOptimizer:
    """``name`` ("adamw" or "adafactor") over ``leaves``
    (`models.model.jax_leaves`)."""
    if name == "adamw":
        return AdamW(leaves, lr, **kw)
    if name == "adafactor":
        return Adafactor(leaves, lr, **kw)
    raise ValueError(f"unknown optimizer {name}")
