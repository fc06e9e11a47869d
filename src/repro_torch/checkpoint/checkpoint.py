"""Checkpoints of trees of tensors, in the JAX package's on-disk layout.

Layout: <dir>/step_<N>/
  manifest.json        — step, data cursor, leaf count, shapes, dtypes
  arrays.npz           — flat {index: ndarray} (leaves on the host)

* A tree is lists, tuples and dicts of tensors (dicts in sorted key
  order, ``None`` holds no leaf), the order `jax.tree.flatten` gives the
  same structure, so a checkpoint written by either package restores in
  the other bit for bit. The structure is not stored (``"treedef"`` is
  null): `restore` takes it from ``like``.
* bfloat16 and the float8 types are stored as their raw unsigned bits
  under the dtype's name (``"bfloat16"``, ...), as the JAX package does
  for the types npz cannot hold.
* The manifest is written LAST and the directory published by an atomic
  rename, so a partly written checkpoint (a ``.tmp`` directory) is never
  restored.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any

# npz cannot hold these; they are stored as raw unsigned bits. Per name:
# the torch type, the stored numpy type, and the integer type of the same
# width that numpy and torch both hold (torch has no uint16 arithmetic).
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8)}
_EXOTIC_NAME = {v[0]: k for k, v in _EXOTIC.items()}


def _flatten(tree: Tree) -> list:
    """Leaves in `jax.tree.flatten`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _unflatten(like: Tree, leaves) -> Tree:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf on the host as a savable array and its dtype's name."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, a.dtype.name
    x = x.detach().cpu()
    name = _EXOTIC_NAME.get(x.dtype)
    if name is not None:
        _, stored, common = _EXOTIC[name]
        bits = torch.from_numpy(np.empty(0, common)).dtype
        return x.view(bits).numpy().view(stored), name
    a = x.numpy()
    return a, a.dtype.name


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype_name in _EXOTIC:
        dtype, _, common = _EXOTIC[dtype_name]
        return torch.from_numpy(a.view(common)).view(dtype)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, tree: Tree, data_step: int = 0,
         extra: dict | None = None) -> str:
    """Synchronous save. Returns the checkpoint path."""
    leaves = [_to_numpy(x) for x in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{str(i): a for i, (a, _) in enumerate(leaves)})
    manifest = {
        "step": step,
        "data_step": data_step,
        "treedef": None,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a, _ in leaves],
        "dtypes": [name for _, name in leaves],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    return final


class AsyncCheckpointer:
    """Fire-and-forget saver; at most one outstanding save (a new request
    waits for the previous one, so the newest always lands)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self._last_path: str | None = None

    def save(self, step: int, tree: Tree, data_step: int = 0,
             extra: dict | None = None):
        # Copy to the host before backgrounding: the caller may go on
        # updating its tensors in place.
        host_tree = _unflatten(tree, iter(
            [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
             else np.array(x) for x in _flatten(tree)]))
        self.wait()

        def work():
            self._last_path = save(self.ckpt_dir, step, host_tree,
                                   data_step, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def last_path(self):
        self.wait()
        return self._last_path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Tree,
            device=None) -> tuple[Tree, dict]:
    """Restore into the structure of ``like``, each leaf in its ``like``
    leaf's dtype, on ``device`` (default ``cuda``). Raises `ValueError`
    on a leaf count or shape that differs from ``like``'s."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = _flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)} — structure mismatch")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, ref in enumerate(leaves_like):
            t = _from_numpy(data[str(i)], manifest["dtypes"][i])
            if not isinstance(ref, torch.Tensor):
                ref = torch.from_numpy(np.asarray(ref))
            if t.shape != ref.shape:
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            out.append(t.to(device=dev, dtype=ref.dtype))
    return _unflatten(like, iter(out)), manifest
