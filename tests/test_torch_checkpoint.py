"""Port parity: checkpoints (`repro_torch.checkpoint`) against the JAX
package's `repro.checkpoint.checkpoint`.

* A round trip in the port is bit for bit for float32, float64, int32
  and bfloat16 leaves, in lists, tuples and dicts.
* A checkpoint the JAX package saves restores in the port bit for bit,
  and the reverse (float32, int32 and bfloat16: the JAX package runs
  without 64-bit types here). The manifests carry the same dtype names
  and shapes; the port writes no tree structure (``"treedef"`` null).
* A ``.tmp`` directory (a save cut before its rename) is never the
  latest step; a leaf count or a shape that differs from ``like`` raises.
* `AsyncCheckpointer` keeps the newest save, from a copy taken when
  `save` was called.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro_torch.checkpoint import checkpoint as tck


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"factors": [torch.randn(7, 3, generator=g),
                        torch.randn(5, 3, generator=g)],
            "lam": torch.randn(3, generator=g).to(torch.bfloat16),
            "counts": (torch.arange(6, dtype=torch.int32).reshape(2, 3),),
            "fit": torch.randn(4, generator=g, dtype=torch.float64)}


def _leaves(tree):
    return tck._flatten(tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _same(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_round_trip_bitwise(tmp_path):
    tree = _tree()
    path = tck.save(str(tmp_path), 3, tree, data_step=11,
                    extra={"fits": [0.25, 0.5]})
    assert path.endswith("step_00000003")
    assert tck.latest_step(str(tmp_path)) == 3
    like = {k: v for k, v in reversed(list(_tree(seed=1).items()))}
    got, manifest = tck.restore(str(tmp_path), 3, like, device="cpu")
    _same(got, tree)
    assert list(got) == list(like)             # like's key order
    assert isinstance(got["counts"], tuple)
    assert manifest["data_step"] == 11
    assert manifest["extra"] == {"fits": [0.25, 0.5]}
    assert manifest["treedef"] is None
    assert manifest["dtypes"] == ["int32", "float32", "float32",
                                  "float64", "bfloat16"]


def _jax_tree(tree):
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return {k: type(v)(conv(t) for t in v) if isinstance(v, (list, tuple))
            else conv(v) for k, v in tree.items()}


def _no_f64(tree):
    tree = dict(tree)
    tree.pop("fit")
    return tree


def test_jax_save_port_restore(tmp_path):
    tree = _no_f64(_tree())
    jck.save(str(tmp_path), 7, _jax_tree(tree), extra={"who": "jax"})
    got, manifest = tck.restore(str(tmp_path), 7, _no_f64(_tree(seed=2)),
                                device="cpu")
    _same(got, tree)
    assert manifest["extra"] == {"who": "jax"}


def test_port_save_jax_restore(tmp_path):
    tree = _no_f64(_tree())
    tck.save(str(tmp_path), 8, tree)
    like = _jax_tree(_no_f64(_tree(seed=3)))
    got, manifest = jck.restore(str(tmp_path), 8, like)
    flat = tck._flatten(got)
    ref = _leaves(tree)
    for g, r in zip(flat, ref):
        g = np.asarray(g)
        if r.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(np.int16), _bits(r))
        else:
            assert g.dtype == r.numpy().dtype
            np.testing.assert_array_equal(g, r.numpy())
    # the manifests name the same dtypes and shapes
    jck.save(str(tmp_path), 9, _jax_tree(tree))
    jm = json.loads((tmp_path / "step_00000009" / "manifest.json")
                    .read_text())
    for key in ("n_leaves", "shapes", "dtypes"):
        assert manifest[key] == jm[key]


def test_tmp_directory_is_never_restored(tmp_path):
    tck.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000005.tmp")
    assert tck.latest_step(str(tmp_path)) == 1
    assert tck.latest_step(str(tmp_path / "absent")) is None


def test_mismatch_raises(tmp_path):
    tck.save(str(tmp_path), 1, [torch.zeros(3, 2), torch.zeros(4)])
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.restore(str(tmp_path), 1, [torch.zeros(3, 2)], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.restore(str(tmp_path), 1, [torch.zeros(3, 2), torch.zeros(5)],
                    device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    tck.save(str(tmp_path), 1, [torch.zeros(2)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tck.restore(str(tmp_path), 1, [torch.zeros(2)])


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path))
    a = torch.zeros(1000)
    for step in range(1, 6):
        a.fill_(step)
        ck.save(step, {"a": a}, data_step=step)
    a.fill_(-1.0)                      # after save: the copy was taken
    assert ck.last_path.endswith("step_00000005")
    assert tck.latest_step(str(tmp_path)) == 5
    got, manifest = tck.restore(str(tmp_path), 5, {"a": a}, device="cpu")
    assert torch.equal(got["a"], torch.full((1000,), 5.0))
    assert manifest["data_step"] == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_scalar_leaf_round_trip(tmp_path):
    """A 0-d leaf (an optimizer's step count) restores without an axis."""
    tree = {"count": torch.tensor(7, dtype=torch.int32), "w": torch.ones(3)}
    tck.save(str(tmp_path), 1, tree)
    got, _ = tck.restore(str(tmp_path), 1, tree, device="cpu")
    assert got["count"].shape == () and int(got["count"]) == 7
    assert got["count"].dtype == torch.int32
