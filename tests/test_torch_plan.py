"""Port parity: execution plans.

The traversal rules are the paper's and are copied, so `traversals()`
must equal the JAX package's wherever JAX's TPU VMEM gate does not bind.
Where it binds (hyper-sparse long modes, the DARPA shape) the port, whose
kernels keep no output resident, picks the carry variant instead.
"""
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import encoding as jenc
from repro.core import plan as jplan
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import plan as tplan
from repro_torch.core import views as tviews
from repro_torch.sparse.tensor import SparseTensor as TSparse

TENSORS = [
    ("blocked_tensor", dict(dims=(60, 24, 77, 32), nnz=4000, block=8,
                            n_blocks=4, count_data=True)),
    ("uniform_tensor", dict(dims=(500, 400, 3000), nnz=3000)),
    ("zipf_tensor", dict(dims=(30, 24, 20), nnz=800)),
    ("blocked_tensor", dict(dims=(40, 40, 40), nnz=5000, block=4,
                            n_blocks=3)),
]


def _both(name, kw, L=8):
    x = getattr(jsyn, name)(seed=0, **kw)
    return (jalto.build(x, n_partitions=L),
            talto.build(TSparse(x.dims, x.coords, x.values), n_partitions=L,
                        device="cpu"))


@pytest.mark.parametrize("rank", [4, 16])
@pytest.mark.parametrize("case", TENSORS, ids=lambda c: c[0] + str(
    c[1]["dims"]))
def test_traversals_match_reference(case, rank):
    jat, at = _both(*case)
    assert at.meta.fiber_reuse == jat.meta.fiber_reuse
    ours = tplan.make_plan(at.meta, rank)
    ref = jplan.make_plan(jat.meta, rank, backend="pallas", interpret=True)
    assert ours.traversals() == ref.traversals()
    for mp in ours.modes:
        assert rank % mp.r_block == 0
        assert mp.block_m & (mp.block_m - 1) == 0
        assert tplan.MIN_BLOCK_M <= mp.block_m <= tplan.MAX_BLOCK_M
        assert mp.threads % mp.r_block == 0 and mp.threads <= 1024
    assert hash(ours) == hash(tplan.make_plan(at.meta, rank))


def _metas(dims, nnz, reuse, L=1024):
    temp = tuple(min(d, 64) for d in dims)
    ours = interop.alto_meta(dims, nnz, L, temp, reuse)
    ref = jalto.AltoMeta(enc=jenc.make_encoding(dims), nnz=nnz,
                         n_partitions=L, temp_rows=temp, fiber_reuse=reuse)
    return ours, ref


def test_published_shapes_and_darpa_divergence():
    """Chicago shape: both pick recursive + carry. DARPA shape: JAX's VMEM
    gate forces the one-hot variant; the port has no such gate."""
    ours, ref = _metas((6186, 24, 77, 32), 4_855_249, (91.1, 2.8, 3.4, 2.9))
    p = tplan.make_plan(ours, 16)
    assert p.traversals() == jplan.make_plan(ref, 16).traversals() == (
        "recursive", "oriented_carry", "oriented_carry", "oriented_carry")
    assert {m.block_m for m in p.modes} == {64}
    ours, ref = _metas((22476, 22476, 23_776_223), 28_436_033,
                       (1.0, 1.0, 1.0))
    assert jplan.make_plan(ref, 16).traversals() == ("oriented",) * 3
    p = tplan.make_plan(ours, 16)
    assert p.traversals() == ("oriented_carry",) * 3
    assert [(m.r_block, m.block_m, m.threads) for m in p.modes] == \
        [(16, 256, 128)] * 3


def test_backend_follows_device_and_rejects_unknown():
    _, at = _both(*TENSORS[2])
    assert tplan.plan_for(at, 4).backend == "reference"
    assert tplan.make_plan(at.meta, 4).backend == "cuda"
    assert tplan.make_plan(at.meta, 4, device="cpu").backend == "reference"
    with pytest.raises(ValueError, match="backend"):
        tplan.make_plan(at.meta, 4, backend="pallas")
    assert tplan.choose_rank_block(12) == 12
    assert tplan.choose_rank_block(256) == 128
    assert tplan.cta_threads(48) == 96


def test_build_views_only_oriented_modes_and_cached():
    tviews.cache_clear()
    jat, at = _both(*TENSORS[0])
    plan = tplan.make_plan(at.meta, 4, device="cpu")
    views = tplan.build_views(at, plan)
    oriented = {m.mode for m in plan.modes if m.traversal.value != "recursive"}
    assert set(views) == oriented and oriented
    again = tplan.build_views(at, plan)
    assert all(again[m] is views[m] for m in views)
    stats = tviews.cache_stats()
    assert stats["builds"] == len(oriented) and stats["hits"] == len(oriented)
    for m, v in views.items():
        ref = jalto.oriented_view(jat, m)
        np.testing.assert_array_equal(v.perm.numpy(), np.asarray(ref.perm))
    tviews.cache_clear()
    assert torch.equal(views[min(views)].rows,
                       tplan.build_views(at, plan)[min(views)].rows)
    tviews.cache_clear()
