"""The recursive pull through the reach order (`core.views.get_pull_order`).

The pull (`kernels.ops.pull_reduction`) hands the fix-up only the Temp
rows that each partition's own nonzeros reach (`core.mttkrp.
reach_pieces`). The rows it leaves out hold exact zeros, so it must give
the bits of the dense order of all ``L·T`` Temp rows (``order=None``) and
of the plain `core.mttkrp.pull_rows`: for K7's partials under ALTO-OTF
and ALTO-PRE and K3's with negative factors, on blocked and uniform 3-
and 4-mode tensors, every mode, with a padded stream and partition
intervals clamped at the mode's size; and a bucket whose members' orders
differ in length must pull each tenant with its solo bits. The tests
marked ``card`` (the ``card`` fixture skips them without a CUDA device)
run K7, K3 and the fix-up: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_pull_reach.py``. No JAX here.
"""
import pytest
import torch

from repro_torch.core import alto as talto
from repro_torch.core import batched as tbatched
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import shapeclass as tsc
from repro_torch.core import views as tviews
from repro_torch.kernels import _build, common
from repro_torch.kernels import cpapr_phi as tk7
from repro_torch.kernels import mttkrp as tk3
from repro_torch.kernels import mttkrp_oriented as tmo
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn

L = 8
R = 5
TENSORS = {
    "blocked3": lambda: tsyn.blocked_tensor((40, 24, 20), 901, block=6,
                                            n_blocks=6, seed=8,
                                            count_data=True),
    "uniform3": lambda: tsyn.uniform_tensor((30, 17, 12), 603, seed=2,
                                            count_data=True),
    "blocked4": lambda: tsyn.blocked_tensor((36, 20, 50, 9), 1205, block=5,
                                            n_blocks=5, seed=4,
                                            count_data=True),
    "uniform4": lambda: tsyn.uniform_tensor((14, 22, 9, 11), 777, seed=6,
                                            count_data=True),
}
CASES = [(name, mode) for name in TENSORS
         for mode in range(4 if name.endswith("4") else 3)]


@pytest.fixture
def card():
    """The CUDA device, for a test marked ``card``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    """The CPU, then the card (marked ``card``; skips without one)."""
    if request.param == "cuda":
        return request.getfixturevalue("card")
    return torch.device("cpu")


def _tensor(name, device="cpu"):
    tviews.cache_clear()
    return talto.build_device(TENSORS[name](), n_partitions=L, device=device)


def _operands(at, seed=3, negative=False):
    g = torch.Generator().manual_seed(seed)
    fs = [torch.rand((I, R), generator=g) + (-0.5 if negative else 0.1)
          for I in at.meta.dims]
    Bs = [torch.rand((I, R), generator=g) + 0.1 for I in at.meta.dims]
    return [f.to(at.device) for f in fs], [b.to(at.device) for b in Bs]


def _partials(kind, at, mode):
    """Temp buffers of ``kind``: K7 under OTF or PRE, or K3 on factors
    drawn from [-0.5, 0.5) (terms of both signs)."""
    m = at.meta
    T = m.temp_rows[mode]
    fs, Bs = _operands(at, negative=kind == "k3")
    if kind == "k3":
        return tk3.recursive_partials(m.enc, mode, T, at.words, at.values,
                                      at.part_start, fs)
    operand = (dict(factors=fs) if kind == "k7-otf" else
               dict(pi=tops.pi_rows(m.enc, at.words, fs, mode)))
    return tk7.phi_partials(m.enc, mode, T, 1e-10, at.words, at.values,
                            at.part_start, Bs[mode], **operand)


def test_the_cases_pad_the_stream_and_clamp_intervals():
    """Every tensor pads its stream, and some of its modes have partition
    intervals that the Temp height carries past the mode's size."""
    for name in TENSORS:
        at = _tensor(name)
        assert at.words.shape[0] > at.meta.nnz, name
        ends = at.part_start.long() + torch.tensor(at.meta.temp_rows)
        assert bool((ends > torch.tensor(at.meta.dims)).any()), name


@pytest.mark.parametrize("kind", ["k7-otf", "k7-pre", "k3"])
@pytest.mark.parametrize("name, mode", CASES)
def test_reach_pull_equals_the_dense_pull_bit_for_bit(name, mode, kind):
    at = _tensor(name)
    m = at.meta
    temp = _partials(kind, at, mode)
    start, I_n = at.part_start[:, mode], m.dims[mode]
    order = tviews.get_pull_order(at, mode)
    assert order.order.shape[0] < L * m.temp_rows[mode]
    got = tops.pull_reduction(temp, start, I_n, order=order)
    assert torch.equal(got, tops.pull_reduction(temp, start, I_n))
    assert torch.equal(got, tmttkrp.pull_rows(temp, start, I_n))
    # What the reach order leaves out is zeros, and K7/K3 wrote them so.
    left = torch.ones(L * m.temp_rows[mode], dtype=torch.bool)
    left[order.order] = False
    assert not bool(temp.reshape(-1, R)[left].any())


@pytest.mark.parametrize("name, mode", CASES)
def test_reach_order_is_the_dense_order_less_the_unreached_rows(name, mode):
    at = _tensor(name)
    m = at.meta
    reach = tviews.get_pull_order(at, mode)
    dense = tviews.pull_order(at.part_start[:, mode], m.temp_rows[mode],
                              m.dims[mode])
    reached = set(reach.order.tolist())
    keep = torch.tensor([i in reached for i in dense.order.tolist()])
    assert torch.equal(dense.order[keep], reach.order)
    assert torch.equal(dense.rows[keep], reach.rows)
    # Each reached Temp row is one (partition, row) pair of the stream.
    coords = at.coords()[:, mode].reshape(L, -1).tolist()
    pairs = {(l, r) for l, rows in enumerate(coords) for r in rows}
    T = m.temp_rows[mode]
    starts = at.part_start[:, mode].tolist()
    assert reached == {l * T + r - starts[l] for l, r in pairs}


@pytest.mark.parametrize("mode", range(3))
def test_a_bucket_of_different_lengths_pulls_each_tenant_solo(device, mode):
    """A bucket of one shape class whose members reach different numbers
    of Temp rows: the stacked order pads the shorter members with zeros
    on their last row (`views.stack_pull_orders`), and one stacked pull
    (the fix-up's tenant axis on the card) gives each tenant the bits of
    its solo pull and of the dense pull."""
    sc = tsc.ShapeClass(dims=(16, 8, 8), nnz=128, n_partitions=L, rank=R)
    xs = [tsyn.uniform_tensor((9, 7, 5), 90, seed=5, count_data=True),
          tsyn.uniform_tensor((16, 8, 8), 128, seed=6, count_data=True),
          tsyn.uniform_tensor((14, 8, 7), 120, seed=9, count_data=True)]
    tviews.cache_clear()
    ats = [tsc.canonicalize_tensor(talto.build_device(
        tsc.pad_to_class(x, sc), n_partitions=L, compute_reuse=False,
        device=device), sc) for x in xs]
    at_b = tbatched.stack_tenants(ats)
    orders = [tviews.get_pull_order(at, mode) for at in ats]
    assert len({o.order.shape[0] for o in orders}) == len(ats)
    g = torch.Generator().manual_seed(mode)
    facs = [(torch.rand((len(ats), I, R), generator=g) + 0.1).to(device)
            for I in sc.dims]
    m = at_b.meta
    temp = tk7.phi_partials(m.enc, mode, m.temp_rows[mode], 1e-10,
                            at_b.words, at_b.values, at_b.part_start,
                            facs[mode] * 2.0, factors=facs)
    starts, I_n = at_b.part_start[..., mode], m.dims[mode]
    got = tops.pull_reduction(temp, starts, I_n,
                              order=tviews.stack_pull_orders(orders))
    assert torch.equal(got, tops.pull_reduction(temp, starts, I_n))
    for t, o in enumerate(orders):
        assert torch.equal(got[t], tops.pull_reduction(temp[t], starts[t],
                                                       I_n, order=o))
        assert torch.equal(got[t].cpu(), tmttkrp.pull_rows(
            temp[t].cpu(), starts[t].cpu(), I_n))


def test_pull_pieces_skipped_counts_the_rows_left_out(monkeypatch):
    """On the card (``common.on_cuda``, the fix-up stubbed here) a pull
    through the caller's order adds one launch and ``L·T`` less its
    pieces; a pull without an order (the dense one) counts nothing."""
    at = _tensor("blocked4")
    monkeypatch.setattr(common, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tmo, "carry_fixup",
                        lambda rows, pieces, out, threads: out)
    _build.reset_counts()
    want = 0
    for mode in range(4):
        T = at.meta.temp_rows[mode]
        temp = torch.zeros((L, T, R))
        order = tviews.get_pull_order(at, mode)
        tops.pull_reduction(temp, at.part_start[:, mode],
                            at.meta.dims[mode], order=order)
        tops.pull_reduction(temp, at.part_start[:, mode],
                            at.meta.dims[mode])
        want += L * T - order.order.shape[0]
        # A bucket of two: both tenants' rows left out.
        tops.pull_reduction(torch.stack([temp, temp]),
                            at.part_start[:, mode].expand(2, L),
                            at.meta.dims[mode],
                            order=tviews.stack_pull_orders([order, order]))
        want += 2 * (L * T - order.order.shape[0])
    c = _build.counts()
    assert c["launches"]["pull_pieces_skipped"] == 8
    assert c["elements"]["pull_pieces_skipped"] == want > 0


@pytest.mark.card
@pytest.mark.parametrize("kind", ["k7-otf", "k7-pre", "k3"])
@pytest.mark.parametrize("name, mode", CASES)
def test_reach_pull_on_the_card(card, name, mode, kind):
    """On the card: K7's or K3's partials pulled through the reach order
    equal the dense pull bit for bit, and the plain pull of the same
    partials on the CPU; the counter reads ``L·T`` less the pieces."""
    at = _tensor(name, device=card)
    m = at.meta
    temp = _partials(kind, at, mode)
    start, I_n = at.part_start[:, mode], m.dims[mode]
    order = tviews.get_pull_order(at, mode)
    _build.reset_counts()
    got = tops.pull_reduction(temp, start, I_n, order=order)
    c = _build.counts()
    assert c["launches"]["pull_pieces_skipped"] == 1
    assert (c["elements"]["pull_pieces_skipped"]
            == L * m.temp_rows[mode] - order.order.shape[0])
    assert torch.equal(got, tops.pull_reduction(temp, start, I_n))
    assert torch.equal(got.cpu(), tmttkrp.pull_rows(temp.cpu(), start.cpu(),
                                                    I_n))
