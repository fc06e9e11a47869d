"""The frozen generators at small stand-in shapes: the exact count of
distinct coordinates, the same tensor for the same seed, coordinates and
values in range."""
import pytest
import torch

from bench import generators as G

SHAPES = [
    ("uniform", (50, 40, 300), 2_000, {}),
    # 3 blocks of side 4 hold at most 3 * 4**4 cells: the draw collides
    # often and has to top up.
    ("blocked", (30, 6, 11, 9), 600, dict(block=4, n_blocks=3)),
]


def _make(kind, dims, nnz, kw, seed):
    return G.GENERATORS[kind](dims, nnz, seed, "cpu", **kw)


@pytest.mark.parametrize("kind,dims,nnz,kw", SHAPES)
def test_exact_distinct_count(kind, dims, nnz, kw):
    x = _make(kind, dims, nnz, kw, seed=2**31 + 5)
    assert x.nnz == nnz and x.coords.shape == (nnz, len(dims))
    assert torch.unique(x.coords, dim=0).shape[0] == nnz


@pytest.mark.parametrize("kind,dims,nnz,kw", SHAPES)
def test_coordinates_and_values_in_range(kind, dims, nnz, kw):
    x = _make(kind, dims, nnz, kw, seed=7)
    for m, d in enumerate(dims):
        assert int(x.coords[:, m].min()) >= 0
        assert int(x.coords[:, m].max()) < d
    top = 9 if kind == "uniform" else 14
    assert x.values.dtype == torch.float32
    assert float(x.values.min()) >= 1 and float(x.values.max()) <= top
    assert torch.equal(x.values, x.values.round())


@pytest.mark.parametrize("kind,dims,nnz,kw", SHAPES)
def test_same_seed_same_tensor(kind, dims, nnz, kw):
    a = _make(kind, dims, nnz, kw, seed=123)
    b = _make(kind, dims, nnz, kw, seed=123)
    c = _make(kind, dims, nnz, kw, seed=124)
    assert torch.equal(a.coords, b.coords) and torch.equal(a.values, b.values)
    assert not torch.equal(a.coords, c.coords)


def test_blocked_stays_in_its_blocks():
    x = _make("blocked", (30, 6, 11, 9), 600, dict(block=4, n_blocks=3), 9)
    # Each mode's indices lie in at most 3 windows of 4 from the corners,
    # which start below max(1, I - 4).
    for m, d in enumerate((30, 6, 11, 9)):
        assert torch.unique(x.coords[:, m]).numel() <= 12
        assert int(x.coords[:, m].max()) < max(1, d - 4) + 3


def test_blocked_layout_is_the_same_for_every_seed():
    a = _make("blocked", (30, 6, 11, 9), 400, dict(block=4, n_blocks=3), 1)
    b = _make("blocked", (30, 6, 11, 9), 400, dict(block=4, n_blocks=3), 2)
    assert not torch.equal(a.coords, b.coords)
    # 400 of at most 768 cells: both samples hit the same few windows.
    for m in range(4):
        assert torch.unique(torch.cat([a.coords[:, m], b.coords[:, m]])
                            ).numel() <= 12


def test_too_few_cells_raises():
    with pytest.raises(RuntimeError, match="distinct coordinates"):
        G.uniform_tensor((2, 2), 5, seed=1, device="cpu")


def test_stream_seeds_differ_by_purpose_and_index():
    s = {G.stream_seed(5, p, i) for p in ("a", "b") for i in (0, 1, -1)}
    assert len(s) == 6 and all(0 <= v < 2**63 for v in s)
    assert G.stream_seed(2**40 + 3, "a") == G.stream_seed(2**40 + 3, "a")
