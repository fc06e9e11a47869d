"""The redesigned K1 (runs pass and fix-up walk) and K4, their host side
and their contracts, on the CPU.

The kernels run only on the card (`chip_smoke.py`); here:

1. the write-set contract of K1 on the card — the runs pass's gap zeros
   and inner runs plus the fix-up's chain stores cover every output row
   exactly once — checked with a plain model of the kernels' stores under
   hypothesis over run layouts;
2. a plain mirror of the fix-up's walk (tiles of 32 pieces, ballots,
   windows of 32 steps) in both slot layouts and under the chunk
   contract, equal bit for bit to `carry_fixup_plain` and
   `carry_fixup_chunk_plain`;
3. K1's lane-map chooser;
4. `ops.delinearize` at ragged lengths equal to `encoding.delinearize` and
   to the JAX package's Pallas decode (interpret mode), with no padding;
5. K4's decode-route chooser against the shared-memory limit.

Sums on one CPU thread (the plain versions' ``index_add_`` then runs in
index order).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro_torch.core import alto as talto
from repro_torch.core import encoding as tenc
from repro_torch.core import plan as tplan
from repro_torch.kernels import delinearize as tk4
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn
from repro_torch.sparse.tensor import SparseTensor

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMEM = 232_448          # one CTA's opt-in shared memory on an H100
WIN = 32                     # FIX_WIN in csrc/carry_fixup.cuh
LAYOUT = settings(max_examples=60, deadline=None, derandomize=True,
                  database=None)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffs(mask: int) -> int:
    """__ffs: 1 + the index of the lowest set bit, 0 for none."""
    return (mask & -mask).bit_length()


# ---------------------------------------------------------------------------
# A plain mirror of the fix-up's walk (csrc/carry_fixup.cuh)
# ---------------------------------------------------------------------------

def _chunk_start(rows, out, chunk, R, stores):
    """(b) and (d) of the chunk contract; returns (cout_row, cout_val)."""
    crow = int(chunk[0][0])
    if crow >= 0 and crow != rows[0]:
        out[crow] = chunk[1][0]
        stores.append(crow)
    return (-1, torch.zeros(R)) if chunk[2] else (None, None)


def tiled_fixup(row, val, out, slots, chunk=None):
    """carry_fixup_tiles_kernel, step for step: a tile of 32 pieces per
    warp, heads and links from the tile's rows, chain ends from a ballot of
    the links, the chains inside the tile folded each alone, the tile's
    last chain walked on in windows of 32 steps. ``row`` (n,), ``val``
    (n, R); ``chunk`` is ``(cin_row (1,), cin_val (1, R), final)``. Stores
    into ``out``; returns ``(out, stores, cout_row, cout_val)`` with
    ``stores`` the rows stored."""
    n, R = val.shape
    rows = [int(r) for r in row]
    stores = []
    cout_row, cout_val = (_chunk_start(rows, out, chunk, R, stores)
                          if chunk else (None, None))
    crow = int(chunk[0][0]) if chunk else None

    def get(q):
        return rows[q] if 0 <= q < n else -1

    def holds_last(q):
        return q == n - 1 or (q == n - 2 and slots == 2 and rows[n - 1] < 0)

    def store(r, acc, to_cout):
        nonlocal cout_row, cout_val
        if to_cout:
            cout_row, cout_val = r, acc.clone()
        else:
            out[r] = acc
            stores.append(r)

    for base in range(0, n, WIN):
        head, link, nxt = [], [], []
        for lane in range(WIN):
            p = base + lane
            r = get(p)
            b, slot = divmod(p, slots)
            h = r >= 0
            if h and slot == 0 and b > 0:
                prev = get(p - 1)
                if prev < 0 and slots == 2:
                    prev = get(p - 2)
                h = prev != r
            np_ = slots * (b + 1)
            lk = (r >= 0 and (slots == 1 or slot == 1 or get(p + 1) < 0)
                  and get(np_) == r)
            head.append(h)
            link.append(lk)
            nxt.append(np_ - base)
        links = sum(1 << j for j in range(WIN) if link[j])
        steps = 0x55555555 if slots == 2 else 0xFFFFFFFF
        end = list(range(WIN))
        for lane in range(WIN):
            if head[lane] and link[lane]:
                end[lane] = WIN
                if nxt[lane] < WIN:
                    cand = ~links & steps & ((0xFFFFFFFF << nxt[lane])
                                             & 0xFFFFFFFF)
                    if cand:
                        end[lane] = _ffs(cand) - 1

        def fold(lane, stop):
            hp = base + lane
            acc = val[hp].clone()
            if chunk and hp == 0 and crow == rows[0]:
                acc = chunk[1][0] + acc
            q = slots * (hp // slots + 1)
            while q <= stop:
                acc = acc + val[q]
                q += slots
            return acc

        for lane in range(WIN):                     # chains inside the tile
            if head[lane] and end[lane] < WIN:
                last = base + end[lane]
                store(rows[base + lane], fold(lane, last),
                      bool(chunk) and not chunk[2] and holds_last(last))
        longs = [j for j in range(WIN) if head[j] and end[j] == WIN]
        if not longs:
            continue
        hl = longs[0]
        lrow = rows[base + hl]
        acc = fold(hl, base + WIN - 1)
        s = (base + WIN) // slots
        last = None
        while True:                                  # windows of 32 steps
            stop = endm = 0
            for j in range(WIN):
                q = slots * (s + j)
                r0 = get(q)
                r1 = get(q + 1) if slots == 2 and q < n else -1
                cont = r0 == lrow
                lnk = cont and (slots == 1 or r1 < 0)
                stop |= (not cont) << j
                endm |= (cont and not lnk) << j
            k = min(_ffs(stop) - 1 if stop else WIN,
                    _ffs(endm) if endm else WIN)
            for j in range(k):
                acc = acc + val[slots * (s + j)]
            if k > 0:
                last = slots * (s + k - 1)
            if stop | endm:
                break
            s += WIN
        store(lrow, acc, bool(chunk) and not chunk[2] and holds_last(last))
    return out, stores, cout_row, cout_val



def _pieces_of(rows_np, block_m, R, seed):
    """K1's carries of a sorted row stream (the runs pass's plain version
    on random terms): (out with inner runs, carry_row, carry_val)."""
    M = rows_np.shape[0]
    rows = torch.from_numpy(rows_np.astype(np.int32))
    g = torch.Generator().manual_seed(seed)
    contrib = torch.randn((M, R), generator=g)
    sums = tori.block_run_sums(contrib, rows, block_m)
    return tori.split_block_runs(sums, rows, int(rows_np.max()) + 1)


@st.composite
def run_layouts(draw):
    """Sorted row streams padded as `ops.pad_sorted_stream` pads them:
    leading and trailing empty rows, runs that cover many slices, gaps."""
    block_m = draw(st.sampled_from([1, 2, 8, 16, 64]))
    n_rows = draw(st.integers(1, 40))
    counts = draw(st.lists(st.sampled_from([0, 0, 1, 2, 3, 7, 70, 300]),
                           min_size=n_rows, max_size=n_rows))
    if sum(counts) == 0:
        counts[draw(st.integers(0, n_rows - 1))] = 1
    extra = draw(st.integers(0, 5))                  # trailing empty rows
    rows = np.repeat(np.arange(n_rows), counts)
    pad = (-rows.shape[0]) % block_m
    rows = np.concatenate([rows, np.full(pad, rows[-1])])
    return rows, block_m, n_rows + extra


# ---------------------------------------------------------------------------
# 1. Every row of K1's output written exactly once
# ---------------------------------------------------------------------------

def runs_pass_stores(rows_np, block_m, n_rows):
    """Rows the runs pass (mttkrp_carry_runs_kernel with zero_gaps) stores,
    slice by slice: zeros for the rows before its first row that the
    previous slice did not reach (all rows below the first in slice 0),
    each inner run, the gaps between its runs, and in the last slice the
    rows above the stream's last row."""
    stores = []
    nb = rows_np.shape[0] // block_m
    for b in range(nb):
        sl = [int(r) for r in rows_np[b * block_m:(b + 1) * block_m]]
        lo = 0 if b == 0 else int(rows_np[b * block_m - 1]) + 1
        stores += range(lo, sl[0])
        runs = [sl[0]] + [r for i, r in enumerate(sl[1:], 1)
                          if r != sl[i - 1]]
        for i in range(1, len(runs)):
            if i < len(runs) - 1:
                stores.append(runs[i])             # an inner run
            stores += range(runs[i - 1] + 1, runs[i])
        if b == nb - 1:
            stores += range(sl[-1] + 1, n_rows)
    return stores


@LAYOUT
@given(layout=run_layouts())
def test_k1_writes_every_output_row_exactly_once(layout):
    rows_np, block_m, n_rows = layout
    _, crow, cval = _pieces_of(rows_np, block_m, 4, seed=0)
    out = torch.full((n_rows, 4), float("nan"))
    _, fix_stores, _, _ = tiled_fixup(crow.reshape(-1), cval.reshape(-1, 4),
                                      out, 2)
    stores = runs_pass_stores(rows_np, block_m, n_rows) + fix_stores
    assert sorted(stores) == list(range(n_rows))


# ---------------------------------------------------------------------------
# 2. The walk folds as the plain fix-ups do, bit for bit
# ---------------------------------------------------------------------------

@LAYOUT
@given(layout=run_layouts(), seed=st.integers(0, 2**16))
def test_walk_equals_carry_fixup_plain_two_slots(layout, seed):
    rows_np, block_m, _ = layout
    out, crow, cval = _pieces_of(rows_np, block_m, 5, seed)
    want = tori.carry_fixup_plain(crow, cval, out.clone())
    got, stores, _, _ = tiled_fixup(crow.reshape(-1), cval.reshape(-1, 5),
                                    out.clone(), 2)
    assert torch.equal(got, want)
    assert len(stores) == len(set(stores))          # one store per chain


@LAYOUT
@given(counts=st.lists(st.integers(1, 90), min_size=1, max_size=30),
       seed=st.integers(0, 2**16))
def test_walk_equals_carry_fixup_plain_one_slot(counts, seed):
    """The pull's layout: every piece present, sorted by row."""
    rows = torch.from_numpy(np.repeat(np.arange(len(counts)), counts)
                            .astype(np.int32))
    g = torch.Generator().manual_seed(seed)
    val = torch.randn((rows.shape[0], 1, 3), generator=g)
    out = torch.zeros((len(counts), 3))
    want = tori.carry_fixup_plain(rows[:, None], val, out.clone())
    got, _, _, _ = tiled_fixup(rows, val[:, 0], out.clone(), 1)
    assert torch.equal(got, want)


@LAYOUT
@given(layout=run_layouts(), seed=st.integers(0, 2**16),
       cin=st.sampled_from(["none", "joins", "closes"]),
       final=st.booleans())
def test_walk_equals_carry_fixup_chunk_plain(layout, seed, cin, final):
    """The chunk contract: a carry-in that joins the first chain, one that
    closed on the boundary, or none; the last chain handed on unless the
    chunk is final."""
    rows_np, block_m, n_rows = layout
    shift = 2 if cin == "closes" else 0       # the carry-in's row is below
    rows_np = rows_np + shift
    out, crow, cval = _pieces_of(rows_np, block_m, 4, seed)
    out = torch.zeros((n_rows + shift, 4))
    cin_row = torch.tensor([{"none": -1, "joins": int(rows_np[0]),
                             "closes": 0}[cin]], dtype=torch.int32)
    g = torch.Generator().manual_seed(seed + 1)
    cin_val = (torch.zeros((1, 4)) if cin == "none"
               else torch.randn((1, 4), generator=g))
    w_out, w_row, w_val = tori.carry_fixup_chunk_plain(
        crow, cval, out.clone(), cin_row, cin_val, final)
    got, _, c_row, c_val = tiled_fixup(
        crow.reshape(-1), cval.reshape(-1, 4), out.clone(), 2,
        (cin_row, cin_val, final))
    assert torch.equal(got, w_out)
    assert c_row == int(w_row[0])
    assert torch.equal(c_val, w_val[0])


def test_tile_walk_takes_several_windows():
    """A chain of 300 blocks (ten windows) and ones ending on a window's
    last step, in both slot layouts."""
    for n_blocks in (300, 32 + 16, 16 + 32 * 3):
        rows_np = np.concatenate([np.zeros(n_blocks, dtype=np.int64), [1]])
        out, crow, cval = _pieces_of(rows_np, 1, 3, seed=n_blocks)
        want = tori.carry_fixup_plain(crow, cval, out.clone())
        got, _, _, _ = tiled_fixup(crow.reshape(-1), cval.reshape(-1, 3),
                                   out.clone(), 2)
        assert torch.equal(got, want)
        flat = torch.from_numpy(rows_np.astype(np.int32))
        v = torch.randn((flat.shape[0], 1, 3))
        assert torch.equal(
            tiled_fixup(flat, v[:, 0], torch.zeros((2, 3)), 1)[0],
            tori.carry_fixup_plain(flat[:, None], v, torch.zeros((2, 3))))


@pytest.mark.parametrize("chain,slots", [
    (1, 2), (2, 2), (31, 2), (32, 2), (33, 2), (1000, 2),
    (1, 1), (21, 1), (64, 1), (1000, 1)])
def test_walk_at_the_main_path_chain_lengths(chain, slots):
    """Chains as the main path gives them — DARPA's of one or two pieces,
    the pull's of about 21 on Chicago mode 0, Chicago's of ~1,000 blocks —
    and chains that end on a tile's or a window's edge, every row of
    ``chain`` pieces, the last one cut short."""
    n_rows = max(2, 600 // chain + 1)
    rows_np = np.repeat(np.arange(n_rows), chain)[:-1]
    g = torch.Generator().manual_seed(chain)
    if slots == 2:
        out, crow, cval = _pieces_of(rows_np, 1, 3, seed=chain)
    else:
        crow = torch.from_numpy(rows_np.astype(np.int32))[:, None]
        cval = torch.randn((crow.shape[0], 1, 3), generator=g)
        out = torch.zeros((n_rows, 3))
    want = tori.carry_fixup_plain(crow, cval, out.clone())
    got, stores, _, _ = tiled_fixup(crow.reshape(-1), cval.reshape(-1, 3),
                                    out.clone(), slots)
    assert torch.equal(got, want)
    assert len(stores) == len(set(stores))
    assert torch.equal(tori.carry_fixup(crow, cval, out.clone()), want)


# ---------------------------------------------------------------------------
# K1's wrappers on the CPU: out= and the rank tile
# ---------------------------------------------------------------------------

def _stream(counts, dims=(29, 13, 7), seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    coords = np.stack([rows] + [rng.integers(0, I, size=rows.shape[0])
                                .astype(np.int32) for I in dims[1:]], 1)
    x = SparseTensor(dims, coords, rng.standard_normal(
        rows.shape[0]).astype(np.float32))
    at = talto.build_device(x, n_partitions=2, device="cpu")
    return at, talto.oriented_view_device(at, 0)


@pytest.mark.parametrize("rank", [5, 16, 40, 200])
def test_k1_into_a_nan_buffer_equals_the_normal_run(rank):
    counts = np.zeros(29, dtype=np.int64)
    counts[[2, 3, 11, 20]] = [1, 40, 3, 17]
    at, view = _stream(counts)
    rng = np.random.default_rng(rank)
    fs = [torch.from_numpy(rng.random((I, rank)).astype(np.float32))
          for I in at.dims]
    want = tops.mttkrp_oriented_carry(view, fs, block_m=8)
    rows, words, values, _ = tops.pad_sorted_stream(view.rows, view.words,
                                                    view.values, 8)
    nan = torch.full((29, rank), float("nan"))
    got = tori.mttkrp_oriented_carry(at.meta.enc, 0, rows, words, values,
                                     fs, block_m=8, out=nan)
    assert got is nan and torch.equal(got, want)
    assert torch.equal(want, tops.mttkrp_oriented(view, fs, block_m=8))


@pytest.mark.parametrize("rank,tile", [(16, 16), (40, 40), (128, 128),
                                       (200, 100), (256, 128), (7, 7)])
def test_rank_tiles(rank, tile):
    """The rank tile of K1 and of the fix-up where the caller names none:
    the largest divisor of the rank up to 128 columns."""
    assert tori.common.rank_tile(rank) == tile
    with pytest.raises(ValueError, match="r_block"):
        tori.carry_fixup(torch.zeros((1, 2), dtype=torch.int32),
                         torch.zeros((1, 2, rank)),
                         torch.zeros((1, rank)), r_block=rank + 1)


# ---------------------------------------------------------------------------
# 3. K1's lane maps
# ---------------------------------------------------------------------------

def test_lane_maps_cover_every_rank_tile_with_four_maps():
    assert len(tori.LANE_MAPS) <= 4
    for lanes, cols in tori.LANE_MAPS:
        assert 32 % lanes == 0 and cols >= 1
    for rb in range(1, 129):
        lanes, cols = tori.lane_map(rb)
        assert lanes * cols >= rb
        smaller = [m for m in tori.LANE_MAPS if m[0] * m[1] >= rb]
        assert (lanes, cols) == smaller[0]
    with pytest.raises(ValueError, match="lane map"):
        tori.lane_map(129)


def test_lane_maps_match_the_kernel_dispatch():
    """The C dispatch builds exactly the maps the chooser picks from, and
    K1 (with K8) and K3 launch through it."""
    src = (CSRC / "alto_scan.cuh").read_text()
    body = src[src.index("int k1_lane_dispatch"):]
    body = body[:body.index("\n}\n")]
    built = re.findall(r"lanes == (\d+) && cols == (\d+)\) return "
                       r"L<(\d+), (\d+)>", body)
    assert [(int(a), int(b)) for a, b, _, _ in built] == list(tori.LANE_MAPS)
    assert all(a == c and b == d for a, b, c, d in built)
    for name, launch in (("mttkrp_oriented.cu", "MttkrpCarryRunsLaunch"),
                         ("mttkrp.cu", "MttkrpPartialsLaunch")):
        assert (f"k1_lane_dispatch<{launch}>(lanes, cols, p)"
                in (CSRC / name).read_text())


# ---------------------------------------------------------------------------
# 4. K4 at ragged lengths, unpadded
# ---------------------------------------------------------------------------

def _ragged_lengths():
    """1, 1023, 1025, and the chunk length of a small streamed plan (a
    block multiple that no tile divides)."""
    x = tsyn.uniform_tensor((300, 200, 5000), 9000, seed=3)
    at = talto.build_device(x, n_partitions=8, device="cpu")
    L = tplan.heuristics.stream_len(at.meta)
    budget = (tplan.streaming_resident_bytes(at.meta, 4)
              + 2 * tplan.stream_elem_bytes(at.meta) * -(-L // 7))
    chunk = tplan.make_plan(at.meta, 4, backend="cuda",
                            device_bytes=budget).streaming.chunk_m
    assert chunk % tk4.TILE
    return [1, 1023, 1025, chunk]


@pytest.mark.parametrize("dims", [(6186, 24, 77, 32),
                                  (22476, 22476, 23_776_223),
                                  (3, 5, 7, 11, 13)], ids=str)
def test_delinearize_ragged_lengths_unpadded(dims, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("ops.delinearize padded the words")
    monkeypatch.setattr(tops, "pad_sorted_stream", refuse)
    enc = tenc.make_encoding(dims)
    rng = np.random.default_rng(len(dims))
    for M in _ragged_lengths():
        coords = np.stack([rng.integers(0, d, M) for d in dims],
                          axis=1).astype(np.int32)
        words = tenc.linearize_np(enc, coords)
        got = tops.delinearize(enc, tenc.words_from_np(words))
        assert got.shape == (M, len(dims)) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), coords)
        np.testing.assert_array_equal(
            got.numpy(), tenc.delinearize(enc, tenc.words_from_np(words))
            .numpy())
        ref = jops.delinearize(jenc.make_encoding(dims), jnp.asarray(words),
                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_delinearize_rejects_an_unknown_route():
    enc = tenc.make_encoding((30, 24, 20))
    words = torch.zeros((10, enc.n_words), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        tk4.delinearize(enc, words, route="global")


# ---------------------------------------------------------------------------
# 5. K4's decode route against the shared-memory limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [16 * 1024, 48 * 1024, H100_SMEM])
@pytest.mark.parametrize("dims", [(6186, 24, 77, 32),
                                  (22476, 22476, 23_776_223),
                                  (1 << 16,) * 8,
                                  (2, 2)], ids=str)
@pytest.mark.parametrize("tile", [4, 1024, 4096])
def test_route_chooser_respects_the_shared_memory_limit(dims, limit, tile):
    enc = tenc.make_encoding(dims)
    route = tk4.choose_route(enc, tile, limit)
    fits = tk4.smem_bytes(enc, tile, "smem") <= limit
    assert route == ("smem" if fits else "l1")
    assert tk4.smem_bytes(enc, tile, "l1") == tile * len(dims) * 4


def test_table_bytes_of_the_paper_shapes():
    """Chicago's tables take 16 KB, DARPA's 24 KB: both fit with a tile of
    1024 on an H100, and under the default 48 KB."""
    for dims, kb in (((6186, 24, 77, 32), 16), ((22476, 22476, 23_776_223),
                                                24)):
        enc = tenc.make_encoding(dims)
        assert tk4.smem_bytes(enc, 1024, "smem") - 1024 * len(dims) * 4 \
            == kb * 1024
        assert tk4.choose_route(enc, 1024, 48 * 1024) == "smem"


def test_chip_smoke_names_the_redesigned_kernels():
    """`chip_smoke.py` checks the stack frames of kernels by name: each
    name must be a kernel of the CUDA sources."""
    import chip_smoke
    sources = "".join(p.read_text() for p in CSRC.glob("*.cu*"))
    for name in chip_smoke.NEW_KERNELS:
        assert re.search(r"__global__ void " + name + r"\(", sources), name
