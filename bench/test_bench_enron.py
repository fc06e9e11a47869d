"""The ``enron.cp_apr`` cell: CP-APR with every mode on the recursive
traversal, its control, and the readers of K7 and the pull.

On the CPU: a small 4-mode blocked tensor whose static plan routes every
mode recursive under ALTO-OTF, as FROSTT Enron's does at its published
size, solved by `repro_torch.core.cpapr.cp_apr` through the kernels'
plain versions (K7 and the pull's fix-up) and held against the plain
reference (`bench.reference.cpd.cp_apr`, float64) from the same start;
the control at the small stand-in shape; `phi_recursive_ms` and
`phi_pull_ms` on hand-made traced windows. On the card (``card``): the
control fails the cell's limits at the cell's size on three seeds.
"""
import pytest
import torch

from bench import calibrate, generators, harness
from bench import tracing
from bench.test_bench_control import _verdicts

NAME = "enron.cp_apr"
RANK = 16
# Three blocks of side 10 at density 0.6: fiber reuse 6 on every mode,
# above the recursive threshold (4); Temps of tens of rows in 8
# partitions.
SMALL_ENRON = dict(dims=[64, 48, 200, 40], nnz=18000, n_partitions=8,
                   generator={"kind": "blocked", "block": 10, "n_blocks": 3,
                              "count_max": 9, "layout_seed": 1})
# Gaps of the float32 port (plain versions, one CPU thread) to the
# float64 reference on this tensor, seeds 1-6 and 2**31 + 9: at most
# 2.3e-5 (KKT), 5.9e-7 (log-likelihood), 7.4e-6 (factors), 1.9e-6 (λ),
# float32 rounding through 200 Φ evaluations and 50 multiplicative
# updates a mode. The reference in bfloat16 on the same seeds: at least
# 0.032, 0.0031, 0.025, 0.0086. Each tolerance leaves 40 to 50 times room
# above the port and 30 to 100 times below bfloat16, so a Φ computed in
# half the precision, or a dropped or doubled partition, fails it.
TOLERANCE = {"kkt_gap": 1e-3, "ll_gap": 3e-5, "factor_gap": 3e-4,
             "lam_gap": 1e-4}


def _small_port(seed):
    from repro_torch.core import alto
    from repro_torch.core import plan as plan_mod
    from repro_torch.sparse.tensor import SparseTensor

    cell = harness.load_cell(NAME)
    cell.config = {**cell.config, **SMALL_ENRON}
    coo = generators.make_tensor(cell.config, seed, "cpu")
    x = SparseTensor(coo.dims, coo.coords.to(torch.int32).numpy(),
                     coo.values.numpy())
    at = alto.build_device(x, n_partitions=cell.config["n_partitions"],
                           device="cpu")
    # The kernels' backend: on CPU tensors each wrapper runs its plain
    # version (K7's `phi_partials_plain`, the fix-up's).
    plan = plan_mod.plan_for(at, RANK, backend="cuda")
    views = plan_mod.build_views(at, plan)
    return cell, coo, harness.Port(at=at, plan=plan, views=views, rank=RANK)


def test_small_enron_routes_every_mode_recursive_under_otf():
    from repro_torch.core import heuristics

    _, _, port = _small_port(3)
    assert port.plan.traversals() == ("recursive",) * 4
    assert port.plan.pi_policy is heuristics.PiPolicy.OTF
    assert port.views == {}
    assert min(port.at.meta.fiber_reuse) > heuristics.BUFFERED_ACCUM_COST


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_all_recursive_cp_apr_matches_the_plain_reference(seed,
                                                          monkeypatch):
    from repro_torch.kernels import cpapr_phi

    cell, coo, port = _small_port(seed)
    solver, traffic = cell.solver, cell.traffic
    calls = []
    plain = cpapr_phi.phi_partials_plain
    monkeypatch.setattr(cpapr_phi, "phi_partials_plain",
                        lambda *a, **k: calls.append(a[1]) or plain(*a, **k))
    init = solver.initial(coo, RANK, seed, 0)
    ans = solver.answer(solver.solve(port, traffic, init))
    n_phi = traffic["k_max"] * traffic["l_max"]
    assert sorted(calls) == sorted(list(range(4)) * n_phi)
    ref = solver.reference(coo, traffic, init, "float64")
    numbers = solver.compare(coo, ans, ref)
    assert set(numbers) == set(TOLERANCE)
    for k, v in numbers.items():
        assert v <= TOLERANCE[k], (k, v)


def test_control_fails_at_a_small_shape(small_cell):
    verdicts = _verdicts(small_cell(NAME), [2**31 + 7, 5], "cpu")
    assert verdicts["program"] == [True, True]
    (control,) = [v for k, v in verdicts.items() if k.startswith("control")]
    assert control == [False, False]


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    cell = harness.load_cell(NAME)
    readings = list(calibrate.readings(cell, [], [2**31 + 1, 2**31 + 2, 3],
                                       card))
    assert len(readings) == 3
    for r in readings:
        assert any(r[k] > v for k, v in cell.spec["limits"].items()), r


# ---------------------------------------------------------------------------
# The readers of K7 and the pull
# ---------------------------------------------------------------------------

K7 = ("void (anonymous namespace)::phi_partials_smem_kernel<4, 4, 1>("
      "(anonymous namespace)::AltoArgs, (anonymous namespace)::Tenants, ")
FIXUP = ("(anonymous namespace)::carry_fixup_tiles_kernel((anonymous "
         "namespace)::FixupArgs)")
K5 = "void (anonymous namespace)::phi_carry_runs_kernel<4, 4, 1>(...)"
GATHER = "void at::native::vectorized_gather_kernel<16, long>(...)"


def _reading(ops, metric="apr_outer_ms", iterations=5, busy_s=3.0):
    trace = tracing.TraceSummary(window_s=3.2, busy_s=busy_s,
                                 span_busy_s={}, device_ops=ops,
                                 idle_gaps=[])
    return harness.Reading(metric=metric, setup={}, trace=trace,
                           iterations=iterations, bound_s=0.0)


def _read(name, reading):
    return harness.metric_readers()[name].read(reading)


def test_readers_on_an_all_recursive_window():
    r = _reading([(K7, 2.5), (FIXUP, 0.2), (GATHER, 0.1)])
    assert _read("phi_recursive_ms", r) == pytest.approx(500.0)
    assert _read("phi_pull_ms", r) == pytest.approx(40.0)


def test_pull_is_not_read_where_the_fixup_also_closes_carries():
    r = _reading([(K5, 1.3), (K7, 0.77), (FIXUP, 0.185)], iterations=70)
    assert _read("phi_recursive_ms", r) == pytest.approx(11.0)
    assert _read("phi_pull_ms", r) is None


@pytest.mark.parametrize("reading", [
    _reading([(K7, 2.5), (FIXUP, 0.2)], metric="als_iter_ms"),
    _reading([(K7, 2.5), (FIXUP, 0.2)], busy_s=0.0),
    _reading([(K7, 2.5), (FIXUP, 0.2)], iterations=0),
    _reading([(K5, 1.5), (GATHER, 0.1)]),
], ids=["cp_als", "idle", "no-iteration", "no-k7-nor-fixup"])
def test_readers_read_nothing_without_their_kernels(reading):
    assert _read("phi_recursive_ms", reading) is None
    assert _read("phi_pull_ms", reading) is None


def test_readers_units():
    readers = harness.metric_readers()
    assert readers["phi_recursive_ms"].UNIT == "ms"
    assert readers["phi_pull_ms"].UNIT == "ms"
