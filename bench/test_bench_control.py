"""The control comes out not correct: the plain reference computed in the
nearest precision below the configuration's (TF32 products for CP-ALS,
bfloat16 for CP-APR) fails at least one of the cell's limits on every
seed, where the port passes them all.

At a small stand-in shape on the CPU here; at the cell's own size on the
card (``card``), on three seeds.
"""
import pytest

from bench import calibrate, harness

CELLS = ["darpa1998.cp_als", "chicago-crime-comm.cp_apr",
         "darpa1998.cp_apr", "chicago-crime-comm.cp_als"]


def _verdicts(cell, seeds, device):
    limits = cell.spec["limits"]
    out = {}
    for r in calibrate.readings(cell, seeds, seeds, device):
        passed = all(r[k] <= v for k, v in limits.items())
        out.setdefault(r["side"], []).append(passed)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_shape(small_cell, name):
    verdicts = _verdicts(small_cell(name), [2**31 + 7, 5], "cpu")
    assert verdicts["program"] == [True, True]
    (control,) = [v for k, v in verdicts.items() if k.startswith("control")]
    assert control == [False, False]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = harness.load_cell(name)
    readings = calibrate.readings(cell, [], [2**31 + 1, 2**31 + 2, 3], card)
    for r in readings:
        assert any(r[k] > v for k, v in cell.spec["limits"].items()), r
