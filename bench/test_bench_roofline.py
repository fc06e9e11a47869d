"""The roofline count against hand counts."""
import pytest

from bench import roofline as rl


def test_coordinate_bits_and_nonzero_bytes():
    assert rl.coord_bits((8, 5, 3)) == 3 + 3 + 2
    assert rl.coord_bits((1, 2, 1024, 1025)) == 0 + 1 + 10 + 11
    assert rl.nonzero_bytes((8, 5, 3)) == 4 + 1
    # 1998 DARPA: 15 + 15 + 25 bits -> 7 bytes; Chicago: 13 + 5 + 7 + 5 -> 4.
    assert rl.nonzero_bytes((22476, 22476, 23776223)) == 11
    assert rl.nonzero_bytes((6186, 24, 77, 32)) == 8


def test_mttkrp_and_phi_by_hand():
    dims, nnz, distinct, rank = (8, 5, 3), 10, (4, 5, 2), 2
    m0 = rl.mttkrp(dims, nnz, distinct, rank, 0)
    # values and coordinates 10 * 5; rows of modes 1, 2 (5 + 2) * 2 * 4;
    # the output 8 * 2 * 4.
    assert m0.bytes == 50 + 56 + 64 and m0.flops == 40
    m2 = rl.mttkrp(dims, nnz, distinct, rank, 2)
    assert m2.bytes == 50 + (4 + 5) * 8 + 3 * 8
    p0 = rl.phi(dims, nnz, distinct, rank, 0)
    assert p0.bytes == m0.bytes + 4 * 8 and p0.flops == 40
    assert m0.seconds == pytest.approx(170 / 3.35e12)
    assert m0.bound_by == "bytes"


def test_flops_bound_when_bytes_are_few():
    b = rl.Bound(bytes=1, flops=10**9)
    assert b.bound_by == "flops"
    assert b.seconds == pytest.approx(10**9 / 67e12)


def test_iteration_sums():
    dims, nnz, distinct, rank = (8, 5, 3), 10, (4, 5, 2), 2
    als = sum(rl.mttkrp(dims, nnz, distinct, rank, n).seconds
              for n in range(3))
    assert rl.als_iteration_s(dims, nnz, distinct, rank) == pytest.approx(als)
    apr = 7 * sum(rl.phi(dims, nnz, distinct, rank, n).seconds
                  for n in range(3))
    assert rl.apr_outer_s(dims, nnz, distinct, rank, 7) == pytest.approx(apr)
