"""Gaps between an answer and the reference's, each a single number that
a cell's limit holds. A number that is not finite, or a series of another
length than the reference's, reads as infinite."""
from __future__ import annotations

import math

import torch

INF = float("inf")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else INF


def relative(a: float, b: float) -> float:
    """|a − b| / |b|."""
    if b == 0.0:
        return 0.0 if a == 0.0 else INF
    return _finite(abs(float(a) - float(b)) / abs(float(b)))


def series_gap(got, ref, scaled: bool) -> float:
    """The widest gap over a series: absolute, or relative to each
    reference value."""
    got, ref = [float(g) for g in got], [float(r) for r in ref]
    if len(got) != len(ref) or not ref:
        return INF
    if scaled:
        return max(relative(g, r) for g, r in zip(got, ref))
    return _finite(max(abs(g - r) for g, r in zip(got, ref)))


def fit_gap(got, ref) -> float:
    """The widest gap between two fit series over the reference's last
    fit: a fit's rounding error grows with the fit."""
    gap = series_gap(got, ref, scaled=False)
    if gap == INF or gap == 0.0:
        return gap
    last = abs(float(ref[-1]))
    return _finite(gap / last) if last else INF


def vector_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| / max |ref|, in float64."""
    got, ref = got.double().to(ref.device), ref.double()
    if got.shape != ref.shape:
        return INF
    scale = float(ref.abs().max())
    if scale == 0.0:
        return 0.0 if float(got.abs().max()) == 0.0 else INF
    return _finite(float((got - ref).abs().max()) / scale)


def factor_gap(got, ref) -> float:
    """The worst factor's ‖got − ref‖_F / ‖ref‖_F, in float64.

    A norm over the whole factor, not its widest entry: CP-APR's
    inadmissible-zero shift (``A < kappa_tol`` and ``Φ > 1``) decides on
    Φ entries that converge to 1, so rounding alone flips it in a few
    hundred of 1998 DARPA's 380 M time-mode entries, each a jump the size
    of a row's mass."""
    if len(got) != len(ref):
        return INF
    worst = 0.0
    for g, r in zip(got, ref):
        g, r = g.double().to(r.device), r.double()
        if g.shape != r.shape:
            return INF
        scale = float(torch.linalg.norm(r))
        gap = float(torch.linalg.norm(g - r))
        if scale == 0.0:
            worst = max(worst, 0.0 if gap == 0.0 else INF)
        else:
            worst = max(worst, _finite(gap / scale))
    return worst
