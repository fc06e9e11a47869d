"""Plain CP-ALS and CP-APR from COO inputs (paper Alg. 1 and Alg. 2).

Works from the coordinates, the values and the initial factors that the
harness hands to both sides, and from nothing the port derived. Sums over
nonzeros run in blocks of `CHUNK` through ``index_add_``, so the largest
temporary is a block's (CHUNK, R) rows.

``precision`` picks the arithmetic:

* ``"float64"``: the reference;
* ``"tf32"``: float32 whose matrix products take their operands rounded
  to TF32's 10-bit mantissa (`round_tf32`), the card's TF32 mode emulated
  so that it behaves the same on the CPU: the control of a float32
  configuration whose dense algebra runs with TF32 off;
* ``"bfloat16"``: every array in bfloat16: the control of a float32
  configuration with no TF32 path (CP-APR has no matrix product).

The fit and the log-likelihood are always taken in float64.
"""
from __future__ import annotations

import dataclasses
import math

import torch

CHUNK = 1 << 22
PRECISIONS = ("float64", "tf32", "bfloat16")


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(
        precision, torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def _blocks(m: int):
    for s in range(0, m, CHUNK):
        yield s, min(m, s + CHUNK)


def khatri_rao_rows(coords: torch.Tensor, factors, mode: int,
                    s: int, e: int) -> torch.Tensor:
    """Rows s:e of the Khatri-Rao product of every factor but ``mode``."""
    out = None
    for m, A in enumerate(factors):
        if m == mode:
            continue
        rows = A[coords[s:e, m]]
        out = rows if out is None else out * rows
    return out


def mttkrp(coords: torch.Tensor, values: torch.Tensor, factors,
           mode: int) -> torch.Tensor:
    """M[i, :] = Σ over nonzeros in row i of x · Π_{m≠mode} A_m[i_m, :]."""
    A = factors[mode]
    out = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    for s, e in _blocks(values.shape[0]):
        krp = khatri_rao_rows(coords, factors, mode, s, e)
        out.index_add_(0, coords[s:e, mode], values[s:e, None] * krp)
    return out


def model_values(coords: torch.Tensor, lam: torch.Tensor, factors,
                 s: int, e: int) -> torch.Tensor:
    """Σ_r λ_r Π_m A_m[i_m, r] at the nonzeros s:e."""
    prod = lam[None, :].expand(e - s, -1)
    for m, A in enumerate(factors):
        prod = prod * A[coords[s:e, m]]
    return prod.sum(dim=1)


# ---------------------------------------------------------------------------
# CP-ALS
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AlsOut:
    lam: torch.Tensor
    factors: list[torch.Tensor]
    fits: list[float]


def als_fit(coords, values, lam, factors) -> float:
    """Kolda–Bader fit 1 − ‖X − X̂‖ / ‖X‖ in float64, the inner product
    summed over the nonzeros (not through an MTTKRP)."""
    lam = lam.double()
    factors = [A.double() for A in factors]
    v = values.double()
    norm_x2 = float((v * v).sum())
    if norm_x2 == 0.0:
        return 1.0
    inner = sum(float((v[s:e] * model_values(coords, lam, factors, s, e))
                      .sum()) for s, e in _blocks(v.shape[0]))
    V = None
    for A in factors:
        g = A.T @ A
        V = g if V is None else V * g
    norm_m2 = float((torch.outer(lam, lam) * V).sum())
    resid2 = max(norm_x2 + norm_m2 - 2.0 * inner, 0.0)
    return 1.0 - math.sqrt(resid2) / math.sqrt(norm_x2)


def cp_als(coords: torch.Tensor, values: torch.Tensor, factors0,
           n_iters: int, precision: str = "float64") -> AlsOut:
    """``n_iters`` CP-ALS iterations from ``factors0`` (no early stop):
    per mode the MTTKRP, the solve with the pseudo-inverse of the
    Hadamard product of the other Grams, and column 2-norms into λ."""
    dt = _dtype(precision)
    coords = coords.long()
    vals = values.to(dt)
    A = [f.to(dt).clone() for f in factors0]
    R = A[0].shape[1]
    lam = torch.ones(R, dtype=dt, device=vals.device)
    grams = [_matmul(X.T, X, precision) for X in A]
    fits = []
    for _ in range(n_iters):
        for n in range(len(A)):
            V = None
            for m, g in enumerate(grams):
                if m != n:
                    V = g if V is None else V * g
            M = mttkrp(coords, vals, A, n)
            An = _matmul(M, torch.linalg.pinv(V), precision)
            lam = torch.linalg.vector_norm(An, dim=0)
            lam = torch.where(lam > 0, lam, torch.ones_like(lam))
            A[n] = An / lam[None, :]
            grams[n] = _matmul(A[n].T, A[n], precision)
        fits.append(als_fit(coords, values, lam, A))
    return AlsOut(lam=lam, factors=A, fits=fits)


# ---------------------------------------------------------------------------
# CP-APR
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AprOut:
    lam: torch.Tensor
    factors: list[torch.Tensor]
    kkts: list[float]


def phi(coords, values, B, factors, mode: int, eps: float) -> torch.Tensor:
    """Φ[i, :] = Σ over nonzeros in row i of x / max(<B[i, :], π>, eps) · π,
    π the nonzero's Khatri-Rao row of the other modes."""
    out = torch.zeros(B.shape, dtype=B.dtype, device=B.device)
    for s, e in _blocks(values.shape[0]):
        krp = khatri_rao_rows(coords, factors, mode, s, e)
        rows = coords[s:e, mode]
        dot = (B[rows] * krp).sum(dim=1)
        w = values[s:e] / torch.clamp_min(dot, eps)
        out.index_add_(0, rows, w[:, None] * krp)
    return out


def cp_apr(coords: torch.Tensor, values: torch.Tensor, lam0, factors0, *,
           k_max: int, l_max: int, tau: float, kappa: float,
           kappa_tol: float, eps_div: float,
           precision: str = "float64") -> AprOut:
    """``k_max`` outer iterations of the multiplicative update: per mode
    B = (A + S)Λ with the inadmissible-zero shift S (from the second outer
    iteration on), up to ``l_max`` inner steps B ← B ∘ Φ(B) stopping once
    the KKT violation max|min(B, 1 − Φ)| is below ``tau``, then λ = 1ᵀB
    and A = B Λ⁻¹. The KKT value of an outer iteration is the largest
    over the modes of each mode's first inner step."""
    dt = _dtype(precision)
    coords = coords.long()
    vals = values.to(dt)
    A = [f.to(dt).clone() for f in factors0]
    lam = lam0.to(dt).clone()
    phi_prev = [torch.zeros_like(X) for X in A]
    kkts = []
    for outer in range(k_max):
        kkt_max = 0.0
        for n in range(len(A)):
            if outer == 0:
                S = torch.zeros_like(A[n])
            else:
                S = torch.where((A[n] < kappa_tol) & (phi_prev[n] > 1.0),
                                torch.full_like(A[n], kappa),
                                torch.zeros_like(A[n]))
            B = (A[n] + S) * lam[None, :]
            Phi = None
            kkt_first = None
            for _ in range(l_max):
                Phi = phi(coords, vals, B, A, n, eps_div)
                kkt = float(torch.minimum(B, 1.0 - Phi).abs().max())
                if kkt_first is None:
                    kkt_first = kkt
                if kkt < tau:
                    break
                B = B * Phi
            lam = B.sum(dim=0)
            lam = torch.where(lam > 0, lam, torch.ones_like(lam))
            A[n] = B / lam[None, :]
            phi_prev[n] = Phi
            kkt_max = max(kkt_max, kkt_first)
        kkts.append(kkt_max)
    return AprOut(lam=lam, factors=A, kkts=kkts)


def log_likelihood(coords, values, lam, factors, eps: float = 1e-10
                   ) -> float:
    """Poisson log-likelihood Σ x·log(m) − Σ_r λ_r of a model whose factor
    columns sum to 1, in float64."""
    lam = lam.double()
    factors = [A.double() for A in factors]
    v = values.double()
    ll = 0.0
    for s, e in _blocks(v.shape[0]):
        m = model_values(coords.long(), lam, factors, s, e)
        ll += float((v[s:e] * torch.log(torch.clamp_min(m, eps))).sum())
    return ll - float(lam.sum())
