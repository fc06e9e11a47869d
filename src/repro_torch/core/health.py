"""Health guards: finite and monotonicity checks, rollback, plan
degradation.

The drivers' contract (monotone CP-ALS fit, finite factors) holds for
finite inputs; a serving endpoint sees the other kind. The guards here
are the detection half of the resilience layer; `core.faults` injects,
and `launch.serve_cpd` recovers.

Two guards, both opt-in (``guard=`` on `cpals.cp_als`, `cpapr.cp_apr`
and the batched drivers of `core.batched`):

* **finite guard**: `all_finite` over a solve's outputs, and
  `tenants_finite` per slot of a bucket. Each is one min/max reduction a
  tensor (`torch.aminmax`, which carries NaN and ±inf into its result
  and allocates no mask) and one copy to the host a check.
* **fit guard**: the CP-ALS fit is monotone; a drop beyond ``slack``, or
  a fit below `FIT_FLOOR`, means the iterate left the admissible region,
  and the last good state is the answer. The fit is already on the host.

On a violation the drivers roll back to the last good ``(factors, λ)``,
stop that solve (or freeze that slot) and report it in a `HealthReport`
(`BatchedCpalsResult.quarantined` for a bucket) instead of raising.

`degrade_plan` is the plan half of the recovery ladder.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import plan as plan_mod

# Divergence floor for the fit guard. The fit is at most 1 and may dip
# mildly negative from a bad start, but a fit below this floor means an
# iterate of huge but finite magnitude (a 1e30 entry): its float32 Gram
# products overflow to inf, and the next sweep's pseudo-inverse must not
# be handed a non-finite matrix. The guard stops it in the sweep that
# produced it, where the all-finite check alone would let it through.
FIT_FLOOR = -1e8


@dataclasses.dataclass
class HealthReport:
    """A guarded solve's outcome, on `CpalsResult` / `CpaprResult`."""
    guarded: bool = True
    checks: int = 0               # guard evaluations run
    violations: int = 0           # non-finite or non-monotone events seen
    rolled_back: bool = False     # result is the last good iterate
    reason: str | None = None     # first violation, human-readable


def _inexact(arrays) -> list[torch.Tensor]:
    return [a for a in arrays
            if a.is_floating_point() or a.is_complex()]


def _extremes(a: torch.Tensor, dim=None) -> torch.Tensor:
    """min and max (over ``dim``, else all), stacked on a new last axis:
    finite iff ``a`` is."""
    if a.numel() == 0:
        shape = () if dim is None else (a.shape[0],)
        return a.new_zeros(shape + (2,))
    lo, hi = (torch.aminmax(a) if dim is None else torch.aminmax(a, dim=dim))
    return torch.stack([lo, hi], dim=-1)


def all_finite(arrays) -> bool:
    """True iff every floating-point tensor is entirely finite."""
    xs = _inexact(arrays)
    if not xs:
        return True
    ext = torch.cat([_extremes(a).to(torch.float64) for a in xs])
    return bool(torch.isfinite(ext).all().item())


def tenants_finite(arrays) -> np.ndarray:
    """Per-slot all-finite mask ``(cap,)`` over stacked ``(cap, ...)``
    tensors; one copy to the host. A bucket's slots never mix (the
    tenant-axis kernels index by slot, the dense algebra runs per slot),
    so this mask is where a poisoned tenant is told apart from its
    mates."""
    xs = _inexact(arrays)
    if not xs:
        raise ValueError("tenants_finite needs at least one floating "
                         "tensor")
    ext = torch.cat([_extremes(a.reshape(a.shape[0], -1), dim=1)
                     .to(torch.float64) for a in xs], dim=1)
    return torch.isfinite(ext).all(dim=1).cpu().numpy()


def device_lost(device) -> BaseException | None:
    """The error a CUDA ``device`` reports once its context is poisoned
    (an illegal address, a failed launch: sticky errors every later call
    returns), else None. Always None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        torch.cuda.synchronize(dev)
    except RuntimeError as exc:      # torch.AcceleratorError subclasses it
        return exc
    return None


# ---------------------------------------------------------------------------
# Degradation ladder (plan half; the store half lives in serve_cpd)
# ---------------------------------------------------------------------------

def degrade_plan(plan: plan_mod.ExecutionPlan, exc: BaseException):
    """The next softer plan after ``plan`` failed with ``exc``, and why;
    ``(None, None)`` when there is none.

    The one rung: allocator exhaustion (`torch.OutOfMemoryError`) on a
    streaming plan halves ``chunk_m``, kept a multiple of the plan's
    largest ``block_m`` (chunk bounds stay block bounds, so the result
    keeps its bits), and recounts the chunks; repeatable down to one
    aligned chunk. The plan keeps its kernels.

    Any other failure gets no softer plan: a `faults.DispatchError`, a
    kernel that fails to build or launch, a poisoned value. Running the
    plain version in place of a kernel would hide it. Transient faults
    (`faults.is_transient`) are retried before this is asked.
    """
    if plan.streaming is not None and isinstance(exc, torch.OutOfMemoryError):
        align = max(m.block_m for m in plan.modes)
        cm = plan.streaming.chunk_m
        new_cm = max(align, ((cm // 2) // align) * align)
        if new_cm < cm:
            streaming = dataclasses.replace(
                plan.streaming, chunk_m=new_cm,
                n_chunks=plan_mod.chunk_count(plan.meta, new_cm))
            return (dataclasses.replace(plan, streaming=streaming),
                    f"halved chunk_m {cm} -> {new_cm}")
    return None, None
