"""Device ms per CP-APR outer iteration of the recursive Φ's pull
(`kernels.ops.pull_reduction`): the time of K1's fix-up kernel
(``carry_fixup_tiles_kernel``, `kernels/csrc/carry_fixup.cuh`) among the
traced window's top device operations (`bench.metrics._kernels`), not
through a span. The fix-up also closes the carry route's runs (K5, K1),
so the metric is read only in a window where neither carry kernel ran:
there its time is the pull's alone. The gather of the Temp rows into
pull order that precedes it (a PyTorch kernel) is not counted."""
from bench.metrics import _kernels

UNIT = "ms"
KERNEL = "carry_fixup_tiles_kernel"
CARRY = ("phi_carry_runs_kernel", "mttkrp_carry_runs_kernel")


def read(reading):
    if any(_kernels.ran(reading, k) for k in CARRY):
        return None
    return _kernels.per_iteration_ms(reading, "apr_outer_ms", KERNEL)
