"""Device ms per CP-APR outer iteration of K7, the recursive Φ kernel
(``phi_partials_smem_kernel``, `kernels/csrc/phi_scan.cuh`), all its
window passes included: its time among the traced window's top device
operations (`bench.metrics._kernels`), not through a span. Read wherever
a mode is routed recursive."""
from bench.metrics import _kernels

UNIT = "ms"
KERNEL = "phi_partials_smem_kernel"


def read(reading):
    return _kernels.per_iteration_ms(reading, "apr_outer_ms", KERNEL)
