"""ALTO format, plans, MTTKRP and CP-ALS (the main path of the port)."""
from repro_torch.core.encoding import AltoEncoding, make_encoding
from repro_torch.core.alto import (AltoMeta, AltoTensor, OrientedView, build,
                                   build_device, oriented_view,
                                   oriented_view_device, to_sparse)
from repro_torch.core.heuristics import Traversal
from repro_torch.core.plan import ExecutionPlan, ModePlan, make_plan

__all__ = [
    "AltoEncoding", "make_encoding", "AltoMeta", "AltoTensor",
    "OrientedView", "build", "build_device", "oriented_view",
    "oriented_view_device", "to_sparse", "Traversal", "ExecutionPlan",
    "ModePlan", "make_plan",
]
