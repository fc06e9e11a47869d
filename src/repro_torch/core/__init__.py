"""ALTO format, plans, MTTKRP, CP-ALS and CP-APR."""
import importlib

from repro_torch.core.encoding import AltoEncoding, make_encoding
from repro_torch.core.alto import (AltoMeta, AltoTensor, OrientedView, build,
                                   build_device, oriented_view,
                                   oriented_view_device, to_sparse)
from repro_torch.core.heuristics import Traversal

# The plan and the drivers call the kernel layer, whose modules import
# core modules; they load on first use, so a kernel module imported first
# meets no half-built package.
_LAZY = {"ExecutionPlan": "plan", "ModePlan": "plan", "make_plan": "plan",
         "make_class_plan": "plan", "resident_bytes": "plan",
         "cpals": "cpals", "cpapr": "cpapr",
         "batched": "batched", "ingest": "ingest",
         "shapeclass": "shapeclass"}

__all__ = [
    "AltoEncoding", "make_encoding", "AltoMeta", "AltoTensor",
    "OrientedView", "build", "build_device", "oriented_view",
    "oriented_view_device", "to_sparse", "Traversal", *_LAZY,
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return module if name == _LAZY[name] else getattr(module, name)
