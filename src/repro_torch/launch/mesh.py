"""Production mesh builders over the current default process group.

`make_production_mesh` is a FUNCTION (not a module-level constant), so
importing this module never touches process-group state: a launcher
(``torchrun``) or the dry run (a fake group) sets the world up first and
only then asks for the mesh. Ranks are laid out row-major: with 8 GPUs a
node, the 16-wide ``model`` axis spans two nodes.
"""
from __future__ import annotations

import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks.
    The world must hold exactly that many ranks; ``device_type`` is the
    ranks' device (``"cuda"``, or ``"cpu"`` for a fake or gloo world)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multipod' if multi_pod else 'pod'} mesh {shape} needs a "
            f"world of {need} ranks; this process group has {world} "
            "(start one rank per device with torchrun)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device_type: str):
    """(world // model, model) ("data", "model") over the current world."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def describe(mesh) -> str:
    from repro_torch.models.sharding import mesh_shape
    return "x".join(f"{k}={v}" for k, v in mesh_shape(mesh).items())
