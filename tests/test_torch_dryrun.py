"""The port's dry run and roofline (`repro_torch.launch.dryrun`,
`launch.roofline`) against the JAX package's: `model_flops` and the
sLSTM correction exactly for every architecture × shape; a reduced
training cell's per-device argument bytes on fake 256- and 512-rank
worlds against the JAX cell's shard shapes (a 512-device JAX process, no
compile); and the census's FLOP count of DTensor matmuls by hand. Each
fake world is a process of its own (one default group a process)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.launch import roofline as JRL
from repro.models import model as JM
from repro_torch.configs import ALL_SHAPES, ARCHS, get_config
from repro_torch.launch import roofline as RL
from repro_torch.models import model as M


def _env():
    return dict(os.environ, PYTHONPATH=os.environ.get("PYTHONPATH", "src"),
                JAX_PLATFORMS="cpu")


def _run(code: str, *argv) -> dict:
    r = subprocess.run([sys.executable, "-c", code, *argv],
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert r.returncode == 0 and lines, r.stdout + r.stderr
    return json.loads(lines[-1][len("RESULT"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_slstm_correction_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    n_active = M.count_active_params(cfg)
    assert n_active == JM.count_active_params(jcfg)
    n_slstm = sum(1 for b in cfg.layer_types() if b == "slstm")
    for shape in ALL_SHAPES:
        js = jax_shape(shape.name)
        assert RL.model_flops(cfg, shape, n_active) == JRL.model_flops(
            jcfg, js, n_active)
        assert RL.slstm_flops_correction(cfg, shape, n_slstm) == \
            JRL.slstm_flops_correction(jcfg, js, n_slstm)


def test_granite_model_flops_by_hand():
    """granite-moe-3b-a800m: 883,066,368 active parameters; a training
    step of 4 × 1,024 tokens is 6 · N · 4,096 FLOPs."""
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config("granite-moe-3b-a800m")
    n = M.count_active_params(cfg)
    assert n == 883_066_368
    step = ShapeConfig("train_pr25", 1024, 4, "train")
    assert RL.model_flops(cfg, step, n) == 6.0 * n * 4096


def test_terms_split_collectives_by_node():
    pod = RL.Collective("all-gather", 100, tuple(range(16)))     # 2 nodes
    node = RL.Collective("all-reduce", 50, tuple(range(8)))      # 1 node
    st = RL.collective_stats([pod, node])
    assert st["inter_node_bytes"] == 100 and st["intra_node_bytes"] == 50
    assert st["counts"]["all-gather"] == 1 and st["total_bytes"] == 150
    t = RL.derive_terms(2e12, 1e9, 150, 4e12, 2, bytes_coll_inter=100)
    assert t.t_compute == 2e12 / RL.PEAK_FLOPS
    assert t.t_collective == 50 / RL.NVLINK_BW + 100 / RL.IB_BW
    assert t.useful_ratio == 1.0 and t.bottleneck == "compute"


# the reduced cell: granite (MoE, AdamW) at the reduced widths, float32,
# a training step of 32 × 64 tokens
_CELL = ("granite-moe-3b-a800m", 32, 64)

_PORT_CELL = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = reduced_config(arch)
shape = ShapeConfig("train_small", S, B, "train")
out = {}
for mp in (False, True):
    D.fake_world(512 if mp else 256)
    mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
    out[str(mp)] = D.build_cell(cfg, shape, mesh).argument_bytes
    if not mp:
        ext = D.calibrate_costs(cfg, shape, mesh)
        out["terms"] = {k: ext[k] for k in ("flops", "bytes", "coll")}
    dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""

_JAX_CELL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import numpy as np
import jax
from repro.configs import reduced_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.models.common import shardings
from repro.optim import get_optimizer
arch, B, L = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = reduced_config(arch)
out = {}

def elems(defs_or_specs, shd):
    leaves = jax.tree.leaves(defs_or_specs,
                             is_leaf=lambda x: hasattr(x, "shape"))
    shs = jax.tree.leaves(shd, is_leaf=lambda x: hasattr(x, "spec"))
    return [int(np.prod(s.shard_shape(tuple(d.shape))))
            for d, s in zip(leaves, shs)]

for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    defs = M.model_def(cfg)
    opt = get_optimizer(cfg.optimizer)
    sdefs = opt.state_defs(defs)
    sdefs = {k: v for k, v in sdefs.items() if k != "count"}
    bspec = S.train_batch_specs(cfg, B, L)
    out[str(mp)] = {"params": sum(elems(defs, shardings(defs, mesh))),
                    "opt_state": sum(elems(sdefs, shardings(sdefs, mesh))),
                    "batch": sum(elems(bspec,
                                       S.batch_shardings(cfg, mesh, bspec)))}
print("RESULT" + json.dumps(out))
"""


def test_reduced_cell_argument_bytes_match_jax_shard_shapes():
    port = _run(_PORT_CELL, *map(str, _CELL))
    jax_ = _run(_JAX_CELL, *map(str, _CELL))
    for mp in ("False", "True"):
        p, j = port[mp], jax_[mp]
        # the reduced configs are float32, AdamW's moments float32 (the
        # JAX step's count is a tensor, the port's a Python int), the
        # tokens and labels int32
        assert p["params"] == 4 * j["params"]
        assert p["opt_state"] == 4 * j["opt_state"]
        assert p["batch"] == 4 * j["batch"]
    terms = port["terms"]
    assert all(np.isfinite(v) and v > 0 for v in terms.values())


_MATMUL = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun as D
from repro_torch.models import sharding as shd
D.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
def dt(shape, placements, local):
    t = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                           placements, run_check=False)
    assert tuple(t.shape) == shape
    return t
# (64, 128) rows over data, (128, 32) columns over model: local
# (32, 128) @ (128, 16), no collective
a = dt((64, 128), [Shard(0), Replicate()], (32, 128))
b = dt((128, 32), [Replicate(), Shard(1)], (128, 16))
census = D.StepCensus()
with census:
    c = a @ b
with FlopCounterMode(display=False) as fc:
    a @ b
# the contraction sharded on both over model: local (64, 64) @ (64, 32),
# a partial sum
x = dt((64, 128), [Replicate(), Shard(1)], (64, 64))
y = dt((128, 32), [Replicate(), Shard(0)], (64, 32))
c2 = D.StepCensus()
with c2, shd.use_mesh(mesh):
    z = shd.einsum("ik,kj->ij", x, y)
print("RESULT" + json.dumps({
    "census": census.flops, "colls": len(census.collectives),
    "local": list(c.to_local().shape), "flop_counter": fc.get_total_flops(),
    "einsum": c2.flops, "partial": z.placements[1].is_partial(),
    "einsum_colls": len(c2.collectives)}))
"""


def test_census_counts_local_matmul_flops():
    out = _run(_MATMUL)
    assert out["local"] == [32, 16]
    assert out["census"] == 2 * 32 * 128 * 16 and out["colls"] == 0
    # FlopCounterMode over DTensors counts the global op
    assert out["flop_counter"] >= 2 * 64 * 128 * 32
    assert out["einsum"] == 2 * 64 * 64 * 32
    assert out["partial"] and out["einsum_colls"] == 0
