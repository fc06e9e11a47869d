"""The port's sharding rules (`repro_torch.models.sharding`, the mesh
helpers of `models.common`) against the JAX package's: `spec_for` entry
for entry for every parameter and optimizer-state def of the ten
architectures on both production meshes and a (2, 2) host mesh, and
`bytes_per_device` against the JAX package's on its 512 host devices.
JAX's `spec_for` reads only ``mesh.shape``, so a stub mesh serves both."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import sharding as jshd
from repro.optim import get_optimizer as jax_optimizer
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.models import sharding as shd
from repro_torch.models.common import (ParamDef, bytes_per_device, def_paths,
                                       named_defs, shardings_inference)
from repro_torch.optim import AdamW, Adafactor


class StubMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.mesh_dim_names = tuple(shape)


MESHES = {"pod": StubMesh(data=16, model=16),
          "multipod": StubMesh(pod=2, data=16, model=16),
          "host": StubMesh(data=2, model=2)}


def _jax_paths(tree, prefix=""):
    from repro.models.common import ParamDef as JDef
    if isinstance(tree, JDef):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_jax_paths(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_jax(arch, mesh):
    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jdefs = JM.model_def(jcfg)
    port = def_paths(M.model_def(cfg))
    ref = _jax_paths(jdefs)
    assert set(port) == set(ref)
    trees = {"params": (port, ref)}
    popt = (AdamW if cfg.optimizer == "adamw" else Adafactor).state_defs(
        M.model_def(cfg))
    jopt = jax_optimizer(jcfg.optimizer).state_defs(jdefs)
    trees["opt"] = (def_paths(popt), _jax_paths(jopt))
    for port_paths, ref_paths in trees.values():
        assert set(port_paths) == set(ref_paths)
        for path, d in port_paths.items():
            j = ref_paths[path]
            assert d.shape == tuple(j.shape) and d.logical == j.logical
            want = tuple(jshd.spec_for(m, j.logical, j.shape))
            assert shd.spec_for(m, d.logical, d.shape) == want, path
            assert shd.spec_for(m, d.logical) == tuple(
                jshd.spec_for(m, j.logical)), path
    # the port's per-layer parameters shard as their stacked JAX leaf
    # without its leading "layers" axis
    model = M.Model(cfg)
    by_leaf = {leaf.name: leaf for leaf in M.jax_leaves(model)}
    for name, d in named_defs(model).items():
        p = model.get_parameter(name)
        leaf = next(n for n, lf in by_leaf.items()
                    if any(q is p for q in lf.params))
        j = ref[leaf]
        want = tuple(jshd.spec_for(m, j.logical, j.shape))
        if by_leaf[leaf].stacked:
            assert want[0] is None
            want = want[1:]
        assert shd.spec_for(m, d.logical, d.shape) == want, name


_JAX_BYTES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
from repro.configs import ARCHS, get_config
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.models.common import bytes_per_device
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCHS:
        defs = M.model_def(get_config(arch))
        out[f"{arch}/{mp}"] = [bytes_per_device(defs, mesh, keep_fsdp=k)
                               for k in (False, True)]
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_bytes():
    env = dict(os.environ, PYTHONPATH=os.environ.get("PYTHONPATH", "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_BYTES],
                       capture_output=True, text=True, env=env, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert r.returncode == 0 and lines, r.stdout + r.stderr
    return json.loads(lines[-1][len("RESULT"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_per_device_matches_jax(arch, jax_bytes):
    defs = M.model_def(get_config(arch))
    for mp, mesh in ((False, MESHES["pod"]), (True, MESHES["multipod"])):
        got = [bytes_per_device(defs, mesh, keep_fsdp=k)
               for k in (False, True)]
        assert got == jax_bytes[f"{arch}/{mp}"]


def test_act_without_a_mesh_returns_its_argument():
    x = torch.randn(2, 3, 4)
    assert shd.current_mesh() is None
    assert shd.act(x, ("batch", None, "mlp")) is x
    with shd.use_mesh(None):
        assert shd.act(x, ("batch", None, None)) is x
    f = shd.local_map(torch.sin, (("batch",),), (("batch",),))
    assert torch.equal(f(x), torch.sin(x))


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["multipod"]
    spec = shd.spec_for(m, ("batch", None, "mlp"), (64, 3, 32))
    assert spec == (("pod", "data"), None, "model")
    assert shd.placements_for(m, spec, 3) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements_for(m, (None, "model"), 2) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements_for(m, (("data", "pod"),), 1)
    s = shd.Sharding(m, spec)
    assert s.shard_shape((64, 3, 32)) == (2, 3, 2)


def test_abstract_gives_meta_tensors():
    from repro_torch.models.common import abstract
    t = abstract({"a": {"w": ParamDef((3, 4), (None, "mlp"))}},
                 torch.bfloat16)
    w = t["a"]["w"]
    assert w.device.type == "meta" and w.shape == (3, 4)
    assert w.dtype == torch.bfloat16


def test_inference_shardings_drop_fsdp():
    d = {"w": ParamDef((64, 32), ("fsdp", "mlp"))}
    s = shardings_inference(d, MESHES["pod"])
    assert s["w"].spec == (None, "model")
    s = shardings_inference(d, MESHES["pod"], keep_fsdp=True)
    assert s["w"].spec == ("data", "model")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-7b",
                                  "xlstm-1.3b", "whisper-base"])
def test_cache_shardings_match_jax_per_layer(arch):
    """The per-layer cache shardings are the JAX stacked cache's without
    the leading repeat axis."""
    import jax.numpy as jnp
    from repro.launch import specs as jspecs
    cfg, jcfg = get_config(arch), jax_config(arch)
    for mesh in (MESHES["pod"], MESHES["multipod"]):
        for B in (128, 1):
            jcache = JM.abstract_cache(jcfg, B, 64, jnp.bfloat16)
            jsh = _jax_cache_specs(jspecs, jcfg, mesh, jcache, B)
            cache = M.init_cache(cfg, B, 64, device="meta")
            sh = specs.cache_shardings(cfg, mesh, cache, B)
            plen = len(cfg.block_pattern)
            for i, layer in enumerate(sh):
                for key, nt in layer.items():
                    for field in nt._fields:
                        want = jsh[(i % plen, key, field)]
                        assert getattr(nt, field).spec == want[1:], (
                            i, key, field)
                        assert want[0] is None


def _jax_cache_specs(jspecs, jcfg, mesh, jcache, B):
    """The JAX `cache_shardings` rules' specs, keyed by (pattern position,
    cache key, field), read off with a NamedSharding stand-in."""
    import jax

    class _NS:
        def __init__(self, mesh, spec):
            self.spec = tuple(spec)

    orig = jspecs.NamedSharding
    jspecs.NamedSharding = _NS
    try:
        tree = jspecs.cache_shardings(jcfg, mesh, jcache, B)
    finally:
        jspecs.NamedSharding = orig
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, _NS))[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        out[tuple(keys)] = leaf.spec
    return out


_ORDER = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.models import sharding as shd
rank = int(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
s = shd.sharding_for(mesh, ("batch", "mlp"), (8, 4))
local = s.distribute(torch.arange(32).reshape(8, 4)).to_local()
print("RESULT" + json.dumps(local.tolist()))
"""


@pytest.mark.parametrize("rank", [3, 5])
def test_tuple_entry_shards_pod_major(rank):
    """("pod", "data") splits rows pod-major, as JAX's PartitionSpec
    does: the rank at mesh coordinate (pod p, data d, model m) holds row
    block 2p + d and column block m."""
    env = dict(os.environ, PYTHONPATH=os.environ.get("PYTHONPATH", "src"))
    r = subprocess.run([sys.executable, "-c", _ORDER, str(rank)],
                       capture_output=True, text=True, env=env, timeout=120)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert r.returncode == 0 and lines, r.stdout + r.stderr
    p, d, m = rank // 4, rank // 2 % 2, rank % 2
    rows = range(2 * (2 * p + d), 2 * (2 * p + d) + 2)
    want = [[4 * i + j for j in range(2 * m, 2 * m + 2)] for i in rows]
    assert json.loads(lines[-1][len("RESULT"):]) == want
