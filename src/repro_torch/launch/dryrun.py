"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k [--multi-pod] [--no-calibrate] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each cell runs in a process of its own (one default process group a
process) over a fake process group of 256 or 512 ranks (``FakeStore``,
backend ``"fake"``: collectives return at once, nothing crosses a wire)
and the production mesh on it, as rank 0. Parameters, optimizer state and
the batch (or the decode cache) are DTensors whose local shards are
``meta`` tensors: shapes and dtypes, never allocated, so a 1T-parameter
model traces on a laptop. The step runs eagerly under `use_mesh` and
DTensor's implicit replication of plain tensors, and `StepCensus` counts
what this device runs:

  * per-device argument bytes: the local shards of parameters, optimizer
    state and batch, in the dtypes the port allocates;
  * per-device FLOPs: ``torch.utils.flop_counter``'s formulas on the
    local ops (matmul-class ops only; XLA's cost analysis counts
    elementwise ops too);
  * per-device bytes: inputs read and outputs written by every local op
    that is not a view (unfused, an upper bound);
  * collectives: the ``_c10d_functional`` ops the redistributions issue,
    with operand bytes and whether their group crosses a node;
  * tracked peak bytes: the arguments plus the local tensors alive at
    once during the trace (recorded, not gated).

FLOPs, bytes and collectives are calibrated as the JAX package's dry run
does: traced at 1 and 2 repeats of the block pattern (``grad_accum`` 1 at
the full global batch) and extrapolated, ``total = c1 + (R-1)·(c2-c1)``;
the argument bytes are the full depth's. The tracked peak is the 2-repeat
trace's. The roofline terms use `launch/roofline.py`'s H100 constants:
model figures, not measurements. Results land in
``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``; a cell that
cannot trace records the op that stopped it under ``error``.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ALL_SHAPES, ARCHS, get_config, get_shape,
                                 shapes_for)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as shd
from repro_torch.models.common import (bytes_per_device, named_defs,
                                       shardings, shardings_inference)
from repro_torch.optim import get_optimizer
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the H100's 80 GB: inference keeps FSDP only where TP/EP sharding alone
# leaves more parameter bytes a device than this (the JAX package's rule
# budgets a v5e's 12 GiB)
PARAM_BUDGET = 80e9

# ops that move no data: views, and allocations that write nothing
_NO_TRAFFIC = {"view", "_unsafe_view", "reshape", "expand", "select",
               "slice", "t", "transpose", "permute", "as_strided", "detach",
               "alias", "unsqueeze", "squeeze", "split", "split_with_sizes",
               "unbind", "chunk", "narrow", "diagonal", "unfold", "view_as",
               "lift_fresh", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided"}

_KINDS = {"all_reduce": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCensus(TorchDispatchMode):
    """Counts the local ops of a DTensor program: an op on DTensors is
    handed back (``NotImplemented``), so DTensor runs it and the local ops
    it issues come through here with plain tensors. Fake tensors (DTensor's
    own shape propagation) are not counted."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[RL.Collective] = []
        self.live = base_bytes
        self.peak = base_bytes
        self._tracked: dict[int, weakref.finalize] = {}

    def _release(self, key: int, n: int):
        self.live -= n
        self._tracked.pop(key, None)

    def _track(self, out):
        for t in _tensors(out):
            if t._base is not None or id(t) in self._tracked:
                continue
            n = _nbytes(t)
            self._tracked[id(t)] = weakref.finalize(t, self._release, id(t), n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            if name in _KINDS:
                self._collective(_KINDS[name], args)
            return out
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs,
                                                 out_val=out)
        if name.rstrip("_") not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
        return out

    def _collective(self, kind: str, args):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1])
        ranks = tuple(dist.get_process_group_ranks(group))
        self.collectives.append(RL.Collective(kind, _nbytes(args[0]), ranks))


def _params_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _local(sharding: shd.Sharding, shape, dtype):
    """A DTensor of ``shape`` whose local shard is a ``meta`` tensor."""
    return sharding.from_local(
        torch.empty(sharding.shard_shape(shape), dtype=dtype, device="meta"),
        shape)


def _local_bytes(tree, shardings_tree) -> int:
    """Bytes of the local shards of a tree of meta tensors."""
    total = 0
    for t, s in zip(_tensors(tree), _tensors_sh(shardings_tree)):
        n = 1
        for d in s.shard_shape(tuple(t.shape)):
            n *= d
        total += n * t.element_size()
    return total


def _tensors_sh(tree):
    if isinstance(tree, shd.Sharding):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors_sh(v)
    else:
        for v in tree:
            yield from _tensors_sh(v)


def _distribute(tree, shardings_tree):
    """A tree of meta tensors as DTensors under a tree of `Sharding`s."""
    if isinstance(tree, torch.Tensor):
        return _local(shardings_tree, tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings_tree[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(getattr(tree, k),
                                        getattr(shardings_tree, k))
                            for k in tree._fields))
    return [_distribute(v, s) for v, s in zip(tree, shardings_tree)]


@dataclasses.dataclass
class Cell:
    """A cell's step over DTensors, and the bytes of its arguments."""
    run: callable
    argument_bytes: dict


def param_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The parameters' shardings by `state_dict` name: `shardings` for
    training; for inference TP/EP only, unless the parameters then exceed
    `PARAM_BUDGET` a device (FSDP kept)."""
    model = M.Model(cfg)
    defs = named_defs(model)
    if shape.kind == "train":
        return model, defs, shardings(defs, mesh), True
    keep = bytes_per_device(M.model_def(cfg), mesh,
                            dtype_bytes=_params_dtype(cfg).itemsize,
                            keep_fsdp=False) > PARAM_BUDGET
    return model, defs, shardings_inference(defs, mesh, keep_fsdp=keep), keep


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Cell:
    """The cell's parameters, optimizer state and inputs as DTensors with
    meta shards, and the step to trace over them."""
    model, defs, p_shd, keep_fsdp = param_shardings(cfg, shape, mesh)
    dtype = _params_dtype(cfg)
    model.load_state_dict({k: _local(p_shd[k], d.shape, dtype)
                           for k, d in defs.items()}, assign=True)
    param_bytes = sum(
        _nbytes(p.to_local()) for p in model.parameters())
    arg = {"params": param_bytes, "opt_state": 0, "batch": 0,
           "keep_fsdp": keep_fsdp}
    B = shape.global_batch

    if shape.kind == "train":
        model.requires_grad_(True)
        opt = get_optimizer(cfg.optimizer, M.jax_leaves(model), lr=1e-4)
        for group, shs in zip(opt.param_groups,
                              S.opt_state_shardings(opt, cfg, mesh)):
            for key, s in shs.items():
                t = group[key]
                group[key] = _local(s, tuple(t.shape), t.dtype)
                arg["opt_state"] += _nbytes(group[key].to_local())
        bspec = S.train_batch_specs(cfg, B, shape.seq_len)
        b_shd = S.batch_shardings(cfg, mesh, bspec)
        batch = {k: _local(b_shd[k], tuple(v.shape), v.dtype)
                 for k, v in bspec.items()}
        arg["batch"] = _local_bytes(bspec, b_shd)
        step = make_train_step(cfg)
        return Cell(lambda: step(model, opt, batch), arg)

    if shape.kind == "prefill":
        bspec = S.train_batch_specs(cfg, B, shape.seq_len)
        bspec.pop("labels")
        b_shd = S.batch_shardings(cfg, mesh, bspec)
        batch = {k: _local(b_shd[k], tuple(v.shape), v.dtype)
                 for k, v in bspec.items()}
        arg["batch"] = _local_bytes(bspec, b_shd)
        step = make_prefill_step(cfg, s_max=shape.seq_len)
        return Cell(lambda: step(model, batch), arg)

    # decode: one new token against a seq_len cache
    tokens, cache_abs, extras = S.decode_input_specs(cfg, shape)
    c_shd = S.cache_shardings(cfg, mesh, cache_abs, B)
    t_shd = S.batch_shardings(cfg, mesh, {"tokens": tokens})["tokens"]
    cache = _distribute(cache_abs, c_shd)
    tok = _local(t_shd, tuple(tokens.shape), tokens.dtype)
    arg["batch"] = _local_bytes({"tokens": tokens}, {"tokens": t_shd}) \
        + _local_bytes(cache_abs, c_shd)
    pos3 = None
    if cfg.family == "vlm":
        p3 = extras["positions3"]
        pos3 = _local(shd.Sharding(mesh, (None,) * 3), tuple(p3.shape),
                      p3.dtype)
        arg["batch"] += _nbytes(pos3.to_local())
    step = make_decode_step(cfg)
    index = shape.seq_len - 1
    return Cell(lambda: step(model, tok, cache, index, positions3=pos3), arg)


def trace(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """One step of the cell traced under `StepCensus`."""
    from torch.distributed.tensor.experimental import implicit_replication
    cell = build_cell(cfg, shape, mesh)
    a = cell.argument_bytes
    census = StepCensus(a["params"] + a["opt_state"] + a["batch"])
    t0 = time.time()
    with shd.use_mesh(mesh), implicit_replication(), census:
        cell.run()
    cs = RL.collective_stats(census.collectives)
    return {"argument_bytes": a, "flops": float(census.flops),
            "bytes": float(census.bytes),
            "coll": float(cs["total_bytes"]),
            "coll_inter": float(cs["inter_node_bytes"]),
            "coll_counts": cs["counts"], "coll_bytes": cs["bytes"],
            "tracked_peak_bytes": census.peak,
            "trace_s": time.time() - t0}


def _calibration_cfg(cfg: ModelConfig, repeats: int) -> ModelConfig:
    plen = len(cfg.block_pattern)
    over = dict(n_layers=plen * repeats, grad_accum=1)
    if cfg.is_encdec:
        over["encoder_layers"] = repeats
    return dataclasses.replace(cfg, **over)


def calibrate_costs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Extrapolate per-device FLOPs/bytes/collective bytes to full depth:
    total = c1 + (R-1)·(c2-c1), traced at 1 and 2 repeats."""
    out = {r: trace(_calibration_cfg(cfg, r), shape, mesh) for r in (1, 2)}
    R = cfg.n_repeats
    extr = {}
    for key in ("flops", "bytes", "coll", "coll_inter"):
        c1, c2 = out[1][key], out[2][key]
        extr[key] = c1 + (R - 1) * (c2 - c1)
    extr["per_repeat"] = {k: out[2][k] - out[1][k]
                          for k in ("flops", "bytes", "coll", "coll_inter")}
    extr["calib_counts"] = out[2]["coll_counts"]
    extr["calib_coll_bytes"] = out[2]["coll_bytes"]
    extr["tracked_peak_bytes_2_repeats"] = out[2]["tracked_peak_bytes"]
    extr["trace_s"] = out[1]["trace_s"] + out[2]["trace_s"]
    return extr


def _mesh_chips(mesh) -> int:
    n = 1
    for v in shd.mesh_shape(mesh).values():
        n *= v
    return n


def _parse_overrides(pairs: list[str] | None) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives return at once; nothing is sent)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             calibrate: bool = True, out_dir: str = OUT_DIR,
             overrides: dict | None = None, tag: str = "") -> dict:
    """One cell, in a process of its own: makes the fake world of 256 or
    512 ranks unless one is already up, traces, writes the JSON."""
    import torch.distributed as dist
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    if not dist.is_initialized():
        fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = _mesh_chips(mesh)
    mesh_name = ("multipod" if multi_pod else "pod") + (f"_{tag}" if tag
                                                        else "")
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": describe(mesh),
                 "chips": n_chips, "status": "ok",
                 "overrides": overrides or {},
                 "constants": {"peak_flops": RL.PEAK_FLOPS,
                               "hbm_bw": RL.HBM_BW,
                               "nvlink_bw": RL.NVLINK_BW,
                               "ib_bw": RL.IB_BW}}

    if shape_name not in [s.name for s in shapes_for(cfg)]:
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention arch skips long_500k"
                         if shape_name == "long_500k" else "n/a")
        _write(rec, arch, shape_name, mesh_name, out_dir)
        return rec

    t0 = time.time()
    try:
        full = build_cell(cfg, shape, mesh).argument_bytes
        rec["memory"] = {"argument_bytes": full["params"] + full["opt_state"]
                         + full["batch"], **full}
        if calibrate:
            extr = calibrate_costs(cfg, shape, mesh)
            rec["memory"]["tracked_peak_bytes_2_repeats"] = \
                extr["tracked_peak_bytes_2_repeats"]
            rec["cost_calibrated"] = {k: extr[k] for k in
                                      ("flops", "bytes", "coll",
                                       "coll_inter")}
            rec["per_repeat"] = extr["per_repeat"]
            rec["collectives_2_repeats"] = {
                "counts": extr["calib_counts"],
                "bytes": extr["calib_coll_bytes"]}
            n_active = M.count_active_params(cfg)
            mf = RL.model_flops(cfg, shape, n_active)
            terms = RL.derive_terms(extr["flops"], extr["bytes"],
                                    extr["coll"], mf, n_chips,
                                    bytes_coll_inter=extr["coll_inter"])
            rec["n_active_params"] = n_active
            rec["n_params"] = M.count_params(cfg)
            rec["roofline"] = terms.to_dict()
            rec["trace_s"] = round(extr["trace_s"], 2)
    except Exception as e:  # noqa: BLE001 - a cell records what stopped it
        rec["status"] = "error"
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "repro_torch" in f.filename]
        rec["error"] = {"type": type(e).__name__, "message": str(e)[:2000],
                        "at": [f"{os.path.relpath(f.filename)}:{f.lineno}"
                               for f in frames[-4:]]}
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(rec, arch, shape_name, mesh_name, out_dir)
    return rec


def _write(rec, arch, shape_name, mesh_name, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _cell_process(args) -> dict:
    torch.set_num_threads(1)
    return run_cell(*args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config overrides for perf experiments, e.g. "
                         "--override remat_policy=dots --override "
                         "grad_accum=4")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json filename")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    if args.all:
        cells = [(a, s.name) for a in ARCHS for s in ALL_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape required without --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(a, s, mp, not args.no_calibrate, args.out, overrides, args.tag)
            for a, s in cells for mp in meshes]

    failures = 0
    ctx = multiprocessing.get_context("spawn")
    # one process a cell (a process holds one default group), as many at
    # once as this process may use cores
    workers = min(len(jobs), len(os.sched_getaffinity(0)))
    with cf.ProcessPoolExecutor(max_workers=workers,
                                mp_context=ctx,
                                max_tasks_per_child=1) as pool:
        futs = {pool.submit(_cell_process, j): j for j in jobs}
        for fut in cf.as_completed(futs):
            a, s, mp = futs[fut][:3]
            name = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
            rec = fut.result()
            status = rec["status"]
            extra = ""
            if status == "ok":
                gb = rec["memory"]["argument_bytes"] / 1e9
                extra = f" wall={rec['wall_s']}s args/dev={gb:.2f}GB"
                if "roofline" in rec:
                    extra += f" bottleneck={rec['roofline']['bottleneck']}"
            elif status == "error":
                failures += 1
                extra = f" {rec['error']['type']} at {rec['error']['at']}"
            print(f"{name}: {status}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
