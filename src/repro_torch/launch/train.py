"""Training launcher (LM workloads and the CPD workload).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --reduced --steps 3 --device cpu [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --steps 6 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --workload cpd \
      --dims 64,64,48 --rank 8 --iters 10

The default device is ``cuda``; without CUDA the launcher raises unless
``--device cpu`` is given. Weights are drawn from a ``torch.Generator``
seeded with ``--seed`` (bf16 unless the configuration says float32); JAX's
PRNG cannot be reproduced, so they differ from the JAX launcher's.

Fault tolerance: step-addressable checkpoints every ``--ckpt-every``
steps (async) and at the end, automatic resume from the newest checkpoint
in ``--ckpt-dir``, the data cursor restored with ``skip_to``. A
checkpoint holds ``(params, opt_state)`` in the JAX trainer's tree
(`interop.lm_train_tree`), so either launcher resumes the other's. A
checkpoint named ``step_N`` holds the state after N updates and the data
cursor N, and a run resumes at its data cursor: the JAX launcher names
its periodic checkpoints one update early and resumes at the name, so it
repeats one update from its own periodic checkpoints, never from this
one's. Under ``int8_ef`` the error state is a third element of the tree.

``--mesh pod|multipod`` trains on the production mesh (16x16 or
2x16x16, `launch.mesh`) over the world the launcher was started in (one
rank per device, ``torchrun``; a world of another size raises): every
rank draws the whole model from the seed and keeps its shards of the
parameters (`models.common.shardings`), the optimizer state (its
`state_defs`' shardings) and each batch (`launch.specs.batch_shardings`),
and the step runs under `models.sharding.use_mesh`, as the JAX launcher
does. Checkpoints are not written under a mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
import time

import torch

from repro_torch import interop
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore)
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as shd
from repro_torch.models.common import named_defs, shardings
from repro_torch.optim import compress, get_optimizer, warmup_cosine
from repro_torch.train.steps import make_train_step

MESH_HELP = ("host: this device alone; pod (16x16, 256 ranks) or multipod "
             "(2x16x16, 512 ranks): the production mesh over the world the "
             "launcher was started in (torchrun, one rank per device)")


@dataclasses.dataclass
class TrainRun:
    model: M.Model
    optimizer: torch.optim.Optimizer
    history: list          # per step run: {"step", "loss", "ce", "aux",
                           # "grad_norm"} as floats
    step_s: list           # per step run: seconds, the device synchronized
    compress_state: list | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lm_config(args):
    """The run's configuration: ``--reduced`` (``--reduced-repeats``) or
    the published one, ``--repeats`` repeats of its block pattern at full
    width when given, and ``--grad-accum`` when given."""
    cfg = (reduced_config(args.arch, n_repeats=args.reduced_repeats)
           if args.reduced else get_config(args.arch))
    if args.repeats:
        cfg = dataclasses.replace(
            cfg, n_layers=len(cfg.block_pattern) * args.repeats)
    if args.grad_accum:
        cfg = dataclasses.replace(cfg, grad_accum=args.grad_accum)
    return cfg


def _trainable(cfg, model, args):
    model.requires_grad_(True)
    opt = get_optimizer(cfg.optimizer, M.jax_leaves(model),
                        lr=warmup_cosine(args.lr, warmup=args.warmup,
                                         total=args.steps))
    return model, opt


def production_mesh(args, dev: torch.device):
    """The ``--mesh`` production mesh over the launched world: joins the
    default process group from ``torchrun``'s environment unless one is
    up (NCCL on the card, gloo on the CPU); raises on a world of another
    size."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(f"--mesh {args.mesh} needs a launched world "
                             "(torchrun --nproc-per-node ...): no process "
                             "group and no WORLD_SIZE")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=args.mesh == "multipod",
                                device_type=dev.type)


def shard_model(model: M.Model, mesh) -> M.Model:
    """The model's parameters as DTensors under `shardings` (each rank
    keeps its shards of the values it holds)."""
    sh = shardings(named_defs(model), mesh)
    model.load_state_dict({k: sh[k].distribute(v.detach())
                           for k, v in model.state_dict().items()},
                          assign=True)
    return model


def shard_optimizer(opt, cfg, mesh) -> None:
    """The optimizer's state as zero DTensors under its `state_defs`'
    shardings (the state of a fresh optimizer is zeros)."""
    for group, shs in zip(opt.param_groups,
                          specs.opt_state_shardings(opt, cfg, mesh)):
        for key, s in shs.items():
            t = group[key]
            group[key] = s.from_local(
                torch.zeros(s.shard_shape(tuple(t.shape)), dtype=t.dtype,
                            device=t.device), tuple(t.shape))


def train_lm(args) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = lm_config(args)
    mesh = None if args.mesh == "host" else production_mesh(args, dev)
    if mesh is not None and args.ckpt_dir:
        raise ValueError("--ckpt-dir: checkpoints are not written under "
                         f"--mesh {args.mesh}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_model(cfg, gen, device=dev)
    if mesh is not None:
        model = shard_model(model, mesh)
    model, opt = _trainable(cfg, model, args)
    if mesh is not None:
        shard_optimizer(opt, cfg, mesh)
    int8 = args.compression == "int8_ef"
    err = compress.init_error_feedback(M.jax_leaves(model)) if int8 else None
    step_fn = make_train_step(cfg, compression=args.compression or None)

    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                         device=dev)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            like = interop.lm_train_tree(model, opt) + (
                (err,) if int8 else ())
            tree, manifest = restore(args.ckpt_dir, last, like,
                                     device="cpu")
            del like
            model, opt = _trainable(cfg, interop.lm_params(
                cfg, tree[0], device=dev), args)
            interop.lm_opt_state(opt, tree[1])
            if int8:
                err = [e.to(dev) for e in tree[2]]
            start = manifest["data_step"]
            pipe.skip_to(start)
            print(f"resumed from step {start}")

    def state():
        return interop.lm_train_tree(model, opt) + ((err,) if int8 else ())

    def sharded(batch):
        if mesh is None:
            return batch
        sh = specs.batch_shardings(cfg, mesh, batch)
        return {k: sh[k].distribute(v) for k, v in batch.items()}

    def on_mesh():
        if mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        stack = contextlib.ExitStack()
        stack.enter_context(shd.use_mesh(mesh))
        stack.enter_context(implicit_replication())
        return stack

    history, step_s = [], []
    t0 = time.time()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = sharded(next(pipe))
        with on_mesh():
            metrics = step_fn(model, opt, batch, err) if int8 else \
                step_fn(model, opt, batch)
        if int8:
            metrics, err = metrics
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        step_s.append(time.perf_counter() - t_step)
        history.append({"step": step, **metrics})
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"ce {metrics['ce']:.4f} "
                  f"({dt / max(1, step - start + 1):.3f}s/step)",
                  flush=True)
        done = step + 1
        if ckpt and done < args.steps and done % args.ckpt_every == 0:
            ckpt.save(done, state(), data_step=pipe.state.step)
    if ckpt:
        ckpt.save(args.steps, state(), data_step=pipe.state.step)
        ckpt.wait()
    return TrainRun(model, opt, history, step_s, err)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_cpd(args):
    """The paper's own workload: CP decomposition over the world process
    group (`dist.cpd.distributed_cp_als`); without one, a one-rank group
    (NCCL on the card, gloo on the CPU) made here and torn down after.
    Returns ``(lam, factors, fits)``."""
    import torch.distributed as dist

    from repro_torch.dist.cpd import distributed_cp_als
    from repro_torch.sparse import synthetic
    dev = resolve_device(args.device)
    dims = tuple(int(d) for d in args.dims.split(","))
    x = synthetic.zipf_tensor(dims, args.nnz, seed=args.seed)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0)
    try:
        lam, factors, fits = distributed_cp_als(
            x, rank=args.rank, n_iters=args.iters, seed=args.seed,
            device=dev)
    finally:
        if own:
            dist.destroy_process_group()
    for i, f in enumerate(fits):
        print(f"iter {i}: fit {f:.4f}")
    return lam, factors, fits


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm", choices=["lm", "cpd"])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reduced-repeats", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=0,
                    help="cut the depth to this many repeats of the block "
                         "pattern (0: the configuration's own)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"], help=MESH_HELP)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--compression", default="",
                    choices=["", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    # cpd workload
    ap.add_argument("--dims", default="64,64,48")
    ap.add_argument("--nnz", type=int, default=20000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.workload == "cpd":
        train_cpd(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
