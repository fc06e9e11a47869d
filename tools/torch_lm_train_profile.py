#!/usr/bin/env python3
"""Where a training step's time goes: granite-moe-3b-a800m under
`torch.profiler`.

    python3 tools/torch_lm_train_profile.py [--steps 3] [--arch ...]

Trains the full published configuration (bf16, seeded weights, AdamW,
remat) as `chip_smoke.py`'s `phase_train` does: batch 4 × 1,024 tokens
from `make_batch`, the launcher's schedule (`warmup_cosine(3e-4, 20,
...)`). After two warm-up steps, one step is split with a synchronize
between its parts (forward and backward, compression and clipping, the
optimizer update: host clock), then ``--steps`` steps run under the
profiler. Prints one JSON object: the wall ms a step (profiler off and
on), the split, the device's busy ms a step (the sum of CUDA kernel and
copy times; the optimizer's annotated range is not a kernel) and its
idle share, kernel launches a step, how often the host found the launch
queue full (CUPTI's "Command Buffer Full": the host is ahead of the
device), the ten ops with the most host time and the ten kernels with
the most device time. Needs one CUDA card; ``--device cpu`` runs the
same steps on the CPU (no device time).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import get_optimizer, warmup_cosine  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
QUEUE_FULL = "Command Buffer Full"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(arch: str, device, steps: int, batch: int = 4,
            seq: int = 1024) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev).requires_grad_(True)
    opt = get_optimizer(cfg.optimizer, M.jax_leaves(model),
                        lr=warmup_cosine(3e-4, 20, steps + 3))
    step = S.make_train_step(cfg)
    loss_fn = S.make_loss_fn(cfg)
    data = iter(range(10_000))

    def next_batch():
        return make_batch(cfg, batch, seq, 0, next(data), device=dev)

    for _ in range(2):
        step(model, opt, next_batch())
    # one step split into its parts, a synchronize between them
    b = next_batch()
    _sync(dev)
    t0 = time.perf_counter()
    params = [p for g in opt.param_groups for p in g["params"]]
    loss, _ = loss_fn(model, b)
    flat = iter(torch.autograd.grad(loss, params))
    grads = [[next(flat) for _ in g["params"]] for g in opt.param_groups]
    _sync(dev)
    t1 = time.perf_counter()
    grads, _ = S.clip_by_global_norm(grads, 1.0)
    _sync(dev)
    t2 = time.perf_counter()
    opt.step(grads=grads)
    _sync(dev)
    t3 = time.perf_counter()
    del grads, flat, loss
    split = {"forward_backward_ms": (t1 - t0) * 1e3,
             "clip_ms": (t2 - t1) * 1e3, "update_ms": (t3 - t2) * 1e3}
    b = next_batch()
    _sync(dev)
    t0 = time.perf_counter()
    step(model, opt, b)
    _sync(dev)
    wall_off = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    batches = [next_batch() for _ in range(steps)]
    with torch.profiler.profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        for b in batches:
            step(model, opt, b)
        _sync(dev)
        wall_on = (time.perf_counter() - t0) * 1e3 / steps
    ev = prof.key_averages()
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key != QUEUE_FULL]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in ev if e.key in LAUNCH_KEYS)
    queue_full = sum(e.count for e in ev if e.key == QUEUE_FULL)
    busy = dev_us / 1e3 / steps

    def top(key, events):
        rows = sorted(events, key=lambda e: getattr(e, key),
                      reverse=True)[:10]
        return [{"op": e.key, "count_per_step": e.count / steps,
                 "ms_per_step": getattr(e, key) / 1e3 / steps}
                for e in rows]
    return {"arch": arch, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
            "batch": batch, "seq": seq, "remat": cfg.remat,
            "optimizer": cfg.optimizer,
            "wall_ms_per_step_profiler_off": wall_off,
            "wall_ms_per_step_profiler_on": wall_on, "split": split,
            "device_busy_ms_per_step": busy,
            "device_idle_share": (1 - busy / wall_on) if dev_us else None,
            "kernel_launches_per_step": launches / steps,
            "launch_queue_full_per_step": queue_full / steps,
            "top_host": top("self_cpu_time_total", ev),
            "top_device": top("self_device_time_total", kernels)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.arch, args.device, args.steps, args.batch,
                             args.seq), indent=1))


if __name__ == "__main__":
    main()
