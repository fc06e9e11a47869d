#!/usr/bin/env python3
"""Where a served token's time goes: granite-moe-3b-a800m decode under
`torch.profiler`.

    python3 tools/torch_lm_serve_profile.py [--steps 8] [--arch ...]

Serves the full published configuration (bf16, seeded weights) as
`chip_smoke.py`'s `phase_lm` does: 4 requests, a 128-token prompt from
`make_batch`, then ``--steps`` greedy decode steps under the profiler
(after two unprofiled warm-up steps). Prints one JSON object: the wall ms
a token (host clock around synchronized steps, profiler off and on), the
device's busy ms a token (the sum of CUDA kernel times) and its idle
share, kernel launches a token, and the ten ops with the most host time
and the ten with the most device time. Needs one CUDA card; ``--device
cpu`` runs the same steps on the CPU (no device time there).
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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def profile(arch: str, device, steps: int, batch: int = 4,
            prompt: int = 128) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    b = make_batch(cfg, batch, prompt, 0, 0, device=dev)
    b.pop("labels")
    s_max = prompt + steps + 3
    logits, cache = M.prefill(cfg, model, b, s_max=s_max)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    index = prompt

    def step():
        nonlocal logits, cache, tok, index
        logits, cache = M.decode_step(cfg, model, tok, cache, index)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        index += 1

    for _ in range(2):
        step()
    _sync(dev)
    t0 = time.perf_counter()
    step()
    _sync(dev)
    wall_off = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            step()
        _sync(dev)
        wall_on = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    ev = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in ev
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    n = steps - 1
    busy = dev_us / 1e3 / n

    def top(key):
        rows = sorted(ev, key=lambda e: getattr(e, key), reverse=True)[:10]
        return [{"op": e.key, "count_per_token": e.count / n,
                 "ms_per_token": getattr(e, key) / 1e3 / n} for e in rows]
    return {"arch": arch, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
            "batch": batch, "prompt": prompt,
            "wall_ms_per_token_profiler_off": wall_off,
            "wall_ms_per_token_profiler_on": wall_on,
            "device_busy_ms_per_token": busy,
            "device_idle_share": (1 - busy / wall_on) if dev_us else None,
            "kernel_launches_per_token": launches / n,
            "top_host": top("self_cpu_time_total"),
            "top_device": top("self_device_time_total")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.arch, args.device, args.steps), indent=1))


if __name__ == "__main__":
    main()
