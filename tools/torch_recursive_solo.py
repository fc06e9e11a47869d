#!/usr/bin/env python3
"""Time the recursive kernels' solo launches (K3 and K7, one tensor, no
tenant axis) on Chicago mode 0, with their registers a thread, on one
CUDA card.

    python3 tools/torch_recursive_solo.py [--root DIR] [--label NAME]

Builds the port's kernels of ``--root`` (default: this checkout), makes
the Chicago-crime-comm shape (6,186 × 24 × 77 × 32, the repository's
seeded ``blocked_tensor``, 4.86 M nonzeros, 1,024 partitions) with seeded
random factors at rank 16, and times with CUDA events (median of 20
calls after 3 warm-ups) K3 (``recursive_partials``, rank tile 16, 128
threads) and K7 (``phi_partials`` under ALTO-OTF) on mode 0. Prints
nvcc's register counts of ``mttkrp.cu`` and ``cpapr_phi.cu`` and one
JSON line. Uses only wrapper calls every version of the port since
CP-APR has, so one script times a parent commit and its change alike:
run ``--root`` parent, change, change, parent in one call. Without CUDA
it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

R = 16


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path.cwd()),
                    help="checkout whose src/ is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_recursive_solo: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import alto
    from repro_torch.kernels import _build
    from repro_torch.kernels import cpapr_phi as k7
    from repro_torch.kernels import mttkrp as k3
    from repro_torch.sparse import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    regs = {n: [ln.strip() for ln in _build.BUILD_LOG[n].splitlines()
                if "registers" in ln] for n in ("mttkrp", "cpapr_phi")}
    x = synthetic.blocked_tensor((6186, 24, 77, 32), 5_330_673, block=16,
                                 n_blocks=512, seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    g = torch.Generator(device="cuda").manual_seed(7)
    fs = [torch.rand((I, R), generator=g, device="cuda") + 0.1
          for I in at.meta.dims]
    T = at.meta.temp_rows[0]
    B = fs[0] * 3.0

    def ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        times.sort()
        return times[len(times) // 2]

    out = {"card": card, "root": str(root), "label": args.label,
           "registers": regs,
           "k3_ms": ms(lambda: k3.recursive_partials(
               at.meta.enc, 0, T, at.words, at.values, at.part_start, fs,
               16, 128)),
           "k7_ms": ms(lambda: k7.phi_partials(
               at.meta.enc, 0, T, 1e-10, at.words, at.values, at.part_start,
               B, factors=fs, threads=128))}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
