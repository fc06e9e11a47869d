#!/usr/bin/env python3
"""Time the recursive kernels' solo launches (K3 and K7, one tensor, no
tenant axis) on Chicago mode 0, and K7 on an Enron-shaped mode whose Temp
is taller than one shared-memory window, with their registers a thread,
on one CUDA card.

    python3 tools/torch_recursive_solo.py [--root DIR] [--label NAME]

Builds the port's kernels of ``--root`` (default: this checkout), makes
the Chicago-crime-comm shape (6,186 × 24 × 77 × 32, the repository's
seeded ``blocked_tensor``, 4.86 M nonzeros, 1,024 partitions) with seeded
random factors at rank 16, and times with CUDA events (median of 20
calls after 3 warm-ups) K3 (``recursive_partials``, rank tile 16, 128
threads) and K7 (``phi_partials`` under ALTO-OTF) on mode 0. Then makes
FROSTT Enron's shape (`bench/configs/enron.json`, drawn on the card by
`bench.generators` of the script's checkout from a fixed seed: 6,066 ×
5,699 × 244,268 × 1,176, 54.2 M nonzeros, 1,024 partitions) and times K7
on each of its modes (Temps of 5,983, about 5,300, 5,300 and 1,140
rows; the first three taller than one window) the same way. K7 takes the launch the
checkout's wrapper chooses from the plan's 128 threads; the script
counts its nonzero-walks (each partition's nonzeros once per window its
rows reach, the windows of that launch) and prints K7's ns a walk on
both shapes. Prints nvcc's register counts of ``mttkrp.cu`` and
``cpapr_phi.cu`` and, for each K7 instantiation at rank 16, its
registers and spills, then one JSON line. Uses only wrapper calls every
version of the port since CP-APR has, so one script times a parent
commit and its change alike: run ``--root`` parent, change, change,
parent in one call. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

R = 16
ENRON_SEED = 20261018


def k7_registers(log: str) -> dict:
    """ptxas's ``Used N registers`` line, and its spill line, of each K7
    entry of the rank-16 lane map (``<4, 4, 2...>``) in nvcc's output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        k = name and re.search(
            r"(phi_partials_smem_kernel\w*?)I((?:Li\d+E)+)E", name)
        if not k or not k.group(2).startswith("Li4ELi4ELi2E"):
            continue
        targs = re.findall(r"Li(\d+)E", k.group(2))
        key = f"{k.group(1)}<{','.join(targs)}>"
        if "spill" in ln or "registers" in ln:
            out.setdefault(key, []).append(ln.strip())
    return out


def walks(at, mode: int, window: int) -> int:
    """K7's nonzero-walks in windows of ``window`` rows: each partition's
    nonzeros once per window its rows reach (once where one window holds
    the whole Temp)."""
    import torch
    from repro_torch.core.encoding import extract_mode
    L = at.part_start.shape[0]
    chunk = at.values.shape[0] // L
    if window >= at.meta.temp_rows[mode]:
        return L * chunk
    rows = extract_mode(at.meta.enc, at.words, mode).long().reshape(L, chunk)
    reach = (rows - at.part_start[:, mode].long()[:, None]).max(1).values + 1
    return int(torch.div(reach + window - 1, window,
                         rounding_mode="floor").sum()) * chunk


def k7_window(common, T: int, limit: int) -> int:
    """The window the checkout's K7 takes from the plan's 128 threads."""
    if hasattr(common, "k7_launch"):
        return common.k7_launch(T, R, limit, 128)[2]
    return common.window_rows(T, R, limit, True)


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
    # The benchmark's frozen generators, for the Enron shape.
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    from repro_torch.core import alto
    from repro_torch.kernels import _build, common
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

    limit = common.smem_limit(torch.device("cuda"))

    def k7_ms(at, mode, fs, B):
        T = at.meta.temp_rows[mode]
        return ms(lambda: k7.phi_partials(
            at.meta.enc, mode, T, 1e-10, at.words, at.values, at.part_start,
            B, factors=fs, threads=128))

    out = {"card": card, "root": str(root), "label": args.label,
           "registers": regs,
           "k7_registers": k7_registers(_build.BUILD_LOG["cpapr_phi"]),
           "k3_ms": ms(lambda: k3.recursive_partials(
               at.meta.enc, 0, T, at.words, at.values, at.part_start, fs,
               16, 128)),
           "k7_ms": k7_ms(at, 0, fs, B)}
    out["k7_ns_walk"] = 1e6 * out["k7_ms"] / walks(at, 0, k7_window(
        common, T, limit))
    del at, fs, B
    torch.cuda.empty_cache()

    out.update(enron_k7(torch, alto, common, k7_ms, limit))
    print(card)
    for name, lines in out["k7_registers"].items():
        print(name, "; ".join(lines))
    print(f"K7 ns a nonzero-walk: Chicago mode 0 {out['k7_ns_walk']:.4f}, "
          f"Enron modes 0-3 "
          f"{', '.join(f'{v:.4f}' for v in out['enron_k7_ns_walk'])}")
    print(json.dumps(out))
    return 0


def enron_k7(torch, alto, common, k7_ms, limit: int) -> dict:
    """K7 on each mode of the Enron shape: ms, window, walks and ns a
    walk, a list of each by mode."""
    from bench import generators
    from repro_torch.sparse.tensor import SparseTensor
    here = pathlib.Path(__file__).resolve().parents[1]
    cfg = json.loads((here / "bench/configs/enron.json").read_text())
    coo = generators.make_tensor(cfg, ENRON_SEED, torch.device("cuda"))
    x = SparseTensor(coo.dims, coo.coords.to(torch.int32).cpu().numpy(),
                     coo.values.cpu().numpy())
    del coo
    at = alto.build_device(x, n_partitions=int(cfg["n_partitions"]))
    del x
    g = torch.Generator(device="cuda").manual_seed(7)
    fs = [torch.rand((I, R), generator=g, device="cuda") + 0.1
          for I in at.meta.dims]
    out = {}
    for mode, T in enumerate(at.meta.temp_rows):
        window = k7_window(common, T, limit)
        t_ms = k7_ms(at, mode, fs, fs[mode] * 3.0)
        n = walks(at, mode, window)
        for k, v in (("temp_rows", T), ("window", window), ("walks", n),
                     ("k7_ms", t_ms), ("k7_ns_walk", 1e6 * t_ms / n)):
            out.setdefault(f"enron_{k}", []).append(v)
    return out


if __name__ == "__main__":
    sys.exit(main())
