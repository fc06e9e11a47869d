#!/usr/bin/env python3
"""Time the recursive pull (`kernels.ops.pull_reduction`) through the
reach order and through the dense order on the benchmark's shapes, on one
CUDA card, and hold the two bit for bit.

    python3 tools/torch_pull_reach.py [--seed N]

Builds the port's kernels, draws FROSTT Enron's and Chicago-crime-comm's
tensors on the card with the benchmark's frozen generators
(`bench/configs/enron.json`, `chicago-crime-comm.json`, seed ``--seed``,
1,024 partitions), and on every mode of Enron and mode 0 of Chicago:

* K7's Temp buffers under ALTO-OTF (seeded random factors, rank 16), and
  on Chicago's mode 0 K3's too (factors in [-0.5, 0.5));
* the reach order (`core.views.get_pull_order`, its build timed once on
  an empty cache) and the dense order of all ``L·T`` Temp rows
  (`core.views.pull_order`): pieces of each, and pieces a row;
* the pull through each (CUDA events, median of 20 calls after 3
  warm-ups), the two results compared bit for bit, and the counter
  ``pull_pieces_skipped`` of the reach pull against ``L·T`` less its
  pieces.

Exits non-zero when a pair of results differs in a bit or a count is off;
prints the card's name and power limit, one line a mode and one JSON
line, also written to ``chiprun_out/pull_reach.json``. Without CUDA it
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

R = 16
ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=20261019)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pull_reach: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from bench import generators
    from repro_torch.core import alto, views
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cpapr_phi as k7
    from repro_torch.kernels import mttkrp as k3
    from repro_torch.sparse.tensor import SparseTensor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()

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

    def once_ms(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop)

    def tensor(name):
        cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
        coo = generators.make_tensor(cfg, args.seed, torch.device("cuda"))
        x = SparseTensor(coo.dims, coo.coords.to(torch.int32).cpu().numpy(),
                         coo.values.cpu().numpy())
        del coo
        return alto.build_device(x, n_partitions=int(cfg["n_partitions"]))

    failures = []

    def pull_entry(label, at, mode, temp):
        m = at.meta
        L, T, I_n = m.n_partitions, m.temp_rows[mode], m.dims[mode]
        start = at.part_start[:, mode]
        views.cache_clear()
        reach, build_ms = once_ms(lambda: views.get_pull_order(at, mode))
        dense, dense_build_ms = once_ms(
            lambda: views.pull_order(start, T, I_n))
        _build.reset_counts()
        got = ops.pull_reduction(temp, start, I_n, order=reach)
        c = _build.counts()
        want = ops.pull_reduction(temp, start, I_n, order=dense)
        none = ops.pull_reduction(temp, start, I_n)
        pieces = int(reach.order.shape[0])
        rows = int(torch.unique(reach.rows).numel())
        e = {"label": label, "mode": mode, "rows": I_n, "temp_rows": T,
             "dense_pieces": L * T, "reach_pieces": pieces,
             "reach_share_pct": 100.0 * pieces / (L * T),
             "rows_reached": rows, "pieces_a_row": pieces / rows,
             "bits_equal": bool(torch.equal(got, want)
                                and torch.equal(got, none)),
             "skipped_launches": c["launches"]["pull_pieces_skipped"],
             "skipped_elements": c["elements"]["pull_pieces_skipped"],
             "reach_build_ms": build_ms, "dense_build_ms": dense_build_ms,
             "reach_ms": ms(lambda: ops.pull_reduction(temp, start, I_n,
                                                       order=reach)),
             "dense_ms": ms(lambda: ops.pull_reduction(temp, start, I_n,
                                                       order=dense))}
        if not e["bits_equal"]:
            failures.append(f"{label} mode {mode}: bits differ")
        if (e["skipped_launches"], e["skipped_elements"]) != (
                1, L * T - pieces):
            failures.append(f"{label} mode {mode}: counter "
                            f"{e['skipped_launches']}, "
                            f"{e['skipped_elements']}")
        print(f"{label} mode {mode}: pieces {L * T:,} -> {pieces:,} "
              f"({e['reach_share_pct']:.3f} %), {e['pieces_a_row']:.2f} a "
              f"row; pull {e['dense_ms']:.4f} -> {e['reach_ms']:.4f} ms; "
              f"reach build {build_ms:.2f} ms; bits equal "
              f"{e['bits_equal']}")
        return e

    def factors(at, seed, low):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.rand((I, R), generator=g, device="cuda") + low
                for I in at.meta.dims]

    out = {"card": card, "seed": args.seed, "entries": []}
    at = tensor("chicago-crime-comm")
    m = at.meta
    fs = factors(at, 7, 0.1)
    temp = k7.phi_partials(m.enc, 0, m.temp_rows[0], 1e-10, at.words,
                           at.values, at.part_start, fs[0] * 3.0, factors=fs)
    out["entries"].append(pull_entry("chicago k7", at, 0, temp))
    fs = factors(at, 8, -0.5)
    temp = k3.recursive_partials(m.enc, 0, m.temp_rows[0], at.words,
                                 at.values, at.part_start, fs)
    out["entries"].append(pull_entry("chicago k3", at, 0, temp))
    del at, fs, temp
    torch.cuda.empty_cache()

    at = tensor("enron")
    m = at.meta
    fs = factors(at, 7, 0.1)
    for mode in range(len(m.dims)):
        temp = k7.phi_partials(m.enc, mode, m.temp_rows[mode], 1e-10,
                               at.words, at.values, at.part_start,
                               fs[mode] * 3.0, factors=fs)
        out["entries"].append(pull_entry("enron k7", at, mode, temp))
        del temp
    out["failures"] = failures
    print(card)
    line = json.dumps(out)
    print(line)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "pull_reach.json").write_text(line + "\n")
    for f in failures:
        print("FAIL", f, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
