#!/usr/bin/env python3
"""Time the carry route's two passes apart, the fix-up under each of its
callers, and the ALTO decode (K4), on one CUDA card, at the shapes the
main path gives them.

    python3 tools/torch_carry_split.py [--out NAME]

Builds the port's kernels, makes the Chicago-crime-comm shape (6,186 ×
24 × 77 × 32, the repository's seeded ``blocked_tensor``, 4.86 M
nonzeros) and the 1998 DARPA shape (22,476 × 22,476 × 23,776,223, 28.4 M
nonzeros from ``uniform_tensor``) at rank 16 with seeded random factors,
and times with CUDA events (median of 10 calls after 2 warm-ups) through
the kernel wrappers:

* K1's runs pass (``carry_runs``), its fix-up (``carry_fixup``) and the
  whole op (``ops.mttkrp_oriented_carry``) on Chicago modes 1-3 and DARPA
  modes 0-2, at the plan's tiles;
* on DARPA modes 0-2, the first chunk of the streamed plan's ``chunk_m``:
  the fix-up of its pieces and K8 (``carry_chunk``, not the final chunk);
* the fix-up of the K5 route (ALTO-OTF, ``phi_carry_runs`` then
  ``carry_fixup``) on Chicago modes 1-3;
* the pull (``ops.pull_reduction`` with its cached order) on Chicago
  mode 0;
* K4 through ``ops.delinearize`` on the whole DARPA stream, on one DARPA
  chunk of the streamed plan's ``chunk_m`` (its own ragged length), and
  on the Chicago stream, and the K4 wrapper alone on the two whole
  streams.

The short kernels (the fix-up, K4) are also timed without the host's
launch overhead: 20 calls captured in one CUDA graph, the replay timed
with CUDA events and divided by 20 (``*_graph_ms``). Uses only wrapper
calls whose signatures every version of the port since the carry
route has, so one script times a parent commit and its change alike
(``--root``). Prints the card's name and power limit and one JSON line;
writes ``chiprun_out/<NAME>.json`` (default ``carry_split``). Without
CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path.cwd()
R = 16


def _ms(torch, fn, *args) -> float:
    for _ in range(2):
        fn(*args)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def _graph_ms(torch, fn, *args, calls=20) -> float:
    """ms per call of ``fn(*args)`` replayed from a CUDA graph of
    ``calls`` calls: the device time without the host's launch work."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    return _ms(torch, graph.replay) / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="carry_split")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/ is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_carry_split: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import alto, plan, views
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import delinearize as k4
    from repro_torch.kernels import mttkrp_oriented as kori
    from repro_torch.sparse import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    res = {"card": card, "root": str(root), "rank": R}

    def factors(dims):
        return [torch.rand((I, R), device=dev, generator=g) + 0.05
                for I in dims]

    def split(at, p, fs, mode, key):
        mp = p.modes[mode]
        view = alto.oriented_view_device(at, mode)
        rows, words, values, _ = ops.pad_sorted_stream(
            view.rows, view.words, view.values, mp.block_m)
        a = (at.meta.enc, mode, rows, words, values, fs, mp.block_m,
             mp.r_block, mp.threads)
        out, crow, cval = kori.carry_runs(*a)
        present = int((crow >= 0).sum())
        res[key] = {
            "M": rows.shape[0], "block_m": mp.block_m, "pieces": present,
            "rows": at.meta.dims[mode],
            "runs_ms": _ms(torch, kori.carry_runs, *a),
            "fixup_ms": _ms(torch, kori.carry_fixup, crow, cval, out, None,
                            mp.threads),
            "fixup_graph_ms": _graph_ms(torch, kori.carry_fixup, crow, cval,
                                        out, None, mp.threads),
            "op_ms": _ms(torch, ops.mttkrp_oriented_carry, view, fs,
                         mp.block_m, mp.r_block, mp.threads)}
        return view, rows, words, values

    # Chicago
    x = synthetic.blocked_tensor((6186, 24, 77, 32), 5_330_673, block=16,
                                 n_blocks=512, seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    p = plan.plan_for(at, R)
    fs = factors(at.dims)
    for mode in (1, 2, 3):
        view, rows, words, values = split(at, p, fs, mode,
                                          f"chicago_mode{mode}")
        mp = p.modes[mode]
        B = torch.rand((at.dims[mode], R), device=dev, generator=g)
        out, crow, cval = kori.phi_carry_runs(
            at.meta.enc, mode, 1e-10, rows, words, values, B, factors=fs,
            block_m=mp.block_m, threads=mp.threads)
        res[f"chicago_mode{mode}"]["k5_fixup_ms"] = _ms(
            torch, kori.carry_fixup, crow, cval, out, None, mp.threads)
    from repro_torch.kernels import mttkrp as k3
    T = at.meta.temp_rows[0]
    temp = k3.recursive_partials(at.meta.enc, 0, T, at.words, at.values,
                                 at.part_start, fs)
    order = views.get_pull_order(at, 0)
    res["chicago_pull_mode0"] = {
        "pieces": at.meta.n_partitions * T,
        "ms": _ms(torch, ops.pull_reduction, temp, at.part_start[:, 0],
                  at.dims[0], 128, order),
        "graph_ms": _graph_ms(torch, ops.pull_reduction, temp,
                              at.part_start[:, 0], at.dims[0], 128, order)}
    res["k4_chicago_op_ms"] = _ms(torch, ops.delinearize, at.meta.enc,
                                  at.words)
    res["k4_chicago_kernel_ms"] = _ms(torch, k4.delinearize, at.meta.enc,
                                      at.words)
    res["chicago_M"] = at.words.shape[0]
    del at, temp, fs

    # DARPA
    x = synthetic.uniform_tensor((22476, 22476, 23_776_223), 28_436_033,
                                 seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    p = plan.plan_for(at, R)
    fs = factors(at.dims)
    L = plan.heuristics.stream_len(at.meta)
    budget = (plan.streaming_resident_bytes(at.meta, R)
              + 2 * plan.stream_elem_bytes(at.meta) * -(-L // 8))
    chunk_m = plan.make_plan(at.meta, R, device_bytes=budget
                             ).streaming.chunk_m
    for mode in (0, 1, 2):
        key = f"darpa_mode{mode}"
        view, rows, words, values = split(at, p, fs, mode, key)
        mp = p.modes[mode]
        a = (at.meta.enc, mode, rows[:chunk_m], words[:chunk_m],
             values[:chunk_m], fs)
        out, crow, cval = kori.carry_runs(*a, mp.block_m, mp.r_block,
                                          mp.threads)
        cin_row = torch.full((1,), -1, dtype=torch.int32, device=dev)
        cin_val = torch.zeros((1, R), device=dev)
        res[key].update({
            "chunk_pieces": int((crow >= 0).sum()),
            "chunk_fixup_graph_ms": _graph_ms(torch, kori.carry_fixup, crow,
                                              cval, out, None, mp.threads),
            "k8_ms": _ms(torch, kori.carry_chunk, *a, out, cin_row, cin_val,
                         mp.block_m, mp.r_block, mp.threads, False)})
        del out, crow, cval
    view = alto.oriented_view_device(at, 2)
    chunk = view.words[:chunk_m].contiguous()
    res["darpa_chunk_m"] = chunk_m
    res["darpa_M"] = at.words.shape[0]
    res["k4_darpa_op_ms"] = _ms(torch, ops.delinearize, at.meta.enc,
                                at.words)
    res["k4_darpa_kernel_ms"] = _ms(torch, k4.delinearize, at.meta.enc,
                                    at.words)
    res["k4_darpa_chunk_op_ms"] = _ms(torch, ops.delinearize, at.meta.enc,
                                      chunk)
    res["k4_darpa_chunk_op_graph_ms"] = _graph_ms(
        torch, ops.delinearize, at.meta.enc, chunk)
    res["k4_darpa_op_graph_ms"] = _graph_ms(torch, ops.delinearize,
                                            at.meta.enc, at.words)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"{args.out}.json").write_text(json.dumps(res, indent=1))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
