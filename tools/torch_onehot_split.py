#!/usr/bin/env python3
"""Time the one-hot (output-oriented) route — the MTTKRP partials kernel
K2 and the split of ``segment_merge`` — at the main path's shape, with the
end-to-end times they move, on one CUDA card.

    python3 tools/torch_onehot_split.py [--out NAME] [--root DIR]

Builds the port's kernels, makes the 1998 DARPA shape (22,476 × 22,476 ×
23,776,223, 28.4 M nonzeros from the repository's seeded
``uniform_tensor``) at rank 16 with seeded random factors, and times with
CUDA events (median of 10 calls after 2 warm-ups), on mode 2 at the plan's
tiles:

* K2 (``oriented_partials``) and, beside it, K1's runs pass
  (``carry_runs``);
* the split of ``segment_merge`` on K2's slots (``segment_split`` where
  the checkout has it, else the PyTorch ``split_block_runs``), the fix-up
  on its carries, the whole ``ops.segment_merge``, and one
  ``index_add_`` of every slot to its run's row into zeros (the JAX
  package's ``segment_merge`` as one PyTorch call);
* ``ops.mttkrp_oriented`` (K2 + merge), ``ops.mttkrp_oriented_carry``
  (K1) and, under ALTO-PRE (Π rows given), ``ops.cpapr_phi_oriented`` (K6
  + merge);
* one CP-ALS sweep (``cpals._sweep``: the three modes' MTTKRPs and the
  dense algebra) under the JAX package's routing (one-hot partials on
  every mode) and under the port's plan (K1);
* the DARPA CP-APR under the JAX routing: 2 outer iterations after one
  warm-up run, seconds each on the host clock.

Calls without a host synchronisation are also replayed from a CUDA graph
of several calls, timed with CUDA events and divided by the calls
(``*_graph_ms``): the device time without the host's launch work. That
is K2, K1's runs pass, the fix-up and, where the checkout has the split
kernel, the split, ``segment_merge`` and both ops (the PyTorch split
reads a count back to the host, so it cannot be captured). Uses only
wrapper calls whose signatures the port has had since CP-APR, so one
script times a parent commit and its change alike (``--root``). Prints
the card's name and power limit and one JSON line; writes
``chiprun_out/<NAME>.json`` (default ``onehot_split``). Without CUDA it
exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

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


def _graph_ms(torch, fn, *args, calls=4) -> float:
    """ms per call of ``fn(*args)`` replayed from a CUDA graph of
    ``calls`` calls: the device time without the host's launch work."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    ms = _ms(torch, graph.replay) / calls
    del graph
    return ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="onehot_split")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/ is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_onehot_split: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import alto, cpals, cpapr, heuristics, mttkrp, plan
    from repro_torch.kernels import _build, ops
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
    has_split = hasattr(kori, "segment_split")
    res = {"card": card, "root": str(root), "rank": R,
           "split": "segment_split" if has_split else "split_block_runs"}

    x = synthetic.uniform_tensor((22476, 22476, 23_776_223), 28_436_033,
                                 seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    p = plan.plan_for(at, R)
    fs = [torch.rand((I, R), device=dev, generator=g) + 0.05
          for I in at.dims]
    mp = p.modes[2]
    bm, rb, th = mp.block_m, mp.r_block, mp.threads
    I_n = at.dims[2]
    view = alto.oriented_view_device(at, 2)
    rows, words, values, _ = ops.pad_sorted_stream(view.rows, view.words,
                                                   view.values, bm)
    nb = rows.shape[0] // bm
    a = (at.meta.enc, 2, rows, words, values, fs, bm, rb, th)
    part = kori.oriented_partials(*a)
    rows_b = rows.reshape(nb, bm)
    seg_rows = torch.zeros_like(rows_b).scatter_(
        1, kori.run_rank_segments(rows_b), rows_b).reshape(-1).long()
    flat = part.reshape(-1, R)

    if has_split:
        def split():
            return kori.segment_split(part, rows, I_n, th)
    else:
        def split():
            return kori.split_block_runs(part, rows, I_n)
    out, crow, cval = split()
    d = {"M": rows.shape[0], "block_m": bm, "r_block": rb, "threads": th,
         "runs": nb + int((rows_b[:, 1:] != rows_b[:, :-1]).sum()),
         "k2_ms": _ms(torch, kori.oriented_partials, *a),
         "k2_graph_ms": _graph_ms(torch, kori.oriented_partials, *a),
         "k1_runs_ms": _ms(torch, kori.carry_runs, *a),
         "k1_runs_graph_ms": _graph_ms(torch, kori.carry_runs, *a),
         "split_ms": _ms(torch, split),
         "fixup_ms": _ms(torch, kori.carry_fixup, crow, cval, out, None,
                         th),
         "fixup_graph_ms": _graph_ms(torch, kori.carry_fixup, crow, cval,
                                     out, None, th),
         "merge_ms": _ms(torch, ops.segment_merge, part, rows, I_n, th),
         "index_add_ms": _ms(torch, lambda: torch.zeros(
             (I_n, R), device=dev).index_add_(0, seg_rows, flat)),
         "op_ms": _ms(torch, ops.mttkrp_oriented, view, fs, bm, rb, th),
         "carry_op_ms": _ms(torch, ops.mttkrp_oriented_carry, view, fs, bm,
                            rb, th)}
    if has_split:
        d["split_graph_ms"] = _graph_ms(torch, split)
        d["merge_graph_ms"] = _graph_ms(torch, ops.segment_merge, part,
                                        rows, I_n, th)
        d["op_graph_ms"] = _graph_ms(torch, ops.mttkrp_oriented, view, fs,
                                     bm, rb, th)
    del part, flat, seg_rows, out, crow, cval

    B = torch.rand((I_n, R), device=dev, generator=g) + 0.05
    pi = mttkrp.krp_rows(ops.delinearize(at.meta.enc, view.words), fs,
                         2).contiguous()
    d["phi_op_ms"] = _ms(torch, ops.cpapr_phi_oriented, view, B, None, pi,
                         1e-10, bm, th)
    if has_split:
        d["phi_op_graph_ms"] = _graph_ms(torch, ops.cpapr_phi_oriented,
                                         view, B, None, pi, 1e-10, bm, th)
    res["darpa_mode2"] = d
    del pi, B, rows, words, values, a

    trav = heuristics.Traversal
    jax_like = dataclasses.replace(p, modes=tuple(
        dataclasses.replace(m, traversal=trav.OUTPUT_ORIENTED)
        for m in p.modes))
    lam = torch.ones(R, device=dev)
    sweeps = {}
    for name, q in (("onehot", jax_like), ("port", p)):
        views = plan.build_views(at, q)
        sweeps[f"{name}_sweep_ms"] = _ms(
            torch, lambda: cpals._sweep(q, at, views, fs, lam))
        sweeps[f"{name}_mode_ms"] = [
            _ms(torch, plan.execute_mttkrp, q, at, views, fs, n)
            for n in range(len(at.dims))]
        del views
    res["darpa_cp_als"] = sweeps

    params = cpapr.CpaprParams(k_max=2, l_max=10)
    cpapr.cp_apr(at, R, params, seed=0, track_ll=True, plan=jax_like)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = cpapr.cp_apr(at, R, params, seed=0, track_ll=True, plan=jax_like)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    res["darpa_cp_apr_onehot"] = {
        "s_per_outer": seconds / run.n_outer, "n_inner": run.n_inner_total,
        "log_likelihoods": run.log_likelihoods,
        "kkt_violations": run.kkt_violations}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"{args.out}.json").write_text(json.dumps(res, indent=1))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
