#!/usr/bin/env python3
"""Time the recursive MTTKRP kernel (K3) and the Φ run-sum kernels (K5's
runs pass, K6) at the main path's shapes, with the end-to-end times they
move, on one CUDA card.

    python3 tools/torch_partials_split.py [--out NAME] [--root DIR]

Builds the port's kernels, makes the Chicago-crime-comm shape (6,186 ×
24 × 77 × 32, the repository's seeded ``blocked_tensor``, 4.86 M
nonzeros) and the 1998 DARPA shape (22,476 × 22,476 × 23,776,223, 28.4 M
nonzeros from ``uniform_tensor``) at rank 16 with seeded random factors,
and times with CUDA events (median of 10 calls after 2 warm-ups):

* on Chicago mode 0 (the plan's recursive mode): K3
  (``recursive_partials``) at the plan's rank tile and CTA size, at tiles
  of 8 and 4 columns and at CTAs of 256 and 512 threads, the whole op
  (``ops.mttkrp``: K3 and the pull), and one CP-ALS sweep
  (``cpals._sweep``, the four modes' MTTKRPs and the dense algebra);
* on DARPA mode 2 under ALTO-PRE (Π rows given): K6
  (``phi_oriented_partials``) and its op (``ops.cpapr_phi_oriented``: K6
  and ``segment_merge``), K5's runs pass (``phi_carry_runs``) and its op
  (``ops.cpapr_phi_oriented_carry``);
* the DARPA CP-APR under the JAX package's routing (one-hot partials, K6,
  on every mode): 2 outer iterations, seconds each on the host clock.

The kernels are also timed without the host's launch overhead: calls
captured in one CUDA graph, the replay timed with CUDA events and divided
by the calls (``*_graph_ms``). Uses only wrapper calls whose signatures
every version of the port since CP-APR has, so one script times a parent
commit and its change alike (``--root``). Prints the card's name and
power limit and one JSON line; writes ``chiprun_out/<NAME>.json``
(default ``partials_split``). Without CUDA it exits non-zero.
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


def _graph_ms(torch, fn, *args, calls=10) -> float:
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
    ap.add_argument("--out", default="partials_split")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/ is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_partials_split: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import alto, cpals, cpapr, heuristics, mttkrp, plan
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mttkrp as k3
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

    # Chicago: K3 on mode 0, the op, one sweep
    x = synthetic.blocked_tensor((6186, 24, 77, 32), 5_330_673, block=16,
                                 n_blocks=512, seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    p = plan.plan_for(at, R)
    fs = factors(at.dims)
    mp = p.modes[0]
    meta = at.meta
    a = (meta.enc, 0, meta.temp_rows[0], at.words, at.values, at.part_start,
         fs)
    k3_res = {"traversal": mp.traversal.value, "T": meta.temp_rows[0],
              "L": meta.n_partitions, "Mp": at.words.shape[0],
              "r_block": mp.r_block, "threads": mp.threads}
    for rb in (mp.r_block, 8, 4):
        k3_res[f"ms_rb{rb}"] = _ms(torch, k3.recursive_partials, *a, rb,
                                   mp.threads)
        k3_res[f"graph_ms_rb{rb}"] = _graph_ms(torch, k3.recursive_partials,
                                               *a, rb, mp.threads)
    for th in (256, 512):
        k3_res[f"graph_ms_threads{th}"] = _graph_ms(
            torch, k3.recursive_partials, *a, mp.r_block, th)
    k3_res["op_ms"] = _ms(torch, ops.mttkrp, at, fs, 0, mp.r_block,
                          mp.threads)
    k3_res["op_graph_ms"] = _graph_ms(torch, ops.mttkrp, at, fs, 0,
                                      mp.r_block, mp.threads)
    views = plan.build_views(at, p)
    lam = torch.ones(R, device=dev)
    k3_res["sweep_ms"] = _ms(torch, lambda: cpals._sweep(p, at, views, fs,
                                                         lam))
    k3_res["mode_ms"] = [_ms(torch, plan.execute_mttkrp, p, at, views, fs, n)
                         for n in range(len(at.dims))]
    res["chicago_k3_mode0"] = k3_res
    del at, views, fs, a

    # DARPA: K5 and K6 on mode 2 (PRE), the JAX routing's CP-APR
    x = synthetic.uniform_tensor((22476, 22476, 23_776_223), 28_436_033,
                                 seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    del x
    p = plan.plan_for(at, R)
    fs = factors(at.dims)
    mp = p.modes[2]
    view = alto.oriented_view_device(at, 2)
    B = torch.rand((at.dims[2], R), device=dev, generator=g) + 0.05
    pi = mttkrp.krp_rows(ops.delinearize(at.meta.enc, view.words), fs,
                         2).contiguous()
    rows, words, values, pi_p = ops.pad_sorted_stream(
        view.rows, view.words, view.values, mp.block_m, pi=pi)
    ka = (at.meta.enc, 2, 1e-10, rows, words, values, B, None, pi_p,
          mp.block_m, None, mp.threads)
    d = {"M": rows.shape[0], "block_m": mp.block_m, "threads": mp.threads,
         "k6_ms": _ms(torch, kori.phi_oriented_partials, *ka),
         "k6_graph_ms": _graph_ms(torch, kori.phi_oriented_partials, *ka,
                                  calls=4),
         "k6_op_ms": _ms(torch, ops.cpapr_phi_oriented, view, B, None, pi,
                         1e-10, mp.block_m, mp.threads),
         "k5_runs_ms": _ms(torch, kori.phi_carry_runs, *ka),
         "k5_runs_graph_ms": _graph_ms(torch, kori.phi_carry_runs, *ka,
                                       calls=4),
         "k5_op_ms": _ms(torch, ops.cpapr_phi_oriented_carry, view, B, None,
                         pi, 1e-10, mp.block_m, mp.threads)}
    res["darpa_phi_mode2_pre"] = d
    del pi, pi_p, rows, words, values, ka
    trav = heuristics.Traversal
    jax_like = dataclasses.replace(p, modes=tuple(
        dataclasses.replace(m, traversal=trav.OUTPUT_ORIENTED)
        for m in p.modes))
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
