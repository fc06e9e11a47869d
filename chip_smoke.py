#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), then:

1. holds every kernel against its plain PyTorch version on small
   adversarial run layouts: tolerance ``rtol=1e-5, atol=1e-6·max|plain|``,
   K1 (carry) equal to K2 + segment_merge (``torch.equal``), and equal bits
   on a second run;
2. decomposes the Chicago-crime-comm shape (6,186 × 24 × 77 × 32, 4.86 M
   nonzeros from the repo's seeded ``blocked_tensor`` recipe) with
   ``build_device(n_partitions=1024)`` and 10 CP-ALS iterations at rank 16;
3. decomposes the 1998 DARPA shape (22,476 × 22,476 × 23,776,223, 28.4 M
   nonzeros from ``uniform_tensor``) with 3 iterations under the port's
   plan and 3 more under the JAX package's routing (one-hot partials on
   every mode), which must give the same fits bit for bit;
4. at the main path's shapes, checks each kernel against its plain version
   and times kernel, plain version and bound.

Each CP-ALS run is driven with the launch counts set to 0 just before it
and read just after; a run fails unless the kernels its plan picks were
launched and no plain version ran on a CUDA tensor. Fits must be finite
and never drop by more than 1e-3. A small decomposition on the card must
match the same one on the CPU within 1e-5 in fit.

Output: the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises and
exits non-zero; without CUDA, or outside a checkout of the repository,
the script exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
RANK = 16
RTOL = 1e-5
ATOL_REL = 1e-6


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


torch = None                   # imported by _imports, after the checks


def _imports():
    global torch
    import torch as torch_mod
    if not torch_mod.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    torch = torch_mod
    from repro_torch.core import alto, cpals, heuristics, plan
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mttkrp as k3
    from repro_torch.kernels import mttkrp_oriented as kori
    from repro_torch.sparse import synthetic
    return dict(alto=alto, cpals=cpals, heuristics=heuristics, plan=plan,
                build=_build, ops=ops, k3=k3, kori=kori, synthetic=synthetic)


def _sync():
    torch.cuda.synchronize()


def _check_close(name: str, got, plain) -> float:
    got, plain = got.float(), plain.float()
    if got.shape != plain.shape:
        _fail(f"{name}: shape {tuple(got.shape)} vs {tuple(plain.shape)}")
    if not bool(torch.isfinite(got).all()):
        _fail(f"{name}: non-finite output")
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((got - plain).abs().max()) if plain.numel() else 0.0
    if not torch.allclose(got, plain, rtol=RTOL, atol=ATOL_REL * scale):
        _fail(f"{name}: max_abs_err {err} beyond rtol={RTOL}, "
              f"atol={ATOL_REL}·{scale}")
    return err


def _check_equal(name: str, a, b) -> None:
    if not torch.equal(a, b):
        _fail(f"{name}: not bitwise equal")


def _ms(m, fn, *args, iters=10) -> float:
    return m["ops"].timing_stats(fn, *args, warmup=2, iters=iters)[0] * 1e3


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel checks against the plain versions
# ---------------------------------------------------------------------------

def check_oriented_kernels(m, view, factors, block_m, r_block, threads,
                           label: str) -> dict:
    """K1 runs, carry fix-up and K2 against their plain versions on one
    oriented view; K1 == K2 + segment_merge; repeatability."""
    ops, kori = m["ops"], m["kori"]
    enc, mode = view.meta.enc, view.mode
    rows, words, values = ops.pad_sorted_stream(view.rows, view.words,
                                                view.values, block_m)
    args = (enc, mode, rows, words, values, factors)
    kw = dict(block_m=block_m, r_block=r_block, threads=threads)
    out, crow, cval = kori.carry_runs(*args, **kw)
    out2, crow2, cval2 = kori.carry_runs(*args, **kw)
    _sync()
    for a, b, what in ((out, out2, "out"), (crow, crow2, "carry_row"),
                       (cval, cval2, "carry_val")):
        _check_equal(f"{label} carry_runs repeat {what}", a, b)
    p_out, p_crow, p_cval = kori.carry_runs_plain(*args, block_m)
    _check_equal(f"{label} carry_runs carry_row", crow, p_crow)
    errs = {"carry_runs": max(
        _check_close(f"{label} carry_runs out", out, p_out),
        _check_close(f"{label} carry_runs carry_val", cval, p_cval))}

    fix = kori.carry_fixup(crow, cval, out.clone(), r_block, threads)
    fix2 = kori.carry_fixup(crow, cval, out.clone(), r_block, threads)
    _check_equal(f"{label} carry_fixup repeat", fix, fix2)
    errs["carry_fixup"] = _check_close(
        f"{label} carry_fixup", fix,
        kori.carry_fixup_plain(crow, cval, out.clone()))

    part = kori.oriented_partials(*args, **kw)
    _check_equal(f"{label} oriented_partials repeat", part,
                 kori.oriented_partials(*args, **kw))
    errs["oriented_partials"] = _check_close(
        f"{label} oriented_partials", part,
        kori.oriented_partials_plain(*args, block_m))

    k1 = ops.mttkrp_oriented_carry(view, factors, **kw)
    k2 = ops.mttkrp_oriented(view, factors, **kw)
    _check_equal(f"{label} K1 vs K2+segment_merge", k1, k2)
    _check_equal(f"{label} K1 repeat", k1,
                 ops.mttkrp_oriented_carry(view, factors, **kw))
    return errs


def check_recursive_kernel(m, at, factors, mode, r_block, threads,
                           label: str) -> float:
    k3 = m["k3"]
    meta = at.meta
    args = (meta.enc, mode, meta.temp_rows[mode], at.words, at.values,
            at.part_start, factors)
    temp = k3.recursive_partials(*args, r_block=r_block, threads=threads)
    _check_equal(f"{label} recursive_partials repeat", temp,
                 k3.recursive_partials(*args, r_block=r_block,
                                       threads=threads))
    return _check_close(f"{label} recursive_partials", temp,
                        k3.recursive_partials_plain(*args))


def _stream_tensor(row_counts, dims, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(row_counts), dtype=np.int32), row_counts)
    coords = np.stack(
        [rows] + [rng.integers(0, I, size=rows.shape[0]).astype(np.int32)
                  for I in dims[1:]], axis=1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    from repro_torch.sparse.tensor import SparseTensor
    return SparseTensor(dims, coords, vals)


def _factors(dims, seed, device="cuda"):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.rand((I, RANK), generator=g, device=device) + 0.05
            for I in dims]


def phase_small(m) -> dict:
    """Adversarial run layouts (tests/test_oriented_carry.py) on the card."""
    dims = (29, 13, 7)
    worst = {}
    for block_m in (8, 64):
        rng = np.random.default_rng(block_m)
        layouts = {
            "identical": np.eye(29, dtype=np.int64)[3] * (4 * block_m + 3),
            "distinct": np.ones(29, dtype=np.int64),
            "boundary_run": rng.integers(0, 3, size=29)
            + np.eye(29, dtype=np.int64)[11] * (3 * block_m + 2),
            "mixed": rng.integers(1, 2 * block_m, size=29),
        }
        for name, counts in layouts.items():
            x = _stream_tensor(counts, dims, seed=block_m)
            at = m["alto"].build_device(x, n_partitions=4)
            fs = _factors(dims, seed=block_m)
            label = f"small {name} block_m={block_m}"
            for r_block in (4, RANK):
                errs = check_oriented_kernels(
                    m, m["alto"].oriented_view_device(at, 0), fs, block_m,
                    r_block, 64, label)
                errs["recursive_partials"] = check_recursive_kernel(
                    m, at, fs, 0, r_block, 64, label)
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
    print(f"chip_smoke: small layouts ok, worst errors {worst}")
    return worst


def phase_small_cp_als(m) -> dict:
    """A small decomposition on the card matches the same one on the CPU."""
    x = m["synthetic"].blocked_tensor((60, 24, 77, 32), 20_000, block=8,
                                      n_blocks=20, seed=1, count_data=True)
    res = {}
    for dev in ("cuda", "cpu"):
        at = m["alto"].build_device(x, n_partitions=64, device=dev)
        fs = [f.to(dev) for f in _factors(x.dims, seed=9)]
        p = m["plan"].make_plan(at.meta, RANK, backend="cuda")
        res[dev] = m["cpals"].cp_als(at, RANK, n_iters=5, tol=0.0,
                                     factors=fs, plan=p).fits
    # 1e-5: float32 pinv from cuSOLVER against LAPACK's, and sums in
    # another order; the two have agreed within 6e-8 on an H100.
    if max(abs(a - b) for a, b in zip(res["cuda"], res["cpu"])) > 1e-5:
        _fail(f"small CP-ALS fits on the card {res['cuda']} vs the CPU "
              f"{res['cpu']}")
    print(f"chip_smoke: small CP-ALS fits on the card {res['cuda']}, "
          f"on the CPU {res['cpu']}")
    return {"fits_cuda": res["cuda"], "fits_cpu": res["cpu"]}


# ---------------------------------------------------------------------------
# Main path runs
# ---------------------------------------------------------------------------

def run_cp_als(m, at, p, n_iters: int, label: str) -> dict:
    """One counted CP-ALS run through the user entry points."""
    b = m["build"]
    trav = m["heuristics"].Traversal
    kernels_of = {trav.ORIENTED_CARRY: {"carry_runs", "carry_fixup"},
                  trav.OUTPUT_ORIENTED: {"oriented_partials", "carry_fixup"},
                  trav.RECURSIVE: {"recursive_partials"}}
    expect = set().union(*(kernels_of[mp.traversal] for mp in p.modes))
    fs = _factors(at.dims, seed=0)
    _sync()
    b.reset_counts()
    t0 = time.perf_counter()
    res = m["cpals"].cp_als(at, RANK, n_iters=n_iters, tol=0.0, factors=fs,
                            plan=p)
    _sync()
    seconds = time.perf_counter() - t0
    counts = b.counts()
    fits = res.fits
    if len(fits) != n_iters or not all(math.isfinite(f) for f in fits):
        _fail(f"{label}: fits {fits}")
    if any(b2 < a - 1e-3 for a, b2 in zip(fits, fits[1:])):
        _fail(f"{label}: fit dropped by more than 1e-3: {fits}")
    for k in expect:
        if counts["launches"][k] == 0:
            _fail(f"{label}: kernel {k} was never launched")
    if any(counts["plain_on_cuda"].values()):
        _fail(f"{label}: plain versions ran on CUDA tensors: "
              f"{counts['plain_on_cuda']}")
    for f in res.factors:
        if not bool(torch.isfinite(f).all()):
            _fail(f"{label}: non-finite factor")
    split = iteration_split(m, at, p, res)
    print(f"chip_smoke: {label}: traversals {p.traversals()} fits {fits} "
          f"in {seconds:.3f} s; launches {counts['launches']}; one more "
          f"iteration: {split}")
    return {"traversals": p.traversals(), "fits": fits, "seconds": seconds,
            "launches": counts["launches"], "res": res, **split}


def iteration_split(m, at, p, res) -> dict:
    """Seconds of one more sweep on the card (MTTKRPs + dense algebra)
    and of its host float64 fit, from the run's final state."""
    cp = m["cpals"]
    views = m["plan"].build_views(at, p)
    normX2 = float((at.values.double() ** 2).sum())
    _sync()
    t0 = time.perf_counter()
    fs, lam, M = cp._sweep(p, at, views, res.factors, res.lam)
    _sync()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp._fit_host(M, fs, lam, normX2)
    return {"sweep_s": sweep_s, "fit_s": time.perf_counter() - t0}


def phase_chicago(m) -> dict:
    t0 = time.perf_counter()
    x = m["synthetic"].blocked_tensor((6186, 24, 77, 32), 5_330_673,
                                      block=16, n_blocks=512, seed=0,
                                      count_data=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    at = m["alto"].build_device(x, n_partitions=1024)
    _sync()
    build_s = time.perf_counter() - t0
    p = m["plan"].plan_for(at, RANK)
    trav = m["heuristics"].Traversal
    kinds = {mp.traversal for mp in p.modes}
    if not {trav.RECURSIVE, trav.ORIENTED_CARRY} <= kinds:
        _fail(f"chicago plan {p.traversals()} lacks recursive or carry")
    run = run_cp_als(m, at, p, 10, "chicago cp_als")
    return {"x": x, "at": at, "plan": p, "run": run, "gen_s": gen_s,
            "build_s": build_s, "nnz": x.nnz,
            "fiber_reuse": at.meta.fiber_reuse}


def phase_darpa(m) -> dict:
    t0 = time.perf_counter()
    x = m["synthetic"].uniform_tensor((22476, 22476, 23_776_223),
                                      28_436_033, seed=0, count_data=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    at = m["alto"].build_device(x, n_partitions=1024)
    _sync()
    build_s = time.perf_counter() - t0
    del x
    p = m["plan"].plan_for(at, RANK)
    port = run_cp_als(m, at, p, 3, "darpa cp_als (port plan)")
    # The JAX package routes every mode to the one-hot partials (K2) here;
    # at equal tiles that routing must give the same fits bit for bit.
    trav = m["heuristics"].Traversal
    jax_like = dataclasses.replace(p, modes=tuple(
        dataclasses.replace(mp, traversal=trav.OUTPUT_ORIENTED)
        for mp in p.modes))
    onehot = run_cp_als(m, at, jax_like, 3, "darpa cp_als (one-hot routing)")
    if port["fits"] != onehot["fits"]:
        _fail(f"darpa fits differ between carry and one-hot routing: "
              f"{port['fits']} vs {onehot['fits']}")
    return {"at": at, "plan": p, "run": port, "onehot_run": onehot,
            "gen_s": gen_s, "build_s": build_s, "nnz": at.meta.nnz,
            "fiber_reuse": at.meta.fiber_reuse}


# ---------------------------------------------------------------------------
# Real-size kernel checks and timings
# ---------------------------------------------------------------------------

def _stream_bytes(M, W):
    return M * (4 + 4 * W + 4)


def _factor_bytes(meta, mode, R):
    return sum(I for n, I in enumerate(meta.dims) if n != mode) * R * 4


def time_oriented(m, view, factors, mp, launches) -> list[dict]:
    ops, kori = m["ops"], m["kori"]
    meta, mode = view.meta, view.mode
    N, W, R = meta.enc.ndim, meta.enc.n_words, RANK
    bm, rb, th = mp.block_m, mp.r_block, mp.threads
    errs = check_oriented_kernels(m, view, factors, bm, rb, th,
                                  f"mode {mode} real size")
    rows, words, values = ops.pad_sorted_stream(view.rows, view.words,
                                                view.values, bm)
    M = rows.shape[0]
    nb = M // bm
    I_n = meta.dims[mode]
    args = (meta.enc, mode, rows, words, values, factors)
    kw = dict(block_m=bm, r_block=rb, threads=th)
    stream = _stream_bytes(M, W)
    fac = _factor_bytes(meta, mode, R)
    out_b = I_n * R * 4
    carries = nb * 2 * (4 + 4 * R)
    krp_ops = M * R * N                       # N-2 products, scale, add
    out, crow, cval = kori.carry_runs(*args, **kw)
    present = crow[crow >= 0]
    fix_rows = int(torch.unique(present).numel())
    keep_rows = present.long()
    keep_vals = cval.reshape(-1, R)[(crow >= 0).reshape(-1)]
    shape = f"mode {mode} of {meta.dims}, M={M}, R={R}, block_m={bm}"
    entries = []

    def entry(name, replaces, ms, plain_ms, nbytes, nops, err, library_ms,
              op=None, op_ms=None, op_plain_ms=None, op_bytes=None):
        bound, by = _bound(nbytes, nops)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "mttkrp.cu" if name == "recursive_partials"
                else "mttkrp_oriented.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "shape": shape})
        if op is not None:      # the op the main path calls around it
            entries[-1].update(op=op, op_ms=op_ms, op_plain_ms=op_plain_ms,
                               op_bound_ms=_bound(op_bytes, nops)[0])

    def k1_plain():
        o, r, v = kori.carry_runs_plain(*args, bm)
        return kori.carry_fixup_plain(r, v, o)

    def k2_plain():
        part = kori.oriented_partials_plain(*args, bm)
        o, r, v = kori.split_block_runs(part, rows, I_n)
        return kori.carry_fixup_plain(r, v, o)

    k1_op = _ms(m, ops.mttkrp_oriented_carry, view, factors, bm, rb, th)
    k1_op_plain = _ms(m, k1_plain, iters=3)
    entry("carry_runs", "src/repro/kernels/mttkrp_oriented.py:358",
          _ms(m, kori.carry_runs, *args, bm, rb, th),
          _ms(m, kori.carry_runs_plain, *args, bm, iters=3),
          stream + fac + out_b + carries, krp_ops, errs["carry_runs"], None,
          "ops.mttkrp_oriented_carry", k1_op, k1_op_plain,
          stream + fac + out_b)
    entry("carry_fixup", "src/repro/kernels/mttkrp_oriented.py:254",
          _ms(m, kori.carry_fixup, crow, cval, out.clone(), rb, th),
          _ms(m, kori.carry_fixup_plain, crow, cval, out.clone(), iters=3),
          carries + fix_rows * R * 4, present.numel() * R,
          errs["carry_fixup"],
          _ms(m, lambda: out.clone().index_add_(0, keep_rows, keep_vals)))
    part_b = nb * bm * R * 4
    entry("oriented_partials", "src/repro/kernels/mttkrp_oriented.py:132",
          _ms(m, kori.oriented_partials, *args, bm, rb, th),
          _ms(m, kori.oriented_partials_plain, *args, bm, iters=3),
          stream + fac + part_b, krp_ops, errs["oriented_partials"], None,
          "ops.mttkrp_oriented",
          _ms(m, ops.mttkrp_oriented, view, factors, bm, rb, th),
          _ms(m, k2_plain, iters=3),
          stream + fac + 2 * part_b + M * 4 + out_b)
    return entries


def time_recursive(m, at, factors, mp, launches) -> dict:
    ops, k3 = m["ops"], m["k3"]
    meta, mode = at.meta, mp.mode
    W, N, R = meta.enc.n_words, meta.enc.ndim, RANK
    L, T = meta.n_partitions, meta.temp_rows[mode]
    Mp = at.words.shape[0]
    err = check_recursive_kernel(m, at, factors, mode, mp.r_block,
                                 mp.threads, f"mode {mode} real size")
    args = (meta.enc, mode, T, at.words, at.values, at.part_start, factors)
    stream = Mp * (4 * W + 4) + L * N * 4
    fac = _factor_bytes(meta, mode, R)
    temp_b = L * T * R * 4
    bound, by = _bound(stream + fac + temp_b, Mp * R * N)

    def plain_op():
        return ops.pull_reduction(k3.recursive_partials_plain(*args),
                                  at.part_start[:, mode], meta.dims[mode])

    return {
        "name": "recursive_partials", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mttkrp.cu",
        "replaces": "src/repro/kernels/mttkrp.py:75",
        "launches": launches["recursive_partials"], "max_abs_err": err,
        "ms": _ms(m, k3.recursive_partials, *args, mp.r_block, mp.threads),
        "plain_ms": _ms(m, k3.recursive_partials_plain, *args, iters=3),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"mode {mode} of {meta.dims}, Mp={Mp}, L={L}, T={T}, "
                 f"R={R}",
        "op": "ops.mttkrp",
        "op_ms": _ms(m, ops.mttkrp, at, factors, mode, mp.r_block,
                     mp.threads),
        "op_plain_ms": _ms(m, plain_op, iters=3),
        "op_bound_ms": _bound(stream + fac + 2 * temp_b
                              + meta.dims[mode] * R * 4, Mp * R * N)[0]}


def mode_times(m, at, p, views, factors) -> list[float]:
    """ms of one execute_mttkrp per mode, as the sweep calls it."""
    return [_ms(m, m["plan"].execute_mttkrp, p, at, views, factors, n,
                iters=5) for n in range(len(at.dims))]


def main() -> int:
    m = _imports()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"chip_smoke: torch {torch.__version__} cuda "
          f"{torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_s = m["build"].build_all()
    print(f"chip_smoke: kernels built in {time.perf_counter() - t0:.1f} s "
          f"{build_s}")
    for name, log in m["build"].BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"chip_smoke: ptxas {name}: {line.strip()}")
    t_start = time.perf_counter()
    small = {"worst_err": phase_small(m), **phase_small_cp_als(m)}
    chicago = phase_chicago(m)
    darpa = phase_darpa(m)
    launches = {k: chicago["run"]["launches"][k]
                + darpa["run"]["launches"][k]
                + darpa["onehot_run"]["launches"][k]
                for k in m["build"].KERNELS}

    trav = m["heuristics"].Traversal
    cp, dp = chicago["plan"], darpa["plan"]
    c_fs = chicago["run"]["res"].factors
    d_fs = darpa["run"]["res"].factors
    rec = next(mp for mp in cp.modes if mp.traversal is trav.RECURSIVE)
    kernels = [time_recursive(m, chicago["at"], c_fs, rec, launches)]
    big = dp.modes[2]                      # the 23.8 M-row mode
    d_view = m["plan"].build_views(darpa["at"], dp)[2]
    kernels += time_oriented(m, d_view, d_fs, big, launches)
    kernels.sort(key=lambda e: m["build"].KERNELS.index(e["name"]))
    c_views = m["plan"].build_views(chicago["at"], cp)
    per_mode = {"chicago": mode_times(m, chicago["at"], cp, c_views, c_fs),
                "darpa": mode_times(m, darpa["at"], dp,
                                    m["plan"].build_views(darpa["at"], dp),
                                    d_fs)}
    for e in kernels:
        if e["launches"] == 0:
            _fail(f"kernel {e['name']} never launched on the main path")
    elapsed = time.perf_counter() - t_start

    detail = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build_s, "small": small,
        "chicago": {k: chicago[k] for k in ("gen_s", "build_s", "nnz",
                                            "fiber_reuse")}
        | {"traversals": chicago["run"]["traversals"],
           "fits": chicago["run"]["fits"],
           "cp_als_s": chicago["run"]["seconds"],
           "sweep_s": chicago["run"]["sweep_s"],
           "fit_s": chicago["run"]["fit_s"],
           "launches": chicago["run"]["launches"],
           "mttkrp_ms_per_mode": per_mode["chicago"],
           "tiles": [(mp.r_block, mp.block_m, mp.threads)
                     for mp in cp.modes]},
        "darpa": {k: darpa[k] for k in ("gen_s", "build_s", "nnz",
                                        "fiber_reuse")}
        | {"traversals": darpa["run"]["traversals"],
           "fits": darpa["run"]["fits"],
           "cp_als_s": darpa["run"]["seconds"],
           "sweep_s": darpa["run"]["sweep_s"],
           "fit_s": darpa["run"]["fit_s"],
           "onehot_cp_als_s": darpa["onehot_run"]["seconds"],
           "onehot_sweep_s": darpa["onehot_run"]["sweep_s"],
           "launches": darpa["run"]["launches"],
           "onehot_launches": darpa["onehot_run"]["launches"],
           "mttkrp_ms_per_mode": per_mode["darpa"],
           "tiles": [(mp.r_block, mp.block_m, mp.threads)
                     for mp in dp.modes]},
        "kernels": kernels, "seconds_after_build": elapsed,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"chip_smoke: per-mode MTTKRP ms {per_mode}; "
          f"{elapsed:.1f} s after the build")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
