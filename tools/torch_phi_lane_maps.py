#!/usr/bin/env python3
"""Time the port's redesigned Φ kernels (K5, K7) under several lane maps
at rank 16, on one CUDA card.

    python3 tools/torch_phi_lane_maps.py

A lane map is (W, COLS): a sub-warp of W lanes per slice (K5) or per
nonzero (K7), COLS rank columns per lane (`phi_dispatch` in
``src/repro_torch/kernels/csrc/phi_scan.cuh``). The script copies the
kernel sources once per map, replaces the rank-16 line of the dispatch,
builds ``phi_oriented.cu`` and ``cpapr_phi.cu`` with the repository's nvcc
flags into ``build/lane_maps/``, and times with CUDA events (median of 10
after 2 warm-ups) the bare C entries on:

* K5 under ALTO-PRE on a stream shaped like DARPA's mode 2 (23,776,223
  rows, 28,436,480 nonzeros at uniform sorted rows, ``block_m`` 256);
* K7 on the Chicago-crime-comm shape's mode 0 (the repository's seeded
  ``blocked_tensor``, 1024 partitions), under ALTO-OTF and ALTO-PRE;
* K5 under ALTO-OTF on the same tensor's modes 1-3 (``block_m`` 64).

Prints the card's name and power limit and one JSON line; writes
``chiprun_out/phi_lane_maps.json``. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAPS = ((16, 1), (8, 2), (4, 4), (2, 8), (1, 16))
SHIPPED = "if (R <= 16) return L<4, 4>::run(args);"
R = 16


def _build_maps(_build):
    out = ROOT / "build" / "lane_maps"
    procs = {}
    for w, cols in MAPS:
        d = out / f"{w}x{cols}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        src = d / "phi_scan.cuh"
        text = src.read_text()
        if SHIPPED not in text:
            raise SystemExit("phi_dispatch no longer has the rank-16 line")
        src.write_text(text.replace(
            SHIPPED, f"if (R <= 16) return L<{w}, {cols}>::run(args);"))
        for lib in ("phi_oriented", "cpapr_phi"):
            procs[(w, cols, lib)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                 str(d / f"{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (w, cols, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {w}x{cols} {lib}:\n{log}")
        handle = ctypes.CDLL(str(out / f"{w}x{cols}" / f"{lib}.so"))
        for fn, sig in _build.SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = sig
            getattr(handle, fn).restype = ctypes.c_int
        libs[(w, cols, lib)] = handle
    return libs


def _ms(torch, fn) -> float:
    for _ in range(2):
        if fn() != 0:
            raise SystemExit("a kernel launch failed")
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_phi_lane_maps: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import alto, encoding
    from repro_torch.core import mttkrp as core_mttkrp
    from repro_torch.kernels import _build, common, ops
    from repro_torch.kernels import cpapr_phi as k7
    from repro_torch.sparse import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = _build_maps(_build)
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    res = {"card": card, "rank": R, "maps": [f"{w}x{c}" for w, c in MAPS],
           "k5_darpa_mode2_pre": {}, "k7_chicago_mode0_otf": {},
           "k7_chicago_mode0_pre": {}, "k5_chicago_otf_modes_1_3": {}}

    # K5 under PRE on a DARPA-mode-2-shaped stream.
    dims = (22476, 22476, 23_776_223)
    I_n, M, bm = dims[2], 28_436_480, 256
    enc = encoding.make_encoding(dims)
    rows = torch.randint(0, I_n, (M,), device=dev, generator=g).sort(
        ).values.to(torch.int32)
    words = torch.zeros((M, enc.n_words), dtype=torch.int32, device=dev)
    values = torch.rand(M, device=dev, generator=g)
    pi = torch.rand((M, R), device=dev, generator=g)
    B = torch.rand((I_n, R), device=dev, generator=g)
    nb = M // bm
    out = torch.zeros((I_n, R), device=dev)
    crow = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    cval = torch.empty((nb, 2, R), device=dev)
    keep, args = common.alto_args(enc, 2, None, R)
    table = common.decode_table(enc, dev).data_ptr()
    for w, cols in MAPS:
        lib = libs[(w, cols, "phi_oriented")]
        res["k5_darpa_mode2_pre"][f"{w}x{cols}"] = _ms(
            torch, lambda: lib.alto_phi_carry_runs(
                *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
                B.data_ptr(), pi.data_ptr(), 1e-10, table, bm, nb, 128,
                out.data_ptr(), crow.data_ptr(), cval.data_ptr(), stream))
    del keep, rows, words, values, pi, B, out, crow, cval

    # K7 and K5 under OTF on the Chicago shape.
    x = synthetic.blocked_tensor((6186, 24, 77, 32), 5_330_673, block=16,
                                 n_blocks=512, seed=0, count_data=True)
    at = alto.build_device(x, n_partitions=1024)
    meta = at.meta
    T, L, Mp = meta.temp_rows[0], meta.n_partitions, at.words.shape[0]
    fs = [torch.rand((I, R), device=dev, generator=g) + 0.05
          for I in meta.dims]
    B = torch.rand((meta.dims[0], R), device=dev, generator=g)
    pi = core_mttkrp.krp_rows(ops.delinearize(meta.enc, at.words), fs,
                              0).contiguous()
    temp = torch.empty((L, T, R), device=dev)
    table = common.decode_table(meta.enc, dev).data_ptr()
    for policy in ("otf", "pre"):
        keep, args = common.alto_args(meta.enc, 0,
                                      fs if policy == "otf" else None, R)
        for w, cols in MAPS:
            lib = libs[(w, cols, "cpapr_phi")]
            res[f"k7_chicago_mode0_{policy}"][f"{w}x{cols}"] = _ms(
                torch, lambda: lib.alto_phi_partials(
                    *args, at.words.data_ptr(), at.values.data_ptr(),
                    at.part_start.data_ptr(), B.data_ptr(),
                    None if policy == "otf" else pi.data_ptr(), 1e-10, table,
                    L, Mp // L, T, meta.dims[0], T, k7.tile_nnz(R), 128,
                    temp.data_ptr(), stream))
    for w, cols in MAPS:
        total = 0.0
        for mode in (1, 2, 3):
            view = alto.oriented_view_device(at, mode)
            rows, words, values, _ = ops.pad_sorted_stream(
                view.rows, view.words, view.values, 64)
            nb = rows.shape[0] // 64
            Bm = torch.rand((meta.dims[mode], R), device=dev, generator=g)
            out = torch.zeros((meta.dims[mode], R), device=dev)
            crow = torch.empty((nb, 2), dtype=torch.int32, device=dev)
            cval = torch.empty((nb, 2, R), device=dev)
            keep, args = common.alto_args(meta.enc, mode, fs, R)
            lib = libs[(w, cols, "phi_oriented")]
            total += _ms(torch, lambda: lib.alto_phi_carry_runs(
                *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
                Bm.data_ptr(), None, 1e-10, table, 64, nb, 128,
                out.data_ptr(), crow.data_ptr(), cval.data_ptr(), stream))
        res["k5_chicago_otf_modes_1_3"][f"{w}x{cols}"] = total
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phi_lane_maps.json").write_text(json.dumps(res, indent=1))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
