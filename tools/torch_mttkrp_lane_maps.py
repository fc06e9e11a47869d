#!/usr/bin/env python3
"""Time the port's redesigned K1 runs pass under several lane maps at rank
16, on one CUDA card.

    python3 tools/torch_mttkrp_lane_maps.py

A lane map is (W, COLS): a sub-warp of W lanes per block_m slice, COLS
rank columns per lane (`LANE_MAPS` in
``src/repro_torch/kernels/mttkrp_oriented.py``, dispatched by
`launch_mttkrp_carry_runs` in ``csrc/mttkrp_oriented.cu``), with 1, 2
or 4 nonzeros in flight per sub-warp (`K1_UNROLL` in
``csrc/alto_scan.cuh``). The script copies the kernel sources once per
unroll, adds the candidate maps to the dispatch, builds
``mttkrp_oriented.cu`` with the repository's nvcc flags into
``build/mttkrp_lane_maps/``, and times with CUDA events (median of 10
after 2 warm-ups) the bare C entry `alto_carry_runs` under each map and
unroll at the plan's tiles on:

* mode 2 of the 1998 DARPA shape (22,476 × 22,476 × 23,776,223, 28.4 M
  nonzeros from the repository's seeded ``uniform_tensor``, ``block_m``
  256);
* modes 1-3 of the Chicago-crime-comm shape (6,186 × 24 × 77 × 32, the
  seeded ``blocked_tensor``, 4.86 M nonzeros, ``block_m`` 64).

Prints the card's name and power limit and one JSON line; writes
``chiprun_out/mttkrp_lane_maps.json``. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAPS = ((16, 1), (8, 2), (4, 4), (2, 8), (1, 16))
R = 16


VARIANTS = {"u1": 1, "u2": 2, "u4": 4}     # nonzeros in flight (K1_UNROLL)
SHIPPED = re.compile(r"constexpr int K1_UNROLL = \d+;")


def _build_maps(build):
    """One library per unroll, each with every candidate map."""
    procs = {}
    for variant, unroll in VARIANTS.items():
        d = ROOT / "build" / "mttkrp_lane_maps" / variant
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        scan = d / "alto_scan.cuh"
        text = scan.read_text()
        if not SHIPPED.search(text):
            raise SystemExit("alto_scan.cuh has no K1_UNROLL line")
        scan.write_text(SHIPPED.sub(f"constexpr int K1_UNROLL = {unroll};",
                                    text))
        src = d / "mttkrp_oriented.cu"
        text = src.read_text()
        shipped = re.findall(r"  if \(lanes == \d+ && cols == \d+\) return "
                             r"MttkrpCarryRunsLaunch<\d+, \d+>::run\(p\);"
                             r"\n", text)
        if not shipped:
            raise SystemExit("launch_mttkrp_carry_runs has no lane-map lines")
        lines = "".join(
            f"  if (lanes == {w} && cols == {c}) return "
            f"MttkrpCarryRunsLaunch<{w}, {c}>::run(p);\n" for w, c in MAPS)
        src.write_text(text.replace(shipped[0], lines + shipped[0]))
        procs[variant] = (d / "mttkrp_oriented.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "mttkrp_oriented.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {variant}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn, sig in build.SIGNATURES["mttkrp_oriented"].items():
            getattr(handle, fn).argtypes = sig
            getattr(handle, fn).restype = ctypes.c_int
        libs[variant] = handle
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
        print("torch_mttkrp_lane_maps: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import alto, plan
    from repro_torch.kernels import _build, common, ops
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
    res = {"card": card, "rank": R,
           "maps": [f"{v}:{w}x{c}" for v in VARIANTS for w, c in MAPS]}

    def time_modes(at, modes, key):
        p = plan.plan_for(at, R)
        fs = [torch.rand((I, R), device=dev, generator=g) + 0.05
              for I in at.dims]
        table = common.decode_table(at.meta.enc, dev).data_ptr()
        for n in modes:
            mp = p.modes[n]
            view = alto.oriented_view_device(at, n)
            rows, words, values, _ = ops.pad_sorted_stream(
                view.rows, view.words, view.values, mp.block_m)
            nb = rows.shape[0] // mp.block_m
            out = torch.empty((at.dims[n], R), device=dev)
            crow = torch.empty((nb, 2), dtype=torch.int32, device=dev)
            cval = torch.empty((nb, 2, R), device=dev)
            keep, args = common.alto_args(at.meta.enc, n, fs, R)
            per = res.setdefault(f"{key}_mode{n}", {})
            for lay, lib in libs.items():
                for w, c in MAPS:
                    per[f"{lay}:{w}x{c}"] = _ms(
                        torch, lambda: lib.alto_carry_runs(
                            *args, rows.data_ptr(), words.data_ptr(),
                            values.data_ptr(), table, mp.block_m, nb,
                            mp.r_block, w, c, mp.threads, at.dims[n],
                            out.data_ptr(), crow.data_ptr(),
                            cval.data_ptr(), stream))
            del keep

    x = synthetic.blocked_tensor((6186, 24, 77, 32), 5_330_673, block=16,
                                 n_blocks=512, seed=0, count_data=True)
    time_modes(alto.build_device(x, n_partitions=1024), (1, 2, 3),
               "k1_chicago")
    res["k1_chicago_modes_1_3"] = {
        k: sum(res[f"k1_chicago_mode{n}"][k] for n in (1, 2, 3))
        for k in res["k1_chicago_mode1"]}
    del x
    x = synthetic.uniform_tensor((22476, 22476, 23_776_223), 28_436_033,
                                 seed=0, count_data=True)
    time_modes(alto.build_device(x, n_partitions=1024), (2,), "k1_darpa")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mttkrp_lane_maps.json").write_text(json.dumps(res,
                                                              indent=1))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
