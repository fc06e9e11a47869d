"""Print the port's dry-run cells as a markdown table (model figures).

    PYTHONPATH=src python tools/torch_dryrun_table.py [DIR]

Reads the JSON files `python -m repro_torch.launch.dryrun` wrote (DIR,
default ``experiments/dryrun_torch``). One row an (architecture, shape):
its status, per-device argument GB, the three roofline terms in ms under
the H100 constants (`repro_torch.launch.roofline`) and the bottleneck,
each as ``16x16 / 2x16x16``; an error names the op that stopped the
cell; skipped cells are counted below the table.
"""
from __future__ import annotations

import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ms(x: float) -> str:
    return f"{x * 1e3:.3g}"


def rows(out_dir: pathlib.Path) -> list[str]:
    cells = collections.defaultdict(dict)
    skipped = []
    for path in sorted(out_dir.glob("*.json")):
        r = json.loads(path.read_text())
        if r["status"] == "skipped":
            skipped.append(f"{r['arch']} {r['shape']}")
            continue
        cells[(r["arch"], r["shape"])][r["chips"]] = r
    out = ["| arch | shape | status | args GB/dev | compute ms | memory ms |"
           " collective ms | bottleneck |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), by in sorted(cells.items()):
        pair = [by.get(256), by.get(512)]
        status = " / ".join(r["status"] if r else "missing" for r in pair)
        if any(r is None or r["status"] != "ok" for r in pair):
            errs = [f"{r['error']['type']} at {r['error']['at'][-1]}"
                    for r in pair if r and r["status"] == "error"]
            out.append(f"| {arch} | {shape} | {status} | | | | | "
                       f"{'; '.join(errs)} |")
            continue
        t = [r["roofline"] for r in pair]

        def both(fn):
            return " / ".join(fn(x) for x in t)
        args = " / ".join(f"{r['memory']['argument_bytes'] / 1e9:.3g}"
                          for r in pair)
        out.append(f"| {arch} | {shape} | {status} | {args} | "
                   f"{both(lambda x: _ms(x['t_compute']))} | "
                   f"{both(lambda x: _ms(x['t_memory']))} | "
                   f"{both(lambda x: _ms(x['t_collective']))} | "
                   f"{both(lambda x: x['bottleneck'])} |")
    out.append("")
    names = sorted(set(skipped))
    out.append(f"Skipped on both meshes ({len(names)}, not admitted by "
               "`shapes_for`): " + ", ".join(names) + ".")
    return out


if __name__ == "__main__":
    d = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "experiments" / "dryrun_torch"
    print("\n".join(rows(d)))
