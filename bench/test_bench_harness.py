"""The harness on the CPU: cells, configurations and metrics found by
name, traced runs that fail loudly, the import guard, the refusal without
a card, and BENCHMARK.json against the files it names."""
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import harness
from bench import tracing

BENCH = pathlib.Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
SRC = ROOT / "src"


def _run(cell, trace=False, seconds=0.2, seed=2**31 + 3):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


def _python(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    copy = tmp_path / "bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    (copy / "configs" / "throwaway.json").write_text(json.dumps({
        "name": "throwaway", "dims": [20, 9, 30], "nnz": 300, "rank": 4,
        "n_partitions": 4, "generator": {"kind": "uniform", "count_max": 9},
        "reduced": []}))
    (copy / "workloads" / "throwaway.cp_als.json").write_text(json.dumps({
        "config": "throwaway", "traffic": "cp_als", "chips": 1,
        "why": "a throwaway", "check_solves": 1,
        "limits": {"fit_gap": 1e-6, "factor_gap": 1e-3, "lam_gap": 1e-3}}))
    (copy / "metrics" / "throwaway_iterations.py").write_text(
        'UNIT = "1"\n\n\ndef read(reading):\n    return reading.iterations\n')
    code = (f"import sys, json, time\n"
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(SRC)!r}]\n"
            f"from bench import harness\n"
            f"assert harness.BENCH == __import__('pathlib').Path("
            f"{str(copy)!r}).resolve()\n"
            f"out = harness.run_cell(harness.load_cell('throwaway.cp_als'), "
            f"11, 0.2, True, 'cpu', time.perf_counter())\n"
            f"print(json.dumps(out))\n")
    proc = _python(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["throwaway_iterations"]["value"] % 25 == 0
    assert out["metrics"]["throwaway_iterations"]["unit"] == "1"
    after = _digests(copy)
    assert {k: after[k] for k in before} == before


def test_unknown_cell_names_the_missing_file():
    with pytest.raises(harness.RunError, match="no workloads file"):
        harness.load_cell("no-such-cell")


def test_traced_run_reads_layers(small_cell):
    out = _run(small_cell("chicago-crime-comm.cp_als"), trace=True)
    assert out["correct"] is True
    assert {"build_s", "views_s"} <= set(out["metrics"])
    # No device work on the CPU: no device metric is read, none reads 0.
    assert "mttkrp_ms" not in out["metrics"]
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert list(out)[-1] == "checks"


def test_traced_run_with_a_missing_entry_fails(small_cell, monkeypatch):
    # As after a rename in the port: the solve runs, the span has no entry.
    cell = small_cell("darpa1998.cp_als")
    monkeypatch.setattr(cell.solver, "SPANS", {
        "bench.mttkrp": ("repro_torch.core.cpals", "mttkrp_renamed")})
    with pytest.raises(tracing.TraceError,
                       match=r"repro_torch\.core\.cpals\.mttkrp_renamed is "
                             "missing"):
        _run(cell, trace=True)


def test_traced_run_with_an_uncalled_entry_fails(small_cell, monkeypatch):
    cell = small_cell("darpa1998.cp_als")
    monkeypatch.setattr(cell.solver, "SPANS", {
        **cell.solver.SPANS,
        "bench.phi": ("repro_torch.core.plan", "execute_phi")})
    with pytest.raises(tracing.TraceError,
                       match=r"execute_phi was never called"):
        _run(cell, trace=True)


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    code = (f"import sys, time\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            f"from bench import harness, calibrate, generators, roofline\n"
            f"from bench.reference import cpd, compare\n"
            f"harness.metric_readers()\n"
            f"for name in ('darpa1998.cp_als', 'chicago-crime-comm.cp_apr'):\n"
            f"    cell = harness.load_cell(name)\n"
            f"    cell.config.update(dims=[20, 9, 30], nnz=200, "
            f"n_partitions=4, generator={{'kind': 'uniform'}})\n"
            f"    harness.run_cell(cell, 3, 0.1, False, 'cpu', "
            f"time.perf_counter())\n"
            f"assert 'repro_torch.core.cpals' in sys.modules\n"
            f"print(harness.forbidden_modules())\n")
    proc = _python(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_report_refuses_when_jax_is_loaded(tmp_path):
    code = (f"import sys, types\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            f"from bench import harness\n"
            f"out = {{'correct': True, 'checks': {{}}}}\n"
            f"for name in ('jaxtyping', 'reproduce', 'repro_torch.x'):\n"
            f"    sys.modules[name] = types.ModuleType(name)\n"
            f"assert harness.forbidden_modules() == []\n"
            f"sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
            f"sys.exit(harness.report(out))\n")
    proc = _python(code, tmp_path)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "repro.core" in proc.stderr


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cell would run")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "darpa1998.cp_als", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_benchmark_json_matches_the_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["bench"]
    assert bench["command"] == ["python3", "bench/run.py"]
    readers = harness.metric_readers()
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    reported = {}
    for name, w in cells.items():
        cell = harness.load_cell(name)
        assert (cell.spec["config"], cell.spec["traffic"]) == \
            (w["config"], w["traffic"])
        assert (cell.spec["chips"], cell.spec["why"]) == (w["chips"],
                                                          w["why"])
        cfg = configs[w["config"]]
        assert ROOT / cfg["file"] == BENCH / "configs" / f"{w['config']}.json"
        assert cfg["reduced"] == cell.config["reduced"]
        assert cfg["source"] == cell.config["source"]
        reported[name] = cell.solver.METRIC
    for m in bench["end_to_end"]:
        assert m["name"] == "setup_s" or m["name"] in reported.values()
        assert set(m.get("workloads", cells)) == {
            n for n in cells if m["name"] in ("setup_s", reported[n])}
    for m in bench["per_layer"]:
        assert m["name"] in readers
        assert readers[m["name"]].UNIT == m["unit"]
        for n in m["workloads"]:
            assert reported[n] == m["moves"] or m["moves"] == "setup_s"
