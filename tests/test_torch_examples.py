"""The port's CPD examples (``examples/torch_*.py``) run on the CPU at
small sizes as subprocesses and exit 0 (one CPU thread each, so their
sums are repeatable).

* quickstart and the CP-APR anomaly example (with its closing assert);
* the end-to-end example cut after its first checkpoint and resumed ends
  with the factors and fits of an uninterrupted run, bit for bit;
* the distributed example as one rank (started without torchrun) and as
  two gloo ranks under torchrun.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.core import cpals

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _run(args, cwd=ROOT) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return r.stdout


def test_quickstart():
    out = _run(["examples/torch_quickstart.py", "--device", "cpu",
                "--dims", "40,30,20,16", "--nnz", "3000", "--iters", "8"])
    fit = float(re.search(r"CP-ALS: 8 iters, fit ([-\d.]+)", out).group(1))
    assert 0.0 < fit <= 1.0
    assert out.count("traversal = ") == 4


def test_cp_apr_anomaly():
    out = _run(["examples/torch_cp_apr_anomaly.py", "--device", "cpu",
                "--nnz", "4000", "--k-max", "10"])
    assert "captures the injected scanner" in out


def _e2e(ckpt, iters) -> str:
    return _run(["examples/torch_decompose_e2e.py", "--device", "cpu",
                 "--nnz", "4000", "--rank", "6", "--iters", str(iters),
                 "--ckpt-dir", str(ckpt)])


def test_decompose_e2e_resume_is_bitwise(tmp_path):
    cut, whole = tmp_path / "cut", tmp_path / "whole"
    out = _e2e(cut, 5)
    assert "resumed" not in out and ck.latest_step(str(cut)) == 5
    out = _e2e(cut, 15)
    assert "resumed from iteration 5" in out
    assert "resumed" not in _e2e(whole, 15)
    like = cpals.init_factors((4096, 2048, 1024, 64), 6, device="cpu")
    got, m_cut = ck.restore(str(cut), 15, like, device="cpu")
    ref, m_whole = ck.restore(str(whole), 15, like, device="cpu")
    assert len(m_cut["extra"]["fits"]) == 15
    assert m_cut["extra"]["fits"] == m_whole["extra"]["fits"]
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert np.isfinite(m_cut["extra"]["fits"]).all()


def _fits(out: str) -> list[str]:
    return re.findall(r"iter \d+: fit ([-\d.]+)", out)


@pytest.mark.parametrize("world", [1, 2])
def test_distributed_cpd(world):
    args = ["examples/torch_distributed_cpd.py", "--device", "cpu",
            "--nnz", "20000", "--iters", "4"]
    if world == 2:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node=2", *args]
    out = _run(args)
    assert f"{world} rank(s) over gloo" in out
    assert len(_fits(out)) == 4
    assert "distributed decomposition complete" in out
