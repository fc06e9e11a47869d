"""The port's training launcher on the CPU: cut and resumed runs, either
launcher resuming the other's checkpoint, and the CPD workload."""
import argparse
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import train as jtrain
from repro.train import steps as jsteps
from repro_torch.dist.cpd import distributed_cp_als
from repro_torch.launch import train as ttrain
from repro_torch.sparse import synthetic

LOSS_REL = 1e-5     # a continuation's losses against the other package's
ARCH = "smollm-360m"


def _port_args(ckpt_dir="", **over):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--log-every", "1", "--lr", "1e-3",
            "--warmup", "2"]
    if ckpt_dir:
        argv += ["--ckpt-dir", str(ckpt_dir)]
    args = ttrain.parser().parse_args(argv)
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _jax_args(ckpt_dir="", steps=4):
    return argparse.Namespace(
        arch=ARCH, reduced=True, reduced_repeats=2, mesh="host", steps=steps,
        batch=4, seq=16, lr=1e-3, warmup=2, seed=0, grad_accum=0,
        compression="", ckpt_dir=str(ckpt_dir), ckpt_every=50, log_every=1)


def _jax_losses(monkeypatch, args) -> list[float]:
    """Run the JAX launcher, recording each step's loss from inside its
    jitted step."""
    losses = []

    def recording(cfg, opt, **kw):
        step = jsteps.make_train_step(cfg, opt, **kw)

        def wrapped(params, state, batch):
            out = step(params, state, batch)
            jax.debug.callback(lambda x: losses.append(float(x)),
                               out[2]["loss"])
            return out
        return wrapped

    with monkeypatch.context() as mp:
        mp.setattr(jtrain, "make_train_step", recording)
        jtrain.train_lm(args)
        jax.effects_barrier()
    return losses


def _params(run):
    return [p.detach().clone() for p in run.model.parameters()]


@pytest.mark.parametrize("compression", ["", "int8_ef"])
def test_cut_and_resumed_equals_uninterrupted(tmp_path, compression):
    """A run cut after its periodic checkpoint (the later ones deleted)
    and resumed, and a run of 2 steps continued to 4 on the same
    directory, both equal the uninterrupted run bit for bit: losses,
    parameters, optimizer state (and the int8 error state)."""
    full = ttrain.train_lm(_port_args(steps=4, compression=compression))
    d = tmp_path / "periodic"
    ttrain.train_lm(_port_args(d, steps=4, ckpt_every=2,
                               compression=compression))
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    shutil.rmtree(d / "step_00000004")
    resumed = ttrain.train_lm(_port_args(d, steps=4, ckpt_every=2,
                                         compression=compression))
    d2 = tmp_path / "continued"
    ttrain.train_lm(_port_args(d2, steps=2, compression=compression))
    continued = ttrain.train_lm(_port_args(d2, steps=4,
                                           compression=compression))
    for run in (resumed, continued):
        assert [h["step"] for h in run.history] == [2, 3]
        assert run.history == full.history[2:]
        for a, b in zip(_params(run), _params(full)):
            assert torch.equal(a, b)
        assert run.optimizer.count == full.optimizer.count == 4
        for ga, gb in zip(run.optimizer.param_groups,
                          full.optimizer.param_groups):
            assert torch.equal(ga["m"], gb["m"]) and \
                torch.equal(ga["v"], gb["v"])
        if compression:
            for a, b in zip(run.compress_state, full.compress_state):
                assert torch.equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX launcher's checkpoint after 2 steps, continued by the port
    to 4: its losses hold the JAX launcher's uninterrupted run."""
    want = _jax_losses(monkeypatch, _jax_args(steps=4))
    jtrain.train_lm(_jax_args(tmp_path, steps=2))
    run = ttrain.train_lm(_port_args(tmp_path, steps=4))
    assert [h["step"] for h in run.history] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in run.history], want[2:],
                               rtol=LOSS_REL)


def test_port_checkpoint_resumes_in_jax(tmp_path, monkeypatch):
    """The port's checkpoint after 2 steps, continued by the JAX launcher
    to 4: its losses hold the port's uninterrupted run."""
    want = [h["loss"] for h in
            ttrain.train_lm(_port_args(steps=4)).history]
    ttrain.train_lm(_port_args(tmp_path, steps=2))
    got = _jax_losses(monkeypatch, _jax_args(tmp_path, steps=4))
    np.testing.assert_allclose(got, want[2:], rtol=LOSS_REL)


def test_jax_periodic_checkpoint_resumes_at_its_cursor(tmp_path,
                                                       monkeypatch):
    """The JAX launcher names a periodic checkpoint one update early
    (``step_2`` holds 3 updates and the data cursor 3); the port resumes
    at the cursor, so its one remaining step is JAX's step 3."""
    want = _jax_losses(monkeypatch, _jax_args(steps=4))
    args = _jax_args(tmp_path, steps=4)
    args.ckpt_every = 2
    jtrain.train_lm(args)
    shutil.rmtree(tmp_path / "step_00000004")
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["data_step"] == 3
    run = ttrain.train_lm(_port_args(tmp_path, steps=4))
    assert [h["step"] for h in run.history] == [3]
    np.testing.assert_allclose(run.history[0]["loss"], want[3],
                               rtol=LOSS_REL)


def test_mesh_other_than_host_raises():
    """Without a launched world (no process group, no ``WORLD_SIZE``) the
    production meshes raise."""
    for mesh in ("pod", "multipod"):
        with pytest.raises(ValueError, match="launched world"):
            ttrain.train_lm(_port_args(mesh=mesh, steps=1))


_MESH_STEP = r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch import train as T
from repro_torch.launch.dryrun import fake_world
args = T.parser().parse_args(["--arch", "smollm-360m", "--reduced",
    "--device", "cpu", "--batch", "16", "--seq", "8", "--steps", "1",
    "--mesh", sys.argv[1], "--log-every", "1"])
out = {}
fake_world(int(sys.argv[2]))
try:
    run = T.train_lm(args)
    p = run.model.embed.tokens
    out["steps"] = [h["step"] for h in run.history]
    out["param"] = [type(p).__name__, list(p.shape),
                    list(p.to_local().shape)]
    g = run.optimizer.param_groups[0]
    out["state"] = [type(g["m"]).__name__, list(g["m"].to_local().shape)]
except ValueError as e:
    out["raised"] = str(e)
print("RESULT" + json.dumps(out))
"""


def _mesh_step(mesh: str, world: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.environ.get("PYTHONPATH", "src"))
    r = subprocess.run([sys.executable, "-c", _MESH_STEP, mesh, str(world)],
                       capture_output=True, text=True, env=env, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert r.returncode == 0 and lines, r.stdout + r.stderr
    return json.loads(lines[-1][len("RESULT"):])


def test_mesh_pod_takes_a_step_on_a_fake_world():
    """``--mesh pod`` on a fake process group of 256 ranks (its
    collectives return at once, without data): one step over the
    sharded parameters, optimizer state and batch; the values are not
    checked, only that the step runs on the shards."""
    out = _mesh_step("pod", 256)
    assert out["steps"] == [0]
    # embed (vocab 128 over model 16, d 64 over data 16)
    assert out["param"] == ["DTensor", [128, 64], [8, 4]]
    assert out["state"][0] == "DTensor"


@pytest.mark.parametrize("mesh,world", [("pod", 4), ("pod", 512),
                                        ("multipod", 256)])
def test_mesh_on_a_world_of_another_size_raises(mesh, world):
    out = _mesh_step(mesh, world)
    assert "needs a world of" in out["raised"]


def test_train_cpd_equals_distributed_cp_als(tmp_path):
    """`train_cpd` makes a one-rank gloo group on the CPU and gives the
    fits of `distributed_cp_als` called directly on the same tensor."""
    args = ttrain.parser().parse_args([
        "--workload", "cpd", "--device", "cpu", "--dims", "30,24,20",
        "--nnz", "3000", "--rank", "4", "--iters", "6", "--seed", "3"])
    assert not dist.is_initialized()
    _, _, fits = ttrain.train_cpd(args)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        x = synthetic.zipf_tensor((30, 24, 20), 3000, seed=3)
        _, _, want = distributed_cp_als(x, rank=4, n_iters=6, seed=3,
                                        device="cpu")
    finally:
        dist.destroy_process_group()
    assert fits == want
    assert all(np.isfinite(fits))
