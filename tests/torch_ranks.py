"""gloo ranks on the CPU for the port's distributed tests (not collected).

`run` starts ``world`` processes with the ``spawn`` start method, joins
them in a `torch.distributed` gloo group through a file rendezvous in a
directory of the test's own (``pytest -n`` runs tests side by side, so a
fixed TCP port would collide), calls a job of this module on every rank
and returns each rank's result. A rank that fails or outlives the join
timeout fails the test, and every rank is stopped.

The jobs import only torch and the port: the ranks never import JAX.
"""
from __future__ import annotations

import multiprocessing
import pathlib
import time
import traceback

import torch


def _rank_main(job, rank, world, rdv, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)      # CPU sums in index order on every rank
    out = pathlib.Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                world_size=world, rank=rank)
        try:
            result = globals()[job](rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run(job: str, world: int, tmp_path, *args, timeout: float = 120.0):
    """``job(rank, world, *args)`` on ``world`` gloo ranks; the results in
    rank order. Raises when a rank fails or the ranks outlive
    ``timeout`` seconds."""
    tmp = pathlib.Path(tmp_path) / f"{job}-{world}"
    tmp.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, world, str(tmp / "rendezvous"),
                               str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"{job} on {world} ranks: ranks {hung} still "
                               f"running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = {r: (tmp / f"rank{r}.err").read_text()
              for r in range(world) if (tmp / f"rank{r}.err").exists()}
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if errors or bad:
        raise RuntimeError(f"{job} on {world} ranks: ranks {bad} exited "
                           f"non-zero\n" + "\n".join(errors.values()))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Jobs (run on every rank)
# ---------------------------------------------------------------------------

ALS_DIMS = (30, 40, 25)
APR_DIMS = (14, 9, 6)
RANK = 4


def als_tensor():
    """The CP-ALS problem of the distributed tests, built on the CPU."""
    from repro_torch.core import alto
    from repro_torch.sparse import synthetic
    x, _ = synthetic.sparse_lowrank(ALS_DIMS, rank=RANK, col_support=0.3,
                                    seed=2)
    return alto.build_device(x, n_partitions=8, device="cpu")


def apr_tensor():
    from repro_torch.core import alto
    from repro_torch.sparse import synthetic
    x = synthetic.uniform_tensor(APR_DIMS, 250, seed=4, count_data=True)
    return alto.build_device(x, n_partitions=2, device="cpu")


def in_process_sum(p, at, factors):
    """Per mode, the sum in rank order of `local_mttkrp` over the slices
    of every rank, all computed in this process."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.dist import cpd
    from repro_torch.kernels import ops
    views = plan_mod.build_views(at, p)
    out = []
    for n, v in views.items():
        rows, words, values, _ = ops.pad_sorted_stream(
            v.rows, v.words, v.values, cpd._shard_mult(p, n))
        acc = None
        for r in range(p.shards):
            sl = cpd._slice(rows.shape[0], p.shards, r)
            part = cpd.local_mttkrp(p, n, rows[sl], words[sl], values[sl],
                                    factors)
            acc = part if acc is None else acc + part
        out.append(acc)
    return out


def job_cpd(rank, world, als_start, apr_state, deltas):
    """Every distributed path on one group: the MTTKRP of each mode
    against the in-process sum, CP-ALS, CP-APR under both Π policies,
    sharded appends and a group of the wrong size."""
    from repro_torch.core import cpals, cpapr, ingest
    from repro_torch.core import plan as plan_mod
    from repro_torch.dist import cpd
    out = {}
    at = als_tensor()
    fs = [torch.from_numpy(A) for A in als_start]
    sp = plan_mod.make_plan(at.meta, RANK, backend="cuda", shards=world)
    views = plan_mod.build_views(at, sp)
    out["mttkrp"] = [plan_mod.execute_mttkrp(sp, at, views, fs, n)
                     for n in range(len(at.dims))]
    out["mttkrp_in_process"] = in_process_sum(sp, at, fs)
    lam, factors, fits = cpd.distributed_cp_als(
        at, RANK, n_iters=4, tol=0.0, factors=fs, backend="cuda",
        device="cpu")
    out["fits"], out["factors"], out["lam"] = fits, factors, lam
    if world == 1:
        single = plan_mod.ExecutionPlan(**{**vars(sp), "shards": None})
        ref = cpals.cp_als(at, RANK, n_iters=4, tol=0.0, factors=fs,
                           plan=single)
        out["single"] = (ref.fits, ref.factors, ref.lam)

    apr_at = apr_tensor()
    lam0, fs0 = apr_state
    ap = plan_mod.make_plan(apr_at.meta, RANK, backend="cuda", shards=world)
    for policy in ("otf", "pre"):
        res = cpapr.cp_apr(
            apr_at, RANK, cpapr.CpaprParams(k_max=3), pi_policy=policy,
            track_ll=True, plan=ap,
            warm_start=(torch.from_numpy(lam0),
                        [torch.from_numpy(A) for A in fs0]))
        out[f"apr_{policy}"] = (res.log_likelihoods, res.kkt_violations)

    appends = []
    for coords, values in deltas:
        got = cpd.sharded_append_delta(at, coords, values)
        ref = ingest.append_delta(at, coords, values)
        appends.append((len(coords), torch.equal(got.words, ref.words)
                        and torch.equal(got.values, ref.values)
                        and torch.equal(got.part_start, ref.part_start)
                        and torch.equal(got.part_end, ref.part_end)
                        and got.meta == ref.meta))
    out["appends"] = appends

    wrong = plan_mod.make_plan(at.meta, RANK, backend="cuda",
                               shards=world + 1)
    try:
        plan_mod.execute_mttkrp(wrong, at, views, fs, 0)
        out["wrong_group"] = None
    except ValueError as e:
        out["wrong_group"] = str(e)
    return out


def job_tune(rank, world, store):
    """A sharded tune on every rank: the plan each rank gets, the store
    writes each rank made, and a second make's timing runs (a store
    hit)."""
    from repro_torch.core import autotune
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import ops
    writes = []
    save = autotune.save_store

    def counted(plans, path=None):
        writes.append(1)
        return save(plans, path)

    autotune.save_store = counted
    at = als_tensor()
    p = plan_mod.make_plan(at.meta, RANK, backend="cuda", shards=world,
                           tune="force", at=at, store_path=store)
    runs = ops.timing_runs()
    again = plan_mod.make_plan(at.meta, RANK, backend="cuda", shards=world,
                               tune="force", at=at, store_path=store)
    return {"modes": p.modes, "shards": p.shards, "writes": len(writes),
            "again_runs": ops.timing_runs() - runs,
            "again_same": again == p}


def job_pipeline(rank, world, cfg, tree, tokens, n_micro):
    """`pipeline_loss` on every rank (the model carried in from the JAX
    tree), ``loss.backward()``, and this rank's logits, loss and
    gradients: its stage's layers, and on rank 0 the shared parameters."""
    from repro_torch import interop
    from repro_torch.dist import pipeline as PP
    model = interop.lm_params(cfg, tree, device="cpu")
    model.requires_grad_(True)
    pp = PP.to_pipeline_params(cfg, model, world)
    toks = torch.from_numpy(tokens)
    stats = PP.PipeStats()
    loss = PP.pipeline_loss(cfg, pp, {"tokens": toks, "labels": toks},
                            n_micro, stats=stats)
    logits = PP.pipeline_forward(cfg, pp, toks, n_micro)
    loss.backward()
    own = {id(p) for p in pp.stages[rank].parameters()}
    grads = {name: p.grad.clone() for name, p in model.named_parameters()
             if id(p) in own or (rank == 0 and not name.startswith(
                 "layers."))}
    return {"logits": logits.detach(), "loss": loss.detach(),
            "grads": grads, "sends": stats.sends, "recvs": stats.recvs,
            "staged": stats.staged_bytes}
