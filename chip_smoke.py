#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS and CP-APR paths, in core and out of
core, and its LM stack's serving path, on one CUDA card and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), then:

1. holds every kernel against its plain PyTorch version on small
   adversarial run layouts at ranks 5, 16 and 40, each with the whole rank
   and a smaller rank tile: tolerance ``rtol=1e-5, atol=1e-6·max|plain|``,
   K1 (carry) equal to K2 + segment_merge (``torch.equal``), K1, K2 and
   K3 (recursive) bit for bit to their plain versions run on CPU copies
   with one CPU thread, every row of K1's output written (run into a
   NaN-filled buffer it equals the normal run; the runs pass leaves
   exactly the carried rows to the fix-up), K2 into NaN-filled slots
   equal to the normal run, the split of segment_merge equal to
   ``split_block_runs`` (carries, and out off the carried rows, which it
   leaves NaN in a NaN-filled out; split + fix-up equal), K3 into a
   NaN-filled Temp and in Temp windows of 1 and 3 rows equal to K3 in one
   window, and equal bits on a second run;
2. decomposes the Chicago-crime-comm shape (6,186 × 24 × 77 × 32, 4.86 M
   nonzeros from the repo's seeded ``blocked_tensor`` recipe) with
   ``build_device(n_partitions=1024)`` and 10 CP-ALS iterations at rank 16;
3. decomposes the 1998 DARPA shape (22,476 × 22,476 × 23,776,223, 28.4 M
   nonzeros from ``uniform_tensor``) with 3 iterations under the port's
   plan and 3 more under the JAX package's routing (one-hot partials on
   every mode), which must give the same fits bit for bit;
4. holds the CP-APR kernels (K4 decode, K5 Φ carry, K6 Φ partials, K7 Φ
   recursive, K9 Φ chunk) and the fixed-order pull reduction against
   their plain versions on the same small layouts under both Π policies
   and at ranks 5, 16 and 40 (K4 equal, K5 equal to K6 + segment_merge,
   K9 chained over chunks equal to K5, K7 in Temp windows of 1 and 3 rows
   equal to K7 in one window, as is K7 in the wide CTA that
   ``common.k7_launch`` gives a Temp taller than one window, K5, K6 and
   K7 equal bit for bit to their
   plain versions run on CPU copies of the inputs with one CPU thread,
   every row of K5's output written as K1's, the split of K6's slots
   equal to ``split_block_runs``, equal bits on a second run),
   and a small CP-APR on the card against the same one on the CPU
   (log-likelihoods within 1e-5 relative, factors within 1e-5);
5. runs CP-APR at rank 16 on the Chicago tensor (ALTO-OTF, 5 outer
   iterations, twice: equal bits) and on the DARPA tensor (ALTO-PRE, 2
   outer iterations under the port's plan, K5, and again under the JAX
   package's routing, K6: equal log-likelihoods and KKT violations);
6. holds the out-of-core chunk kernels (K8 MTTKRP, K9 Φ under both Π
   policies) against their plain versions chunk by chunk on the
   out-of-core adversarial layouts with chunks of 1, 2 and 3 blocks, the
   chunked ops equal to in-core K1 / K5 bit for bit, equal bits on a
   rerun, and a spilled (memory-mapped, staged) stream equal to in core;
7. streams the DARPA tensor under a device budget of two chunks of about
   1/8 of a mode's stream (``make_plan(device_bytes=...)``): 2 CP-ALS
   iterations whose fits equal the in-core run's first two bit for bit,
   and 2 CP-APR outer iterations under ALTO-PRE whose log-likelihoods and
   KKT violations equal the in-core run's; then the Chicago tensor under
   ALTO-OTF (2 outer iterations) against an in-core run of the same
   all-carry plan; with the chunked ms per mode against in core, the copy
   alone, and peak device memory against the plan's byte model;
8. times K1's runs pass, its fix-up walk and the whole op apart on
   Chicago modes 1-3 (with the K5 route's fix-up) and DARPA mode 2;
9. at the main path's shapes, checks each kernel against its plain version
   (K3 and K7 also in windows of 16 rows, equal to one window, K2, K3 and
   K5 also into NaN-filled outputs, the split equal to
   ``split_block_runs`` on DARPA mode 2's slots; K4 under each
   decode route on the whole DARPA stream, one chunk's ragged length,
   lengths 1, 1023 and 1025, and the Chicago stream) and times kernel,
   plain version and bound, and the pull with its cached order; and K7 on
   the four modes of FROSTT Enron's shape, whose Temp windows fill a
   CTA's shared memory: the main path's wide CTA counted in
   ``phi_partials_wide``, equal bit for bit to the plan's 128 threads and
   to itself in windows of 256 rows, close to its plain version, and
   timed beside the 128-thread launch;
10. measures plans, with a plan store in a temporary directory: the
   MTTKRP tuner at its defaults (what ``make_plan(tune="auto", at=)``
   runs on a store miss: every mode's list capped at 24 candidates, every
   traversal family in it) on Chicago's and DARPA's modes (the winner
   never slower than the static gene; ``tune="force"`` and
   ``tune="auto"`` then store hits with no timing run) and CP-ALS on each
   winner (fits
   within 1e-4 of the static plan's run); the Φ tuner and CP-APR on its
   winners (log-likelihoods within 1e-5 relative); the budgeted search on
   DARPA in core and under phase 7's budget, whose streamed CP-ALS fits
   equal an in-core run of the same tiles bit for bit; then every kernel
   on the small layouts at ``block_m`` 8 and 1024, ``r_block`` 1, 2 and 4,
   CTAs of 64 and 256 threads and every tiling the tuners picked, against
   its plain version, the ops of one ``block_m`` equal bit for bit whatever
   the ``r_block`` and ``threads``;
11. runs shape-class buckets of network-traffic tenants (``BUCKET_CLASSES``:
   class A, 64 tenants in the class (4096, 4096, 65536) with 262,144
   nonzeros, carry on every mode under ALTO-OTF; class B, 16 tenants in
   (32768, 32768, 4194304) with 65,536, one-hot on mode 2 under
   ALTO-PRE; dims and nnz seeded, rank 16): batched CP-ALS (5 sweeps) and
   CP-APR (3 outer iterations), each kernel launched once per mode a
   sweep (inner step) whatever the bucket's size, every tenant equal bit
   for bit to its solo run on its padded tensor with the class plan and
   the embedded start, four tenants within ``rtol=2e-4, atol=2e-5``
   (factors), 1e-6 (last fit) and ``rtol=2e-4`` (λ) of their unpadded
   solo runs, each tenant-axis launch within tolerance of its plain
   version and bit for bit its T solo launches; capacity 16 and 64 launch
   alike; the class's plan-store key is every tenant's, and a second make
   of the class plan under ``tune="auto"`` takes no timing run; class A
   again with mode 0 recursive (1 sweep, 1 outer iteration: its 4,096
   Temp rows span several K7 windows on the tenant axis), bit for bit
   solo. Then recursive modes in buckets (`run_class_c`): class C, 16
   crime tenants at Chicago's proportions in the class (8192, 32, 128,
   32) with 262,144 nonzeros, under three class plans, (a) mode 0 carry
   and modes 1-3 recursive, (b) every mode recursive (mode 0's 8,192
   Temp rows span K7 windows), (c) the tuned class plan (``tune="auto"``
   on a temporary store): 5 CP-ALS sweeps and 3 CP-APR outer iterations
   under ALTO-OTF and ALTO-PRE, every tenant bit for bit its solo run,
   K3 and K7 launched once a mode a sweep (inner step) at capacity 16
   and 32 alike, the stacked K3, K7 (both policies) and pull within
   tolerance of their plain versions and bit for bit their T solo
   launches, against the all-oriented class plan's times; then class C
   through a tuned ``CpdService`` (capacity 16), bit for bit solo;
12. appends to the Chicago tensor (1 % under "sum" and "last", and a
   delta that grows mode 0 past 8192) against the host rebuild
   ``alto.merge_reference``, and to the DARPA tensor (1 %, then mode 2
   past 2**25) against ``build_device(merge_coo(...))``, bit for bit;
   3 warm-start CP-ALS iterations on the grown DARPA tensor from step 3's
   result against a cold start; the views ``invalidate_changed`` drops
   after a no-op and after a content append;
13. serves step 11's classes through ``launch.serve_cpd.CpdService``
   (`phase_serve`): class A's 64 tenants to a CP-ALS service (capacity 16,
   5 sweeps, ``guard=True``, ``tune="auto"`` on a plan store under
   ``build/``) from 4 submitter threads with the worker running, class B's
   16 to a CP-APR service (capacity 8, 3 outer iterations); every tenant
   bit for bit its solo run on its padded tensor under the class plan; a
   second service on the warm store takes no timing run and launches each
   kernel once a mode and sweep; class A unguarded gives the same bits;
   eight deltas equal ``ingest.append_delta`` + ``cp_als(warm_start=)``;
   no fault fired and no retry, degradation, quarantine, eviction or error
   counted. Then each fault site armed alone with the outcome it must
   give: ``batched.nan`` (NaN, then 1e30) quarantines tenant 3 and leaves
   its 15 mates' bits; ``batched.sweep`` bisects (once) and quarantines
   the offender alone (twice); ``views.build`` is one retry, the same
   bits; ``autotune.store`` reads as a miss; ``plan.dispatch`` evicts the
   stored plan for the static one; ``ops.exec`` twice on a class B bucket
   is no rung at all: the bucket is bisected, the offender's solo re-run
   fails too and only it gets an error, its 7 mates are served alone on
   the kernels with the clean run's bits, and nothing is degraded;
   ``ingest.merge`` fails the delta and not its base;
   ``ops.chunk_oom`` on Chicago's streamed plan halves ``chunk_m``
   (`health.degrade_plan`) with the same bits; ``stream.memmap_load``,
   ``stream.checksum`` and ``stream.respill`` on a spilled Chicago mode
   stream retry, rebuild and keep the old generation;
14. runs row-range-sharded CPD (``repro_torch.dist.cpd``, `phase_dist`,
   after step 5): over NCCL at world size 1, DARPA's 3 CP-ALS iterations
   through ``distributed_cp_als`` and 2 CP-APR outer iterations under the
   sharded plan bit for bit steps 3 and 5, the sharded sweep's ms against
   the single-device sweep's, Chicago's 10 CP-ALS iterations (mode 0
   oriented) within 1e-4 of step 2's fits, and the sharded tuner (a key
   of its own, the second make no timing run, oriented winners); then
   2, 4 and 8 shards one slice at a time on DARPA mode 2 (ALTO-PRE) and
   Chicago modes 0 and 1 (ALTO-OTF): K1, K2 + split + fix-up, K5 and K6
   on each slice's row window against their plain versions (the same
   tolerance), zeros off the slice, the slices summed in rank order
   against the unsharded kernel; then two gloo ranks spawned on the one
   card: each first-sweep MTTKRP bit for bit the in-process sum of the
   two slices, 3 CP-ALS iterations within 1e-4 of the one-rank run, the
   1 % DARPA delta through ``sharded_append_delta`` bit for bit
   ``append_delta``, each rank's seconds and peak memory;
15. runs the paper's format comparison (Fig. 9 and Fig. 12,
   `phase_formats`, after step 14) on Chicago and DARPA at rank 16: the
   host build seconds of HiCOO (7-bit blocks) and CSF-ALL (one tree per
   mode) beside ALTO's ``build_device``; all-modes and per-mode MTTKRP ms
   in COO, HiCOO and CSF-ALL (plain PyTorch, the JAX package's
   formulations) and in ALTO through ``plan.execute_mttkrp`` (Chicago's
   static plan, K3 and K1; DARPA's, K1, and the JAX package's routing, K2
   + split + fix-up, equal to it bit for bit), each format within 1e-4
   of ALTO relative to max|ALTO| on every mode; the storage bytes of
   COO, ALTO, ALTO with its views (``plan.resident_bytes``), HiCOO and
   CSF-ALL; then the three single-process examples at their default
   sizes (``examples/torch_*.py``), the end-to-end one cut after its
   first checkpoint and resumed, bit for bit the uninterrupted chain of
   its ``cp_als(factors=)`` calls;
16. runs the LM stack (`phase_lm`, first, after the build): serves
   granite-moe-3b-a800m at its published size (32 layers, d_model 1536,
   40 experts top-8, vocabulary 49,155; bf16, weights from a seeded
   generator) through the launcher's loop (``launch.serve.generate``): 4
   requests of 128 prompt tokens from ``make_batch``, 32 greedy tokens
   each, twice, with equal tokens and logits (``torch.equal``) and every
   logit finite; on every layer's routing of the prompt the ALTO sort's
   order, slots and keeps equal the reference dispatch's bit for bit and
   the two MoE outputs agree within K bf16 roundings of max|out| (they
   sum a token's K contributions in other orders); then the first two
   layers of granite and smollm-360m at full width in float32 on the card
   against the CPU, TF32 off: each layer on the CPU layer's input and the
   unembedding within ``rtol=1e-4, atol=1e-4·max|cpu|``, the chained
   logits within 1e-3 (`lm_cpu_parity`), the two dispatches within K
   float32 roundings;
   then every architecture at full width, one repeat of its block
   pattern (smollm-360m and granite at full depth, kimi-k2's 38.8 GB
   included): forward, prefill and 4 decode steps at batch 2 and prompt
   64 (the VLM: its 256-position vision prefix + 64), finite logits, ms
   and peak memory, and prefill(S-1) + one decode step against forward
   at S-2 and S-1 (the MoE models at a capacity where nothing drops, the
   VLM skipped, as in the JAX test), in bf16 and, where the weights fit,
   in float32: every layer on the forward's input to it, and the whole
   model, within 2e-2 of max|forward| (`lm_consistency`; the whole-model
   decode of the stacks in `LM_CHAOTIC` recorded, not gated);
17. trains (`phase_train`, after `phase_lm`), through the training
   launcher ``launch.train``: (a) granite-moe-3b-a800m at its published
   size, bf16, AdamW under ``warmup_cosine(3e-4, 20, 6)``, remat on,
   batch 4 × 1,024 tokens from ``TokenPipeline(seed=0)``, 6 steps: every
   loss, ce, aux and grad_norm finite, step 0's loss equal (bit for bit)
   to `make_loss_fn` on the same weights and batch under ``no_grad``, ms
   a step (median of steps 2-6), tokens/s and peak memory; (b) its first
   3 steps twice under ``torch.use_deterministic_algorithms(True)``
   (``warn_only=False``): equal losses and parameters (``torch.equal``);
   twice more in the default mode, the largest parameter difference
   recorded; (c) the first two layers of granite and smollm-360m at full
   width in float32 on the card against the CPU, TF32 off: one step with
   AdamW (and Adafactor on granite's two-layer stack), the loss within
   1e-4 relative, each gradient leaf within 1e-2 of max|cpu|, and the
   optimizer alone on identical gradients, parameters and state within
   1e-6 of max|cpu| per leaf (a bfloat16 leaf, Adafactor's first moment:
   one bfloat16 ulp of each element more); (d) the two-layer granite in
   bf16, cut after 2 steps and resumed from the launcher's checkpoint,
   equal (bit for bit, deterministic mode) to the uninterrupted 4-step
   run; (e)
   every other architecture at full width, one repeat of its pattern
   (smollm-360m at full depth; kimi-k2 skipped: one repeat's weights and
   gradients fill the card), two steps with its optimizer and
   ``grad_accum`` at batch max(2, grad_accum), seq 128 (the VLM: its
   256 vision positions + 128 tokens), finite loss and gradient norm, ms
   and peak memory; (f) the CPD workload, ``launch.train --workload cpd``
   on Chicago's shape (6,186 × 24 × 77 × 32, 4.86 M zipf nonzeros, rank
   16, 10 iterations) at world size 1 over NCCL, launch counts zeroed
   before it: K1 and the fix-up launched, no plain version on a CUDA
   tensor, fits finite, never dropping by more than 1e-3, and equal to
   `distributed_cp_als` called directly on the same tensor and seed;
18. pipelines and dry-runs it (`phase_mesh`, after `phase_train`): (a)
   granite-moe-3b-a800m at its published size (bf16, remat, seeded
   weights, batch 4 × 1,024) as 2 GPipe stages of 16 layers
   (`dist.pipeline`) on two gloo ranks spawned on the one card, 4
   microbatches, activations and gradients staged through pinned host
   buffers; on each rank the logits and loss equal, bit for bit, the 4
   microbatches through `model.forward` one after another on the whole
   model (deterministic mode), and each of its gradient leaves lies
   within 1e-3 of max|reference| (how many are bit for bit is counted);
   each rank's step ms, peak memory and staged bytes, and the whole-batch
   forward's distance with its witness layer by layer (recorded, not
   gated: where it starts, whether the routing is equal, and how far one
   unit in the last place of the embedding travels); (b) the dry run
   (`launch.dryrun`) of that training step (AdamW) on a (1, 1) mesh over
   a fake one-rank group: its per-device argument bytes equal the
   parameters, AdamW state and batch allocated on the card, its FLOPs
   equal `FlopCounterMode` on one real step; and the model-FLOP share of
   (a)'s `phase_train` step, ``model_flops / (ms · 989e12)``, beside the
   card's name and power limit.

Every kernel-vs-plain check takes its plain reference in index order
(PyTorch's deterministic mode, `_index_order`) and records its error
beside max|plain| (`CHECKS`).

After the build, ``ptxas -v`` must show a 0-byte stack frame for every
instantiation of the redesigned kernels (the runs pass that K1, K2 and K8
share, the fix-up walk, the split, K4, K3, and the runs pass that K5, K6
and K9 share).

Each CP-ALS and CP-APR run is driven with the launch counts set to 0 just
before it and read just after; a run fails unless the kernels its plan
picks were launched and no plain version ran on a CUDA tensor. Fits must
be finite and never drop by more than 1e-3. A small decomposition on the
card must match the same one on the CPU within 1e-5 in fit. CP-APR
log-likelihoods must be finite and rise from the first outer iteration to
the last, KKT violations finite, factors non-negative with column sums 1
within 1e-3.

Output: a line counting the kernel-vs-plain checks with the largest
errors beside max|plain|, a ``{"dist": {...}}`` line (step 14's runs:
seconds, fits, launches, per-rank peak memory and each bitwise verdict),
a ``{"formats": {...}}`` line (step 15: ms, speedups over COO, agreement,
build seconds, storage bytes and ratios), a ``{"lm": {...}}`` line (step
16: the served model's prefill ms, decode ms a token, tokens/s, weight
and peak bytes, the dispatch check; the card against the CPU; each
architecture's ms, peak bytes and consistency errors), a ``{"train":
{...}}`` line (step 17's readings), a ``{"mesh": {...}}`` line (step
18's), the card's name and power limit,
a ``{"kernels": [...]}`` line
(each kernel's main-path ``launches`` and ``elements``, the stream
lengths summed over those launches, and under ``tenant_axis`` its
bucketed launches: ms against the T solo launches' ms, the plain
version's and the bound), and last ``{"ok": true, "device":
{...}}``. Any failed phase raises and
exits non-zero; without CUDA, or outside a checkout of the repository,
the script exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

# cuBLAS is deterministic in PyTorch's deterministic mode only under this
# workspace setting, which PyTorch reads when it makes its first cuBLAS
# handle and checks before every cuBLAS call in that mode (`phase_train`
# (b), (d)). It must be set before CUDA starts; ":4096:8" (32 MiB) is
# PyTorch's own default workspace on sm_90, so no other phase changes.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
RANK = 16
RTOL = 1e-5
ATOL_REL = 1e-6
DEVICE = "cuda"                # the card; phases put their own tensors here


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
    from repro_torch.core import (alto, autotune, batched, cpals, cpapr,
                                  faults, health, heuristics, ingest, mttkrp,
                                  plan, search, shapeclass, stream, views)
    from repro_torch.kernels import _build, common, ops
    from repro_torch.kernels import cpapr_phi as k7
    from repro_torch.kernels import delinearize as k4
    from repro_torch.kernels import mttkrp as k3
    from repro_torch.kernels import mttkrp_oriented as kori
    from repro_torch.kernels import ref
    from repro_torch.dist import cpd
    from repro_torch.launch import serve_cpd
    from repro_torch.sparse import baselines, synthetic
    from repro_torch import configs as lm_configs
    from repro_torch.data import pipeline as lm_pipeline
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models import blocks as lm_blocks
    from repro_torch.models import common as lm_common
    from repro_torch.models import model as lm_model
    from repro_torch.models import moe as lm_moe
    from repro_torch import interop
    from repro_torch.launch import train as lm_train
    from repro_torch.optim import optimizers as lm_optim
    from repro_torch.train import steps as lm_steps
    from repro_torch.dist import pipeline as lm_pp
    from repro_torch.launch import dryrun as lm_dryrun
    from repro_torch.launch import roofline as lm_roofline
    return dict(lm_pp=lm_pp, lm_dryrun=lm_dryrun, lm_roofline=lm_roofline,
                interop=interop, lm_train=lm_train, lm_optim=lm_optim,
                lm_steps=lm_steps, alto=alto, autotune=autotune,
                baselines=baselines,
                cpals=cpals, cpapr=cpapr, cpd=cpd,
                batched=batched, ingest=ingest, shapeclass=shapeclass,
                faults=faults, health=health, serve=serve_cpd,
                heuristics=heuristics, mttkrp=mttkrp, plan=plan,
                search=search, build=_build, common=common,
                ops=ops, k3=k3,
                k4=k4, k7=k7, kori=kori, ref=ref, synthetic=synthetic,
                stream=stream, views=views, lm_configs=lm_configs,
                lm_pipeline=lm_pipeline, lm_serve=lm_launch,
                lm_model=lm_model, lm_moe=lm_moe, lm_blocks=lm_blocks,
                lm_common=lm_common)


def _sync():
    torch.cuda.synchronize()


CHECKS: list[dict] = []         # every _check_close: error beside max|plain|


def _check_close(name: str, got, plain) -> float:
    got, plain = got.float(), plain.float()
    if got.shape != plain.shape:
        _fail(f"{name}: shape {tuple(got.shape)} vs {tuple(plain.shape)}")
    if not bool(torch.isfinite(got).all()):
        _fail(f"{name}: non-finite output")
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((got - plain).abs().max()) if plain.numel() else 0.0
    CHECKS.append({"check": name, "max_abs_err": err, "max_plain": scale,
                   "bitwise": bool(torch.equal(got, plain))})
    if not torch.allclose(got, plain, rtol=RTOL, atol=ATOL_REL * scale):
        _fail(f"{name}: max_abs_err {err} beyond rtol={RTOL}, "
              f"atol={ATOL_REL}·{scale}")
    return err


@contextlib.contextmanager
def _index_order(warn_only: bool = True):
    """PyTorch's deterministic mode, for a plain version's reference. On
    the card `index_add_` adds with float atomics in no fixed order, so a
    row summed from thousands of pieces differs from run to run; in this
    mode it adds in index order, the order the plain versions state and
    the kernels keep. As a decorator (``@_index_order()``) it runs a
    whole kernel-vs-plain check so; nested, it restores the outer mode.
    ``warn_only=False`` makes an op without a deterministic form raise
    (`phase_train`)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _checks_summary() -> str:
    """One line: how many kernel-vs-plain checks held, how many bit for
    bit, and the largest errors against max|plain|."""
    def rel(c):
        return c["max_abs_err"] / c["max_plain"] if c["max_plain"] else 0.0
    worst = sorted(CHECKS, key=rel, reverse=True)[:8]
    return (f"{len(CHECKS)} kernel-vs-plain checks held (plain references "
            f"in index order), {sum(c['bitwise'] for c in CHECKS)} bit for "
            f"bit; the largest max_abs_err against max|plain|: "
            + "; ".join(f"{c['check']}: {c['max_abs_err']:.3g} of "
                        f"{c['max_plain']:.3g}" for c in worst))


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

@_index_order()
def check_segment_split(m, partials, rows, out_dim, threads,
                        label: str) -> float:
    """The split kernel against ``split_block_runs`` on the same slots:
    equal carries, ``out`` equal off the carried rows and, run into a
    NaN-filled ``out``, NaN exactly at them (every other row written);
    split + fix-up equal to ``split_block_runs`` + fix-up; repeatable.
    Returns the largest difference of the merged outputs (0.0)."""
    kori = m["kori"]
    R = partials.shape[2]
    out, crow, cval = kori.segment_split(
        partials, rows, out_dim, threads,
        out=torch.full((out_dim, R), float("nan"), device=rows.device))
    p_out, p_crow, p_cval = kori.split_block_runs(partials, rows, out_dim)
    _check_equal(f"{label} segment_split carry_row", crow, p_crow)
    _check_equal(f"{label} segment_split carry_val", cval, p_cval)
    carried = torch.zeros(out_dim, dtype=torch.bool, device=rows.device)
    carried[crow[crow >= 0].long()] = True
    if not (bool(out[carried].isnan().all())
            and not bool(out[~carried].isnan().any())):
        _fail(f"{label} segment_split: the rows written are not exactly "
              f"the rows without a carried piece")
    _check_equal(f"{label} segment_split out", out[~carried],
                 p_out[~carried])
    out2, crow2, cval2 = kori.segment_split(partials, rows, out_dim, threads)
    _check_equal(f"{label} segment_split repeat carry_row", crow2, crow)
    _check_equal(f"{label} segment_split repeat carry_val", cval2, cval)
    merged = kori.carry_fixup(crow2, cval2, out2, threads=threads)
    plain = kori.carry_fixup(p_crow, p_cval, p_out, threads=threads)
    _check_equal(f"{label} segment_split + fix-up", merged, plain)
    return float((merged - plain).abs().max()) if merged.numel() else 0.0


@_index_order()
def check_oriented_kernels(m, view, factors, block_m, r_block, threads,
                           label: str, cpu_copies: bool = False) -> dict:
    """K1 runs, carry fix-up (under two rank tiles, equal) and K2 against
    their plain versions on one oriented view; K1 == K2 + segment_merge;
    every row of K1's output written (a NaN-filled output equals the
    normal run, and the runs pass leaves exactly the carried pieces' rows
    to the fix-up); every slot of K2 written (NaN-filled slots equal the
    normal run); the split of K2's slots (`check_segment_split`);
    repeatability; with ``cpu_copies``, K1 and K2 equal bit for bit to
    their plain versions run on CPU copies of the inputs."""
    ops, kori = m["ops"], m["kori"]
    enc, mode = view.meta.enc, view.mode
    rows, words, values, _ = ops.pad_sorted_stream(view.rows, view.words,
                                                   view.values, block_m)
    args = (enc, mode, rows, words, values, factors)
    kw = dict(block_m=block_m, r_block=r_block, threads=threads)
    shape = (enc.dims[mode], factors[0].shape[1])

    def nan():
        return torch.full(shape, float("nan"), device=rows.device)
    out, crow, cval = kori.carry_runs(*args, **kw, out=nan())
    out2, crow2, cval2 = kori.carry_runs(*args, **kw, out=nan())
    _sync()
    for a, b, what in ((out, out2, "out"), (crow, crow2, "carry_row"),
                       (cval, cval2, "carry_val")):
        _check_equal(f"{label} carry_runs repeat {what}",
                     a.nan_to_num(7.0), b.nan_to_num(7.0))
    p_out, p_crow, p_cval = kori.carry_runs_plain(*args, block_m)
    _check_equal(f"{label} carry_runs carry_row", crow, p_crow)
    carried = torch.zeros(shape[0], dtype=torch.bool, device=rows.device)
    carried[crow[crow >= 0].long()] = True
    if not (bool(out[carried].isnan().all())
            and not bool(out[~carried].isnan().any())):
        _fail(f"{label} carry_runs: the rows written are not exactly the "
              f"rows without a carried piece")
    errs = {"carry_runs": max(
        _check_close(f"{label} carry_runs out", out[~carried],
                     p_out[~carried]),
        _check_close(f"{label} carry_runs carry_val", cval, p_cval))}

    fix = kori.carry_fixup(crow, cval, out.clone(), r_block, threads)
    fix2 = kori.carry_fixup(crow, cval, out.clone(), r_block, threads)
    _check_equal(f"{label} carry_fixup repeat", fix, fix2)
    _check_equal(f"{label} carry_fixup default rank tile", fix,
                 kori.carry_fixup(crow, cval, out.clone(), None, threads))
    errs["carry_fixup"] = _check_close(
        f"{label} carry_fixup", fix,
        kori.carry_fixup_plain(crow, cval, p_out.clone()))

    part = kori.oriented_partials(*args, **kw)
    _check_equal(f"{label} oriented_partials repeat", part,
                 kori.oriented_partials(*args, **kw))
    errs["oriented_partials"] = _check_close(
        f"{label} oriented_partials", part,
        kori.oriented_partials_plain(*args, block_m))
    _check_equal(f"{label} oriented_partials into NaN-filled slots", part,
                 kori.oriented_partials(*args, **kw, out=torch.full(
                     part.shape, float("nan"), device=part.device)))
    errs["segment_split"] = check_segment_split(
        m, part, rows, enc.dims[mode], threads, label)

    k1 = ops.mttkrp_oriented_carry(view, factors, **kw)
    k2 = ops.mttkrp_oriented(view, factors, **kw)
    _check_equal(f"{label} K1 vs K2+segment_merge", k1, k2)
    _check_equal(f"{label} K1 repeat", k1,
                 ops.mttkrp_oriented_carry(view, factors, **kw))
    _check_equal(f"{label} K1 into a NaN-filled output", k1,
                 kori.mttkrp_oriented_carry(*args, **kw, out=nan()))
    if cpu_copies:
        with _OneCpuThread():
            o, r, v = kori.carry_runs_plain(enc, mode, *_cpu(args[2:5]),
                                            _cpu(factors), block_m)
            plain = kori.carry_fixup_plain(r, v, o)
            plain_part = kori.oriented_partials_plain(
                enc, mode, *_cpu(args[2:5]), _cpu(factors), block_m)
        _check_equal(f"{label} K1 vs its plain version on CPU copies",
                     k1.cpu(), plain)
        _check_equal(f"{label} K2 vs its plain version on CPU copies",
                     part.cpu(), plain_part)
    return errs


@_index_order()
def check_recursive_kernel(m, at, factors, mode, r_block, threads,
                           label: str, windows=(1, 3),
                           cpu_copies: bool = False) -> float:
    """K3 against its plain version, repeatable; K3 with Temp windows of
    ``windows`` rows equal to K3 in one window; K3 into a NaN-filled Temp
    equal to the normal run (every entry written); with ``cpu_copies``,
    K3 equal bit for bit to its plain version run on CPU copies of the
    inputs."""
    k3 = m["k3"]
    meta = at.meta
    T = meta.temp_rows[mode]
    args = (meta.enc, mode, T, at.words, at.values, at.part_start, factors)
    kw = dict(r_block=r_block, threads=threads)
    temp = k3.recursive_partials(*args, **kw)
    _check_equal(f"{label} recursive_partials repeat", temp,
                 k3.recursive_partials(*args, **kw))
    one = k3.recursive_partials_windowed(*args, **kw, window=T)
    _check_equal(f"{label} recursive_partials in one window", temp, one)
    for w in windows:
        _check_equal(f"{label} recursive_partials windows of {w} rows", one,
                     k3.recursive_partials_windowed(*args, **kw, window=w))
    nan = torch.full(temp.shape, float("nan"), device=temp.device)
    _check_equal(f"{label} recursive_partials into a NaN-filled Temp", temp,
                 k3.recursive_partials(*args, **kw, out=nan))
    if cpu_copies:
        with _OneCpuThread():
            plain = k3.recursive_partials_plain(*args[:3],
                                                *_cpu(args[3:6]),
                                                _cpu(factors))
        _check_equal(f"{label} K3 vs its plain version on CPU copies",
                     temp.cpu(), plain)
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


def _factors(dims, seed, device=None, rank=RANK):
    device = device or DEVICE
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.rand((I, rank), generator=g, device=device) + 0.05
            for I in dims]


class _OneCpuThread:
    """One CPU thread inside: PyTorch's CPU sums then run in index order,
    the order the plain versions claim."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _cpu(x):
    """A CPU copy of a tensor, a list of them, or a dict of them."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [t.cpu() for t in x]
    return x.cpu()


def _small_layouts(block_m: int) -> dict:
    """Row multiplicities of the small adversarial run layouts
    (tests/test_oriented_carry.py), over 29 rows."""
    rng = np.random.default_rng(block_m)
    return {"identical": np.eye(29, dtype=np.int64)[3] * (4 * block_m + 3),
            "distinct": np.ones(29, dtype=np.int64),
            "boundary_run": rng.integers(0, 3, size=29)
            + np.eye(29, dtype=np.int64)[11] * (3 * block_m + 2),
            "mixed": rng.integers(1, 2 * block_m, size=29)}


def phase_small(m) -> dict:
    """Adversarial run layouts (tests/test_oriented_carry.py) on the card,
    at ranks 5, `RANK` and 40, each with the whole rank as the rank tile
    and with a smaller one; K1 and K3 equal bit for bit to their plain
    versions on CPU copies, K3 in windows of 1 and 3 rows equal to one
    window and into a NaN-filled Temp equal to the normal run; K2 bit for
    bit to its plain version on CPU copies and into NaN-filled slots, and
    the split of its slots equal to ``split_block_runs``."""
    dims = (29, 13, 7)
    worst = {}
    for rank, tiles in ((5, (5, 1)), (RANK, (RANK, 4)), (40, (40, 8))):
        per_rank = worst.setdefault(f"R{rank}", {})
        for block_m in (8, 64):
            for name, counts in _small_layouts(block_m).items():
                x = _stream_tensor(counts, dims, seed=block_m)
                at = m["alto"].build_device(x, n_partitions=4)
                fs = _factors(dims, seed=block_m, rank=rank)
                for r_block in tiles:
                    label = (f"small {name} block_m={block_m} R={rank} "
                             f"r_block={r_block}")
                    errs = check_oriented_kernels(
                        m, m["alto"].oriented_view_device(at, 0), fs,
                        block_m, r_block, 64, label, cpu_copies=True)
                    errs["recursive_partials"] = check_recursive_kernel(
                        m, at, fs, 0, r_block, 64, label, cpu_copies=True)
                    for k, v in errs.items():
                        per_rank[k] = max(per_rank.get(k, 0.0), v)
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


def _phi_operands(m, enc, words, factors, mode, policy) -> dict:
    if policy == "pre":
        return {"pi": m["ops"].pi_rows(enc, words, factors, mode)}
    return {"factors": factors}


@_index_order()
def check_phi_oriented_kernels(m, view, B, operands, block_m, threads,
                               label: str, cpu_copies: bool = False) -> dict:
    """K5 runs and K6 against their plain versions on one oriented view;
    the split of K6's slots (`check_segment_split`);
    K5 (runs + fix-up) == K6 + segment_merge; every row of K5's output
    written (into a NaN-filled output the runs pass leaves exactly the
    carried pieces' rows to the fix-up, and K5 equals the normal run);
    repeatability; with ``cpu_copies``, K5 and K6 equal bit for bit to
    their plain versions run on CPU copies of the inputs."""
    ops, kori = m["ops"], m["kori"]
    enc, mode, eps = view.meta.enc, view.mode, 1e-10
    rows, words, values, pi = ops.pad_sorted_stream(
        view.rows, view.words, view.values, block_m, pi=operands.get("pi"))
    kw = dict(factors=operands.get("factors"), pi=pi)
    args = (enc, mode, eps, rows, words, values, B)
    shape = (enc.dims[mode], B.shape[1])

    def nan():
        return torch.full(shape, float("nan"), device=rows.device)
    out, crow, cval = kori.phi_carry_runs(*args, **kw, block_m=block_m,
                                          threads=threads, out=nan())
    out2, crow2, cval2 = kori.phi_carry_runs(*args, **kw, block_m=block_m,
                                             threads=threads, out=nan())
    _sync()
    for a, b, what in ((out, out2, "out"), (crow, crow2, "carry_row"),
                       (cval, cval2, "carry_val")):
        _check_equal(f"{label} phi_carry_runs repeat {what}",
                     a.nan_to_num(7.0), b.nan_to_num(7.0))
    p_out, p_crow, p_cval = kori.phi_carry_runs_plain(*args, **kw,
                                                      block_m=block_m)
    _check_equal(f"{label} phi_carry_runs carry_row", crow, p_crow)
    carried = torch.zeros(shape[0], dtype=torch.bool, device=rows.device)
    carried[crow[crow >= 0].long()] = True
    if not (bool(out[carried].isnan().all())
            and not bool(out[~carried].isnan().any())):
        _fail(f"{label} phi_carry_runs: the rows written are not exactly "
              f"the rows without a carried piece")
    errs = {"phi_carry_runs": max(
        _check_close(f"{label} phi_carry_runs out", out[~carried],
                     p_out[~carried]),
        _check_close(f"{label} phi_carry_runs carry_val", cval, p_cval))}
    part = kori.phi_oriented_partials(*args, **kw, block_m=block_m,
                                      threads=threads)
    _check_equal(f"{label} phi_oriented_partials repeat", part,
                 kori.phi_oriented_partials(*args, **kw, block_m=block_m,
                                            threads=threads))
    errs["phi_oriented_partials"] = _check_close(
        f"{label} phi_oriented_partials", part,
        kori.phi_oriented_partials_plain(*args, **kw, block_m=block_m))
    errs["segment_split"] = check_segment_split(
        m, part, rows, enc.dims[mode], threads, f"{label} phi")
    kw = dict(operands, eps=eps, block_m=block_m, threads=threads)
    k5 = ops.cpapr_phi_oriented_carry(view, B, **kw)
    _check_equal(f"{label} K5 vs K6+segment_merge", k5,
                 ops.cpapr_phi_oriented(view, B, **kw))
    _check_equal(f"{label} K5 repeat", k5,
                 ops.cpapr_phi_oriented_carry(view, B, **kw))
    _check_equal(f"{label} K5 into a NaN-filled output", k5,
                 kori.phi_oriented_carry(*args, operands.get("factors"), pi,
                                         block_m, threads, out=nan()))
    if cpu_copies:
        cview = dataclasses.replace(view, rows=view.rows.cpu(),
                                    words=view.words.cpu(),
                                    values=view.values.cpu(),
                                    perm=view.perm.cpu())
        with _OneCpuThread():
            plain = ops.cpapr_phi_oriented_carry(
                cview, B.cpu(), **_cpu(operands), eps=eps, block_m=block_m)
            plain_part = kori.phi_oriented_partials_plain(
                enc, mode, eps, *_cpu(args[3:]),
                _cpu(operands.get("factors")), _cpu(pi), block_m)
        _check_equal(f"{label} K5 vs its plain version on CPU copies",
                     k5.cpu(), plain)
        _check_equal(f"{label} K6 vs its plain version on CPU copies",
                     part.cpu(), plain_part)
    return errs


@_index_order()
def check_phi_recursive_kernel(m, at, B, operands, mode, threads,
                               label: str, windows=(1, 3),
                               cpu_copies: bool = False) -> dict:
    """K7 against its plain version, and the fixed-order pull against the
    CPU's; both repeatable; K7 with Temp windows of ``windows`` rows equal
    to K7 in one window, and so is K7 in the wide CTA `common.k7_launch`
    gives a Temp as tall as Enron's mode 0 (`ENRON_TEMP_ROWS`), in those
    windows and in one; with ``cpu_copies``, K7 equal bit for bit to its
    plain version run on CPU copies of the inputs."""
    k7, ops, common = m["k7"], m["ops"], m["common"]
    meta = at.meta
    args = (meta.enc, mode, meta.temp_rows[mode], 1e-10, at.words,
            at.values, at.part_start, B)
    temp = k7.phi_partials(*args, **operands, threads=threads)
    _check_equal(f"{label} phi_partials repeat", temp,
                 k7.phi_partials(*args, **operands, threads=threads))
    one = k7.phi_partials_windowed(*args, **operands, threads=threads,
                                   window=meta.temp_rows[mode])
    _check_equal(f"{label} phi_partials in one window", temp, one)
    for w in windows:
        _check_equal(f"{label} phi_partials windows of {w} rows", one,
                     k7.phi_partials_windowed(*args, **operands,
                                              threads=threads, window=w))
    wide = common.k7_launch(ENRON_TEMP_ROWS, B.shape[1],
                            common.smem_limit(B.device), threads,
                            common.k7_max_threads(B.shape[1], B.device))[0]
    if wide <= common.cta_threads(threads):
        _fail(f"{label}: k7_launch keeps {threads} threads for a Temp of "
              f"{ENRON_TEMP_ROWS} rows")
    for w in (*windows, meta.temp_rows[mode]):
        _check_equal(f"{label} phi_partials in CTAs of {wide} threads, "
                     f"windows of {w} rows", one,
                     k7.phi_partials_windowed(*args, **operands,
                                              threads=wide, window=w))
    errs = {"phi_partials": _check_close(
        f"{label} phi_partials", temp,
        k7.phi_partials_plain(*args, **operands))}
    if cpu_copies:
        cargs = (*args[:4], *_cpu(args[4:]))
        with _OneCpuThread():
            plain = k7.phi_partials_plain(*cargs, **_cpu(operands))
        _check_equal(f"{label} K7 vs its plain version on CPU copies",
                     temp.cpu(), plain)
    start = at.part_start[:, mode]
    order = m["views"].get_pull_order(at, mode)
    pull = ops.pull_reduction(temp, start, meta.dims[mode], order=order)
    _check_equal(f"{label} pull_reduction repeat", pull,
                 ops.pull_reduction(temp, start, meta.dims[mode],
                                    order=order))
    _check_equal(f"{label} pull_reduction, reach order vs dense order",
                 pull, ops.pull_reduction(temp, start, meta.dims[mode]))
    with _OneCpuThread():
        plain = m["mttkrp"].pull_rows(temp.cpu(), start.cpu(),
                                      meta.dims[mode])
    _check_equal(f"{label} pull_reduction vs pull_rows on CPU copies",
                 pull.cpu(), plain)
    errs["pull_reduction"] = _check_close(f"{label} pull_reduction", pull,
                                          plain.to(pull.device))
    return errs


@_index_order()
def check_delinearize(m, enc, words, label: str,
                      lengths=(None,)) -> None:
    """K4 equal to its plain version under each decode route, on the
    first ``n`` words for each ``n`` of ``lengths`` (None: all), through
    `ops.delinearize` and repeatably."""
    k4, ops = m["k4"], m["ops"]
    for n in lengths:
        w = words if n is None else words[:n]
        plain = k4.delinearize_plain(enc, w)
        got = ops.delinearize(enc, w)
        _check_equal(f"{label} M={w.shape[0]} delinearize repeat", got,
                     ops.delinearize(enc, w))
        _check_equal(f"{label} M={w.shape[0]} delinearize", got, plain)
        for route in k4.ROUTES:
            _check_equal(f"{label} M={w.shape[0]} delinearize ({route})",
                         k4.delinearize(enc, w, route=route), plain)


@_index_order()
def check_pi_rows(m, enc, words, factors, label: str,
                  modes=None) -> None:
    """`ops.pi_rows` equal to its plain version (`krp_rows` on the plain
    decode), repeatably, for each mode of ``modes`` (None: all); and
    under the ``"l1"`` decode route, which a shared-memory limit of 0
    bytes makes `choose_route` pick."""
    k4, ops, common = m["k4"], m["ops"], m["common"]
    for mode in range(enc.ndim) if modes is None else modes:
        plain = k4.pi_rows_plain(enc, words, factors, mode)
        got = ops.pi_rows(enc, words, factors, mode)
        _check_equal(f"{label} mode {mode} pi_rows repeat", got,
                     ops.pi_rows(enc, words, factors, mode))
        _check_equal(f"{label} mode {mode} pi_rows", got, plain)
        limit = common.smem_limit
        common.smem_limit = lambda device: 0
        try:
            l1 = ops.pi_rows(enc, words, factors, mode)
        finally:
            common.smem_limit = limit
        _check_equal(f"{label} mode {mode} pi_rows (l1)", l1, plain)


def phase_small_phi(m) -> dict:
    """The CP-APR kernels on the adversarial run layouts, both Π policies,
    at ranks 5, `RANK` and 40 (a partial sub-warp, a full one, several
    columns per lane): K5, K6, K7 and the pull against their plain
    versions, K5 and K7 equal bit for bit to their plain versions on CPU
    copies, K7 in windows of 1 and 3 rows equal to K7 in one, and K9
    chained over chunks of 2 blocks equal to K5 and, chunk by chunk, close
    to its plain version."""
    dims = (29, 13, 7)
    ops, stream = m["ops"], m["stream"]
    worst = {}
    for rank in (5, RANK, 40):
        per_rank = worst.setdefault(f"R{rank}", {})
        for block_m in (8, 64):
            for name, counts in _small_layouts(block_m).items():
                x = _stream_tensor(counts, dims, seed=block_m)
                x.values[:] = np.abs(x.values) + 1.0   # counts are > 0
                at = m["alto"].build_device(x, n_partitions=4)
                fs = _factors(dims, seed=block_m, rank=rank)
                B = fs[0] * 3.0
                view = m["alto"].oriented_view_device(at, 0)
                hs = stream.host_stream(at, 0)
                label = f"small phi {name} block_m={block_m} R={rank}"
                if rank == RANK:
                    check_delinearize(m, at.meta.enc, at.words, label)
                check_pi_rows(m, at.meta.enc, view.words, fs, label)
                for policy in ("otf", "pre"):
                    operands = _phi_operands(m, at.meta.enc, view.words, fs,
                                             0, policy)
                    errs = check_phi_oriented_kernels(
                        m, view, B, operands, block_m, 64,
                        f"{label} {policy}", cpu_copies=True)
                    errs.update(check_phi_recursive_kernel(
                        m, at, B, _phi_operands(m, at.meta.enc, at.words,
                                                fs, 0, policy),
                        0, 64, f"{label} {policy}", cpu_copies=True))
                    cm = 2 * block_m
                    errs.update(check_chunk_kernels(
                        m, hs, B, fs, block_m, cm, policy,
                        f"{label} {policy} chunks of 2 blocks"))
                    k5 = ops.cpapr_phi_oriented_carry(
                        view, B, **operands, block_m=block_m, threads=64)
                    _check_equal(
                        f"{label} {policy} K9 chunked vs K5",
                        ops.cpapr_phi_oriented_chunked(
                            hs, B, fs, pre=policy == "pre", chunk_m=cm,
                            block_m=block_m, threads=64), k5)
                    for k, v in errs.items():
                        per_rank[k] = max(per_rank.get(k, 0.0), v)
    print(f"chip_smoke: small CP-APR kernels ok, worst errors {worst}")
    return worst


ENRON_TEMP_ROWS = 5983   # FROSTT Enron's mode 0 at rank 16: Temp rows
ENRON_SEED = 20261018


@_index_order()
def phase_enron_k7(m) -> dict:
    """K7 where its Temp windows fill a CTA's shared memory: FROSTT Enron's
    shape (`bench/configs/enron.json`, drawn on the card by
    `bench.generators` from `ENRON_SEED`: 6,066 × 5,699 × 244,268 ×
    1,176, 54.2 M nonzeros, 1,024 partitions) at `RANK` under ALTO-OTF.
    On each mode the main path's launch (`common.k7_launch` from the
    plan's 128 threads: a wider CTA, counted once in
    ``phi_partials_wide`` with its threads as elements) equal bit for bit
    to the plan's CTA of 128 threads in its own window and to the wide CTA
    in windows of 256 rows, and close to the plain version; the main
    path's launch and the plan's CTA timed."""
    from bench import generators
    from repro_torch.sparse.tensor import SparseTensor
    common, k7, b = m["common"], m["k7"], m["build"]
    cfg = json.loads((ROOT / "bench/configs/enron.json").read_text())
    coo = generators.make_tensor(cfg, ENRON_SEED, torch.device(DEVICE))
    x = SparseTensor(coo.dims, coo.coords.to(torch.int32).cpu().numpy(),
                     coo.values.cpu().numpy())
    del coo
    at = m["alto"].build_device(x, n_partitions=int(cfg["n_partitions"]))
    del x
    fs = _factors(at.meta.dims, seed=5)
    limit = common.smem_limit(at.words.device)
    if at.meta.temp_rows[0] != ENRON_TEMP_ROWS:
        _fail(f"Enron mode 0: Temp of {at.meta.temp_rows[0]} rows, not "
              f"{ENRON_TEMP_ROWS}")
    modes = []
    for mode, T in enumerate(at.meta.temp_rows):
        label = f"Enron K7 mode {mode} (T={T})"
        args = (at.meta.enc, mode, T, 1e-10, at.words, at.values,
                at.part_start, fs[mode] * 3.0)
        threads, tile, window = common.k7_launch(
            T, RANK, limit, 128, common.k7_max_threads(RANK, fs[0].device))
        if threads <= 128:
            _fail(f"{label}: k7_launch keeps the plan's 128 threads")
        before = b.counts()
        temp = k7.phi_partials(*args, factors=fs, threads=128)
        after = b.counts()
        wide = tuple(after[k]["phi_partials_wide"]
                     - before[k]["phi_partials_wide"]
                     for k in ("launches", "elements"))
        if wide != (1, threads):
            _fail(f"{label}: phi_partials_wide counted {wide}, not "
                  f"(1, {threads})")
        plan_window = common.window_rows(T, RANK, limit, True)
        _check_equal(f"{label} vs the plan's CTA of 128 threads", temp,
                     k7.phi_partials_windowed(*args, factors=fs,
                                              threads=128,
                                              window=plan_window))
        _check_equal(f"{label} in windows of 256 rows", temp,
                     k7.phi_partials_windowed(*args, factors=fs,
                                              threads=threads, window=256))
        err = _check_close(label, temp,
                           k7.phi_partials_plain(*args, factors=fs))
        del temp
        modes.append({
            "mode": mode, "temp_rows": T, "threads": threads, "tile": tile,
            "window": window, "plan_window": plan_window,
            "max_abs_err": err,
            "ms": _ms(m, k7.phi_partials, *args, fs, None, None, 128),
            "plan_ms": _ms(m, k7.phi_partials_windowed, *args, fs, None,
                           None, 128, plan_window)})
    print(f"chip_smoke: Enron K7 ok, by mode (threads, tile, window, ms, "
          f"128-thread ms): "
          + "; ".join(f"{e['threads']}, {e['tile']}, {e['window']}, "
                      f"{e['ms']:.2f}, {e['plan_ms']:.2f}" for e in modes))
    return {"nnz": int(at.values.numel()), "modes": modes}


def _apr_params(m, k_max):
    return m["cpapr"].CpaprParams(k_max=k_max, l_max=10)


def _check_apr_result(label: str, res, k_max: int) -> None:
    """Every CP-APR run: k_max outer iterations, finite log-likelihoods
    that rise from the first to the last, finite KKT violations, factors
    non-negative with column sums 1 within 1e-3."""
    lls, kkts = res.log_likelihoods, res.kkt_violations
    if (res.n_outer != k_max or len(lls) != k_max
            or not all(math.isfinite(v) for v in lls + kkts)):
        _fail(f"{label}: {res.n_outer} outer iterations, log-likelihoods "
              f"{lls}, KKT {kkts}")
    if not lls[-1] > lls[0]:
        _fail(f"{label}: log-likelihood did not rise: {lls}")
    for A in res.factors:
        if not bool(torch.isfinite(A).all()) or float(A.min()) < 0.0:
            _fail(f"{label}: factor not finite and non-negative")
        if float((A.sum(dim=0) - 1.0).abs().max()) > 1e-3:
            _fail(f"{label}: factor columns do not sum to 1")


def phase_small_cp_apr(m) -> dict:
    """A small CP-APR on the card matches the same one on the CPU."""
    x = m["synthetic"].blocked_tensor((60, 24, 77, 32), 20_000, block=8,
                                      n_blocks=20, seed=1, count_data=True)
    out = {}
    for policy in ("otf", "pre"):
        res = {}
        for dev in ("cuda", "cpu"):
            at = m["alto"].build_device(x, n_partitions=64, device=dev)
            fs = [f.to(dev) for f in _factors(x.dims, seed=9)]
            p = m["plan"].make_plan(at.meta, RANK, backend="cuda")
            res[dev] = m["cpapr"].cp_apr(at, RANK, _apr_params(m, 3),
                                         pi_policy=policy, track_ll=True,
                                         warm_start=fs, plan=p)
            _check_apr_result(f"small CP-APR ({policy}, {dev})", res[dev],
                              3)
        a, b = res["cuda"], res["cpu"]
        ll_err = max(abs(u - v) / abs(v) for u, v in
                     zip(a.log_likelihoods, b.log_likelihoods))
        f_err = max(float((u.cpu() - v).abs().max())
                    for u, v in zip(a.factors, b.factors))
        # 1e-5: the Φ terms round alike; the sums of λ and of the
        # log-likelihood run in another order on the card.
        if (a.n_inner_total != b.n_inner_total or ll_err > 1e-5
                or f_err > 1e-5):
            _fail(f"small CP-APR ({policy}) on the card {a.log_likelihoods} "
                  f"inner {a.n_inner_total} vs the CPU {b.log_likelihoods} "
                  f"inner {b.n_inner_total}; factor error {f_err}")
        print(f"chip_smoke: small CP-APR ({policy}) log-likelihoods on the "
              f"card {a.log_likelihoods}, on the CPU {b.log_likelihoods}; "
              f"largest relative difference {ll_err}, factors {f_err}")
        out[policy] = {"ll_cuda": a.log_likelihoods,
                       "ll_cpu": b.log_likelihoods, "ll_rel_err": ll_err,
                       "factor_err": f_err, "n_inner": a.n_inner_total}
    return out


def _chunk_layouts(block_m: int, rng) -> dict:
    """Row multiplicities of the out-of-core adversarial layouts
    (tests/test_outofcore.py), over 29 rows."""
    mixed = rng.integers(0, 2 * block_m, size=29)
    mixed[0] += 1
    heavy = np.zeros(29, dtype=np.int64)
    heavy[rng.choice(29, size=3, replace=False)] = rng.integers(
        block_m, 3 * block_m, size=3)
    return {"span_all_chunks": np.eye(29, dtype=np.int64)[7]
            * (5 * block_m + 3),
            "distinct": np.ones(29, dtype=np.int64),
            "duplicates_heavy": heavy, "mixed": mixed}


@_index_order()
def check_chunk_kernels(m, hs, B, fs, block_m, chunk_m, policy,
                        label: str, r_block: int = 4,
                        threads: int = 64) -> dict:
    """K8 (policy None; rank tile ``r_block``) or K9 against its plain
    version chunk by chunk, CTAs of ``threads``, chaining the kernel's
    carry: out and carry value close, carry row equal; a second launch
    equal bit for bit."""
    ops, kori = m["ops"], m["kori"]
    enc, mode = hs.meta.enc, hs.mode
    n = hs.padded_len(block_m)
    R = fs[0].shape[1]
    out = torch.zeros((enc.dims[mode], R), device=DEVICE)
    crow = torch.full((1,), -1, dtype=torch.int32, device=DEVICE)
    cval = torch.zeros((1, R), device=DEVICE)
    bounds = ops._chunk_bounds(n, chunk_m)
    err = 0.0
    for i, (s, e) in enumerate(bounds):
        rows, words, values = (t.to(DEVICE) for t in hs.chunk(s, e))
        final = i == len(bounds) - 1
        if policy is None:
            args = (enc, mode, rows, words, values, fs)
            got = kori.carry_chunk(*args, out.clone(), crow, cval,
                                   block_m=block_m, r_block=r_block,
                                   threads=threads, final=final)
            want = kori.carry_chunk_plain(*args, out.clone(), crow, cval,
                                          block_m, final)
        else:
            kw = ({"pi": m["ops"].pi_rows(enc, words, fs, mode)}
                  if policy == "pre" else {"factors": fs})
            args = (enc, mode, 1e-10, rows, words, values, B)
            got = kori.phi_carry_chunk(*args, out.clone(), crow, cval, **kw,
                                       block_m=block_m, threads=threads,
                                       final=final)
            want = kori.phi_carry_chunk_plain(*args, out.clone(), crow, cval,
                                              **kw, block_m=block_m,
                                              final=final)
        if policy is None:
            again = kori.carry_chunk(*args, out.clone(), crow, cval,
                                     block_m=block_m, r_block=r_block,
                                     threads=threads, final=final)
        else:
            again = kori.phi_carry_chunk(*args, out.clone(), crow, cval,
                                         **kw, block_m=block_m,
                                         threads=threads, final=final)
        _sync()
        for a, b, what in zip(got, again, ("out", "carry_row", "carry_val")):
            _check_equal(f"{label} chunk {i} repeat {what}", a, b)
        _check_equal(f"{label} chunk {i} carry_row", got[1], want[1])
        err = max(err, _check_close(f"{label} chunk {i} out", got[0],
                                    want[0]),
                  _check_close(f"{label} chunk {i} carry_val", got[2],
                               want[2]))
        out, crow, cval = got
    return {"phi_carry_chunk" if policy else "carry_chunk": err}


def phase_small_chunks(m) -> dict:
    """The chunk kernels on the out-of-core adversarial layouts: K8 and K9
    (both Π policies) against their plain versions, the chunked ops equal
    to in-core K1 / K5 bit for bit (chunks of 1, 2 and 3 blocks, a run
    spanning every chunk), equal bits on a rerun, and a spilled stream
    (staged through pinned memory) equal to the pinned one."""
    dims = (29, 13, 7)
    ops, stream = m["ops"], m["stream"]
    worst = {}
    spill = ROOT / "build" / "chip_smoke_spill"
    for block_m in (8, 64):
        rng = np.random.default_rng(100 + block_m)
        for name, counts in _chunk_layouts(block_m, rng).items():
            x = _stream_tensor(counts, dims, seed=block_m)
            x.values[:] = np.abs(x.values) + 1.0       # counts are > 0
            at = m["alto"].build_device(x, n_partitions=2)
            fs = _factors(dims, seed=block_m)
            B = fs[0] * 3.0
            view = m["alto"].oriented_view_device(at, 0)
            hs = stream.host_stream(at, 0)
            if not hs.pinned:
                _fail("a host stream of a card tensor is not pinned")
            pi = m["ops"].pi_rows(at.meta.enc, view.words, fs, 0)
            k1 = ops.mttkrp_oriented_carry(view, fs, block_m, 4, 64)
            k5 = {"pre": ops.cpapr_phi_oriented_carry(
                      view, B, pi=pi, block_m=block_m, threads=64),
                  "otf": ops.cpapr_phi_oriented_carry(
                      view, B, factors=fs, block_m=block_m, threads=64)}
            for cb in (1, 2, 3):
                cm = cb * block_m
                label = f"chunks {name} block_m={block_m} chunk={cb} blocks"
                errs = check_chunk_kernels(m, hs, B, fs, block_m, cm, None,
                                           label)
                got = ops.mttkrp_oriented_chunked(hs, fs, chunk_m=cm,
                                                  block_m=block_m,
                                                  r_block=4, threads=64)
                _check_equal(f"{label} K8 chunked vs K1", got, k1)
                _check_equal(f"{label} K8 chunked repeat", got,
                             ops.mttkrp_oriented_chunked(
                                 hs, fs, chunk_m=cm, block_m=block_m,
                                 r_block=4, threads=64))
                for policy in ("pre", "otf"):
                    errs.update(check_chunk_kernels(
                        m, hs, B, fs, block_m, cm, policy,
                        f"{label} {policy}"))
                    got = ops.cpapr_phi_oriented_chunked(
                        hs, B, fs, pre=policy == "pre", chunk_m=cm,
                        block_m=block_m, threads=64)
                    _check_equal(f"{label} {policy} K9 chunked vs K5", got,
                                 k5[policy])
                    _check_equal(f"{label} {policy} K9 chunked repeat", got,
                                 ops.cpapr_phi_oriented_chunked(
                                     hs, B, fs, pre=policy == "pre",
                                     chunk_m=cm, block_m=block_m,
                                     threads=64))
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
            mapped = stream.to_memmap(hs, spill / f"{name}-{block_m}")
            _check_equal(f"chunks {name} block_m={block_m} spilled stream",
                         ops.mttkrp_oriented_chunked(
                             mapped, fs, chunk_m=block_m, block_m=block_m,
                             r_block=4, threads=64), k1)
    print(f"chip_smoke: small chunk layouts ok, worst errors {worst}")
    return worst


# ---------------------------------------------------------------------------
# Main path runs
# ---------------------------------------------------------------------------

def als_kernels(m, p) -> set:
    """The kernels a CP-ALS sweep under plan ``p`` launches."""
    trav = m["heuristics"].Traversal
    kernels_of = {trav.ORIENTED_CARRY: {"carry_runs", "carry_fixup"},
                  trav.OUTPUT_ORIENTED: {"oriented_partials", "segment_split",
                                         "carry_fixup"},
                  trav.RECURSIVE: {"recursive_partials"}}
    if p.streaming is not None:
        kernels_of[trav.ORIENTED_CARRY] = {"carry_chunk"}
    return set().union(*(kernels_of[mp.traversal] for mp in p.modes))


def apr_kernels(m, p) -> set:
    """The kernels a CP-APR run under plan ``p`` launches."""
    trav = m["heuristics"].Traversal
    kernels_of = {trav.ORIENTED_CARRY: {"phi_carry_runs", "carry_fixup"},
                  trav.OUTPUT_ORIENTED: {"phi_oriented_partials",
                                         "segment_split", "carry_fixup"},
                  trav.RECURSIVE: {"phi_partials", "carry_fixup"}}
    if p.streaming is not None:
        kernels_of[trav.ORIENTED_CARRY] = {"phi_carry_chunk"}
    # K4: the log-likelihood; pi_rows: Π under PRE
    pre = {"pi_rows"} if p.pi_policy.value == "pre" else set()
    return set().union(*(kernels_of[mp.traversal] for mp in p.modes),
                       {"delinearize"}, pre)


def jax_routing(m, p):
    """``p`` with every mode on the one-hot partials (K2, the split, the
    fix-up): the JAX package's routing of DARPA, whose TPU VMEM gate
    sends every mode there. At equal tiles it gives the port's bits."""
    trav = m["heuristics"].Traversal
    return dataclasses.replace(p, modes=tuple(
        dataclasses.replace(mp, traversal=trav.OUTPUT_ORIENTED)
        for mp in p.modes))


def run_cp_als(m, at, p, n_iters: int, label: str) -> dict:
    """One counted CP-ALS run through the user entry points."""
    b = m["build"]
    expect = als_kernels(m, p)
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
    split = iteration_split(m, at, p, res, fit=p.streaming is None)
    print(f"chip_smoke: {label}: traversals {p.traversals()} fits {fits} "
          f"in {seconds:.3f} s; launches {counts['launches']}; one more "
          f"iteration: {split}")
    return {"traversals": p.traversals(), "fits": fits, "seconds": seconds,
            "launches": counts["launches"], "elements": counts["elements"],
            "res": res, **split}


def iteration_split(m, at, p, res, fit: bool = True) -> dict:
    """Seconds of one more sweep on the card (MTTKRPs + dense algebra)
    and (``fit``) of its float64 fit on the card, up to the fit's copy to
    the host, from the run's final state."""
    cp = m["cpals"]
    views = m["plan"].build_views(at, p)
    normX2 = float((at.values.double() ** 2).sum())
    _sync()
    t0 = time.perf_counter()
    fs, lam, M = cp._sweep(p, at, views, res.factors, res.lam)
    _sync()
    sweep_s = time.perf_counter() - t0
    if not fit:
        return {"sweep_s": sweep_s}
    t0 = time.perf_counter()
    cp._fit(M, fs, lam, normX2)        # returns a float: synchronized
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
    p = m["plan"].plan_for(at, RANK)
    port = run_cp_als(m, at, p, 3, "darpa cp_als (port plan)")
    # At equal tiles the JAX package's routing must give the same fits bit
    # for bit.
    onehot = run_cp_als(m, at, jax_routing(m, p), 3,
                        "darpa cp_als (one-hot routing)")
    if port["fits"] != onehot["fits"]:
        _fail(f"darpa fits differ between carry and one-hot routing: "
              f"{port['fits']} vs {onehot['fits']}")
    return {"at": at, "plan": p, "run": port, "onehot_run": onehot,
            "gen_s": gen_s, "build_s": build_s, "nnz": at.meta.nnz,
            "fiber_reuse": at.meta.fiber_reuse, "x": x}


def run_cp_apr(m, at, p, k_max: int, label: str) -> dict:
    """One counted CP-APR run through the user entry points."""
    b = m["build"]
    expect = apr_kernels(m, p)
    _sync()
    b.reset_counts()
    t0 = time.perf_counter()
    res = m["cpapr"].cp_apr(at, RANK, _apr_params(m, k_max), seed=0,
                            track_ll=True, plan=p)
    _sync()
    seconds = time.perf_counter() - t0
    counts = b.counts()
    _check_apr_result(label, res, k_max)
    lls, kkts = res.log_likelihoods, res.kkt_violations
    for k in expect:
        if counts["launches"][k] == 0:
            _fail(f"{label}: kernel {k} was never launched")
    if any(counts["plain_on_cuda"].values()):
        _fail(f"{label}: plain versions ran on CUDA tensors: "
              f"{counts['plain_on_cuda']}")
    phi_ms = phi_mode_times(m, at, p, res)
    info = {"traversals": p.traversals(), "pi_policy": res.pi_policy,
            "log_likelihoods": lls, "kkt_violations": kkts,
            "seconds": seconds, "n_outer": res.n_outer,
            "s_per_outer": seconds / res.n_outer,
            "n_inner_total": res.n_inner_total,
            "phi_ms_per_mode": phi_ms,
            "launches": counts["launches"], "elements": counts["elements"]}
    print(f"chip_smoke: {label}: traversals {p.traversals()} "
          f"{res.pi_policy}; {res.n_outer} outer iterations in "
          f"{seconds:.3f} s ({seconds / res.n_outer:.3f} s each, "
          f"log-likelihood included), {res.n_inner_total} inner; Φ ms per "
          f"mode {phi_ms}; log-likelihoods {lls}; KKT {kkts}; launches "
          f"{counts['launches']}")
    return {**info, "res": res}


def phi_mode_times(m, at, p, res) -> list[float]:
    """ms of one execute_phi per mode from the run's final state, as the
    inner loop calls it (in core, Π built beforehand under PRE; streamed,
    each chunk's Π inside the call)."""
    views = m["plan"].build_views(at, p)
    out = []
    for n in range(len(at.dims)):
        B = res.factors[n] * res.lam[None, :]
        view = views.get(n)
        oriented = view is not None and m["heuristics"].is_oriented(
            p.modes[n].traversal)
        if p.streaming is not None and oriented:
            out.append(_ms(m, m["plan"].execute_phi, p, at, view, B, n,
                           res.factors, None, 1e-10,
                           res.pi_policy == "pre", iters=5))
            continue
        operands = _phi_operands(m, at.meta.enc,
                                 view.words if oriented else at.words,
                                 res.factors, n, res.pi_policy)
        out.append(_ms(m, m["plan"].execute_phi, p, at, view, B, n,
                       operands.get("factors"), operands.get("pi"),
                       iters=5))
        del operands
    return out


def phase_chicago_apr(m, chicago) -> dict:
    at, p = chicago["at"], chicago["plan"]
    if p.pi_policy.value != "otf":
        _fail(f"chicago Π policy {p.pi_policy.value}, expected otf")
    first = run_cp_apr(m, at, p, 5, "chicago cp_apr")
    again = run_cp_apr(m, at, p, 5, "chicago cp_apr (rerun)")
    if (first["log_likelihoods"] != again["log_likelihoods"]
            or first["kkt_violations"] != again["kkt_violations"]
            or not all(torch.equal(a, b) for a, b in
                       zip(first["res"].factors, again["res"].factors))):
        _fail("chicago cp_apr rerun differs from the first run")
    return {"run": first, "rerun_launches": again["launches"]}


def phase_darpa_apr(m, darpa) -> dict:
    at, p = darpa["at"], darpa["plan"]
    if p.pi_policy.value != "pre":
        _fail(f"darpa Π policy {p.pi_policy.value}, expected pre")
    port = run_cp_apr(m, at, p, 2, "darpa cp_apr (port plan)")
    onehot = run_cp_apr(m, at, jax_routing(m, p), 2,
                        "darpa cp_apr (one-hot routing)")
    if (port["log_likelihoods"] != onehot["log_likelihoods"]
            or port["kkt_violations"] != onehot["kkt_violations"]):
        _fail(f"darpa cp_apr differs between K5 and K6 routing: "
              f"{port['log_likelihoods']} {port['kkt_violations']} vs "
              f"{onehot['log_likelihoods']} {onehot['kkt_violations']}")
    return {"run": port, "onehot_run": onehot}


def streamed_plan(m, meta, chunks: int = 8):
    """The plan under a device budget that holds the chunk-independent
    residency and two chunks of about ``1/chunks`` of the stream."""
    pm = m["plan"]
    L = m["heuristics"].stream_len(meta)
    budget = (pm.streaming_resident_bytes(meta, RANK)
              + 2 * pm.stream_elem_bytes(meta) * -(-L // chunks))
    ps = pm.make_plan(meta, RANK, device_bytes=budget)
    if ps.streaming is None:
        _fail(f"budget {budget} did not make the plan stream")
    return ps


def _streamed_views(m, at, ps) -> tuple[dict, float]:
    """The host streams of a streaming plan, built with the view cache
    cleared (in-core views and host streams would evict each other under
    its byte bound)."""
    m["views"].cache_clear()
    t0 = time.perf_counter()
    hs = m["plan"].build_views(at, ps)
    _sync()
    return hs, time.perf_counter() - t0


def _copy_ms(m, hs) -> tuple[float, float]:
    """ms of one pinned host-to-device copy of a whole host stream (the
    library yardstick of the chunk copies), and its GB/s."""
    srcs = (hs.rows, hs.words, hs.values)
    dsts = [torch.empty_like(t, device=DEVICE) for t in srcs]

    def copy():
        for d, t in zip(dsts, srcs):
            d.copy_(t, non_blocking=True)
    ms = _ms(m, copy)
    return ms, hs.nbytes() / (ms * 1e-3) / 1e9


def chunk_breakdown(m, hs, sp, mp, res) -> dict:
    """ms of the steps a streamed Φ under ALTO-PRE takes for one full
    chunk (the first of the stream): its host-to-device copy, K4 on its
    words, its Π rows from those coordinates (`core.mttkrp.krp_rows`:
    PyTorch gathers) and from the words (`ops.pi_rows`, the main path);
    and K9 under ALTO-OTF on the same chunk, which gathers the factors
    itself."""
    ops, enc, mode = m["ops"], hs.meta.enc, hs.mode
    src = hs.chunk(0, sp.chunk_m)
    dev = [t.to(DEVICE) for t in src]

    def copy():
        for d, t in zip(dev, src):
            d.copy_(t, non_blocking=True)
    coords = ops.delinearize(enc, dev[1])
    B = res.factors[mode] * res.lam[None, :]
    out = torch.zeros_like(B)
    crow = torch.full((1,), -1, dtype=torch.int32, device=DEVICE)
    cval = torch.zeros((1, B.shape[1]), device=DEVICE)
    return {"copy": _ms(m, copy),
            "delinearize": _ms(m, ops.delinearize, enc, dev[1]),
            "krp_rows": _ms(m, lambda: m["mttkrp"].krp_rows(
                coords, res.factors, mode).contiguous()),
            "pi_rows": _ms(m, ops.pi_rows, enc, dev[1], res.factors, mode),
            "k9_otf": _ms(m, m["kori"].phi_carry_chunk, enc, mode, 1e-10,
                          *dev, B, out, crow, cval, res.factors, None,
                          mp.block_m, mp.threads, False)}


def _peak_above(base: int) -> int:
    return torch.cuda.max_memory_allocated() - base


def check_streamed_mode(m, at, ps, hs, als_res, apr_res, mode: int) -> int:
    """At real size: chunked MTTKRP (K8) and chunked Φ under ALTO-PRE
    (K9) on one mode, called back to back with no host wait between the
    calls, each equal bit for bit to in-core K1 / K5 on the same state.
    Returns the number of chunked calls checked."""
    ops, mp, sp = m["ops"], ps.modes[mode], ps.streaming
    view = m["alto"].oriented_view_device(at, mode)
    fs = als_res.factors
    kw = dict(block_m=mp.block_m, threads=mp.threads)
    k1 = ops.mttkrp_oriented_carry(view, fs, r_block=mp.r_block, **kw)
    outs = [ops.mttkrp_oriented_chunked(hs[mode], fs, chunk_m=sp.chunk_m,
                                        r_block=mp.r_block, **kw)
            for _ in range(3)]
    for o in outs:
        _check_equal(f"darpa mode {mode} chunked MTTKRP vs K1", o, k1)
    del outs, k1
    pfs = apr_res.factors
    B = pfs[mode] * apr_res.lam[None, :]
    k5 = ops.cpapr_phi_oriented_carry(
        view, B, pi=m["ops"].pi_rows(at.meta.enc, view.words, pfs, mode), **kw)
    outs = [ops.cpapr_phi_oriented_chunked(hs[mode], B, pfs, pre=True,
                                           chunk_m=sp.chunk_m, **kw)
            for _ in range(3)]
    for o in outs:
        _check_equal(f"darpa mode {mode} chunked Φ (pre) vs K5", o, k5)
    return 6


def phase_darpa_streamed(m, darpa, darpa_apr) -> dict:
    """DARPA under a device budget of about 1/8 of a mode's stream per
    chunk: CP-ALS (2 iterations) and CP-APR under ALTO-PRE (2 outer)
    through K8 / K9, bit for bit the in-core runs of the same plan."""
    at, pm, ops = darpa["at"], m["plan"], m["ops"]
    meta = at.meta
    ps = streamed_plan(m, meta)
    sp = ps.streaming
    if dataclasses.replace(ps, streaming=None) != darpa["plan"]:
        _fail(f"darpa streamed plan {ps} is not the in-core plan streamed")
    print(f"chip_smoke: darpa streamed: device_bytes {sp.device_bytes}, "
          f"chunk_m {sp.chunk_m}, n_chunks {sp.n_chunks}, in-core working "
          f"set {sp.stream_bytes}")
    hs, stream_s = _streamed_views(m, at, ps)
    ops.chunk_stats_clear()
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    als = run_cp_als(m, at, ps, 2, "darpa cp_als (streamed)")
    als_peak = _peak_above(base)
    if als["fits"] != darpa["run"]["fits"][:2]:
        _fail(f"darpa streamed fits {als['fits']} vs in-core "
              f"{darpa['run']['fits'][:2]}")
    stats = ops.chunk_stats()
    torch.cuda.reset_peak_memory_stats()
    apr = run_cp_apr(m, at, ps, 2, "darpa cp_apr (streamed)")
    apr_peak = _peak_above(base)
    ref = darpa_apr["run"]
    if (apr["log_likelihoods"] != ref["log_likelihoods"]
            or apr["kkt_violations"] != ref["kkt_violations"]):
        _fail(f"darpa streamed cp_apr {apr['log_likelihoods']} "
              f"{apr['kkt_violations']} vs in-core {ref['log_likelihoods']} "
              f"{ref['kkt_violations']}")
    if apr["pi_policy"] != "pre":
        _fail(f"darpa streamed cp_apr ran {apr['pi_policy']}, not pre")
    back_to_back = check_streamed_mode(m, at, ps, hs, als["res"],
                                       apr["res"], 2)
    mttkrp_ms = mode_times(m, at, ps, hs, als["res"].factors)
    copy_ms, copy_gbs = _copy_ms(m, hs[2])
    chunk_ms = chunk_breakdown(m, hs[2], sp, ps.modes[2], apr["res"])
    model = pm.chunk_hbm_bytes(meta, sp.chunk_m, RANK)
    info = {"device_bytes": sp.device_bytes, "chunk_m": sp.chunk_m,
            "n_chunks": sp.n_chunks, "stream_build_s": stream_s,
            "chunk_stats_cp_als": stats,
            "chunk_hbm_bytes": model, "peak_above_base_cp_als": als_peak,
            "peak_above_base_cp_apr": apr_peak,
            "mttkrp_ms_per_mode": mttkrp_ms,
            "copy_ms_mode2": copy_ms, "copy_gb_per_s": copy_gbs,
            "stream_bytes_mode2": hs[2].nbytes(),
            "host_pinned_bytes": sum(h.nbytes() for h in hs.values()),
            "pre_chunk_ms": chunk_ms,
            "back_to_back_calls": back_to_back}
    print(f"chip_smoke: darpa streamed: fits {als['fits']} equal the "
          f"in-core run's; cp_apr log-likelihoods and KKT equal the in-core "
          f"run's; chunked MTTKRP ms per mode {mttkrp_ms}; copy of mode 2's "
          f"stream alone {copy_ms:.3f} ms ({copy_gbs:.1f} GB/s); chunk stats "
          f"{stats}; one chunk under ALTO-PRE, ms: {chunk_ms}; peak "
          f"device memory above the tensor and results "
          f"{als_peak / 1e9:.3f} GB (CP-ALS), {apr_peak / 1e9:.3f} GB "
          f"(CP-APR) vs chunk_hbm_bytes {model / 1e9:.3f} GB; pinned host "
          f"streams {info['host_pinned_bytes'] / 1e9:.3f} GB")
    return {"plan": ps, "streams": hs, "run": als, "apr_run": apr,
            **info}


def phase_chicago_streamed(m, chicago) -> dict:
    """Chicago under a budget of about 1/8 of a mode's stream per chunk:
    CP-APR under ALTO-OTF (2 outer iterations, K9 gathering the factors)
    bit for bit the in-core run of the same all-carry plan."""
    at = chicago["at"]
    ps = streamed_plan(m, at.meta)
    if ps.pi_policy.value != "otf":
        _fail(f"chicago streamed Π policy {ps.pi_policy.value}, not otf")
    m["views"].cache_clear()
    incore = run_cp_apr(m, at, dataclasses.replace(ps, streaming=None), 2,
                        "chicago cp_apr (all carry, in core)")
    hs, stream_s = _streamed_views(m, at, ps)
    apr = run_cp_apr(m, at, ps, 2, "chicago cp_apr (streamed)")
    if (apr["log_likelihoods"] != incore["log_likelihoods"]
            or apr["kkt_violations"] != incore["kkt_violations"]
            or not all(torch.equal(a, b) for a, b in
                       zip(apr["res"].factors, incore["res"].factors))):
        _fail(f"chicago streamed cp_apr {apr['log_likelihoods']} vs in-core "
              f"{incore['log_likelihoods']}")
    sp = ps.streaming
    print(f"chip_smoke: chicago streamed: chunk_m {sp.chunk_m}, n_chunks "
          f"{sp.n_chunks}; cp_apr equal to the in-core all-carry run")
    return {"chunk_m": sp.chunk_m, "n_chunks": sp.n_chunks,
            "stream_build_s": stream_s, "run": apr, "incore_run": incore}


# ---------------------------------------------------------------------------
# Measured plans: the tuner, the search, and the tilings they pick
# ---------------------------------------------------------------------------

def _gene(mp) -> dict:
    return {"traversal": mp.traversal.value, "r_block": mp.r_block,
            "block_m": mp.block_m, "threads": mp.threads}


def _timing(c) -> dict:
    return {"traversal": c.traversal, "r_block": c.r_block,
            "block_m": c.block_m, "threads": c.threads,
            "ms": c.median_s * 1e3, "iqr_ms": c.iqr_s * 1e3}


def tune_exhaustive(m, at, label: str, store, objective: str) -> dict:
    """`autotune.tune_plan` at its defaults — the call `make_plan(...,
    tune="auto", at=at)` makes on a store miss: every mode's deduped list
    capped at `DEFAULT_MAX_CANDIDATES`, every traversal family in it. Per
    mode the static gene, the fastest candidate and the winner (the
    static gene unless the fastest beats it beyond the noise) with their
    medians and IQRs and the mode's seconds; then ``tune="force"`` and
    ``tune="auto"`` are store hits with zero timing runs that return the
    same plan."""
    at_mod, ops = m["autotune"], m["ops"]
    t0 = time.perf_counter()
    plan, rep = at_mod.tune_plan(at, RANK, objective=objective,
                                 store_path=store)
    seconds = time.perf_counter() - t0
    modes = []
    for mr, mp in zip(rep.modes, plan.modes):
        best, static = mr.best, mr.static
        if best.median_s > static.median_s or (
                mp.traversal.value, mp.r_block, mp.block_m, mp.threads) != (
                best.traversal, best.r_block, best.block_m, best.threads):
            _fail(f"{label} mode {mr.mode}: winner {best} (plan {mp}) "
                  f"slower than the static gene {static} or not the plan's")
        fams = {c.traversal for c in mr.candidates}
        if len(mr.candidates) > 1 and "oriented_carry" not in fams:
            _fail(f"{label} mode {mr.mode}: no carry candidate in {fams}")
        modes.append({"mode": mr.mode, "candidates": len(mr.candidates),
                      "families": sorted(fams), "seconds": mr.seconds,
                      "static": _timing(static),
                      "fastest": _timing(mr.fastest),
                      "winner": _timing(best),
                      "timings_ms": [
                          [c.traversal, c.r_block, c.block_m, c.threads,
                           c.median_s * 1e3, c.iqr_s * 1e3]
                          for c in mr.candidates]})
    runs = ops.timing_runs()
    hits = [m["plan"].make_plan(at.meta, RANK, device=at.device,
                                tune="force", tune_objective=objective,
                                store_path=store),
            m["plan"].make_plan(at.meta, RANK, tune="auto", at=at,
                                tune_objective=objective, store_path=store)]
    if ops.timing_runs() != runs or any(h != plan for h in hits):
        _fail(f"{label}: tune='force'/'auto' after tuning was not a store "
              f"hit ({ops.timing_runs() - runs} timing runs)")
    for e in modes:
        print(f"chip_smoke: {label} mode {e['mode']} ({e['candidates']} "
              f"candidates of {e['families']}, {e['seconds']:.2f} s): "
              f"static {e['static']} -> winner {e['winner']} (fastest "
              f"{e['fastest']})")
    print(f"chip_smoke: {label}: tuned in {seconds:.1f} s; tune='force' "
          f"and tune='auto' are store hits with 0 timing runs")
    return {"plan": plan, "seconds": seconds, "modes": modes}


def _relative(a, b) -> float:
    return max(abs(u - v) / abs(v) for u, v in zip(a, b))


def tuned_cp_als(m, at, tuned, static_run, n_iters: int, label: str) -> dict:
    """CP-ALS on a tuned plan (the counted checks of `run_cp_als`), fits
    within 1e-4 of the static plan's run from the same start."""
    run = run_cp_als(m, at, tuned, n_iters, label)
    err = max(abs(a - b) for a, b in zip(run["fits"], static_run["fits"]))
    if err > 1e-4:
        _fail(f"{label}: fits {run['fits']} vs the static plan's "
              f"{static_run['fits']}")
    print(f"chip_smoke: {label}: sweep {run['sweep_s'] * 1e3:.3f} ms vs "
          f"{static_run['sweep_s'] * 1e3:.3f} ms on the static plan; fits "
          f"within {err:.2e} of the static run")
    return {**{k: v for k, v in run.items() if k != "res"},
            "static_sweep_s": static_run["sweep_s"], "fit_diff": err}


def tuned_cp_apr(m, at, tuned, static_run, k_max: int, label: str) -> dict:
    """CP-APR on a Φ-tuned plan, log-likelihoods within 1e-5 relative of
    the static plan's run."""
    run = run_cp_apr(m, at, tuned, k_max, label)
    err = _relative(run["log_likelihoods"], static_run["log_likelihoods"])
    if err > 1e-5:
        _fail(f"{label}: log-likelihoods {run['log_likelihoods']} vs the "
              f"static plan's {static_run['log_likelihoods']}")
    print(f"chip_smoke: {label}: Φ ms per mode {run['phi_ms_per_mode']} vs "
          f"{static_run['phi_ms_per_mode']} on the static plan; "
          f"log-likelihoods within {err:.2e} relative")
    return {**_apr_detail(run), "static_s_per_outer":
            static_run["s_per_outer"], "ll_rel_diff": err}


def search_darpa(m, darpa, d_str, store) -> dict:
    """The budgeted search on DARPA in core (12 runs, seed 0; the model
    warmed by the tuner's samples in the store), then under phase 7's
    device budget over chunk_m, block_m and the rank tile; the searched
    streaming plan's CP-ALS fits equal an in-core run of the same tiles
    bit for bit."""
    sr, ops = m["search"], m["ops"]
    at = darpa["at"]
    before = ops.timing_runs()
    t0 = time.perf_counter()
    plan, rep = sr.search_plan(at, RANK, budget_runs=12, seed=0,
                               store_path=store)
    seconds = time.perf_counter() - t0
    if (rep.runs_used > 12 or ops.timing_runs() - before != rep.runs_used
            or not rep.model_used):
        _fail(f"darpa search: {rep.runs_used} runs, counter "
              f"{ops.timing_runs() - before}, model used {rep.model_used}")
    print(f"chip_smoke: darpa search: {rep.runs_used} runs in {seconds:.1f} "
          f"s, model of {rep.model_samples} samples; winners "
          f"{[dataclasses.asdict(w) for w in rep.winners]}")
    budget = d_str["device_bytes"]
    before = ops.timing_runs()
    t0 = time.perf_counter()
    ps, srep = sr.search_plan(at, RANK, device_bytes=budget, budget_runs=28,
                              seed=0, store_path=store)
    s_seconds = time.perf_counter() - t0
    if ps.streaming is None or ps.streaming.n_chunks < 2:
        _fail(f"darpa streaming search gave {ps.streaming}")
    static_ps = d_str["plan"]
    hs, _ = _streamed_views(m, at, ps)
    streamed = run_cp_als(m, at, ps, 2, "darpa cp_als (searched, streamed)")
    twin = run_cp_als(m, at, dataclasses.replace(ps, streaming=None), 2,
                      "darpa cp_als (searched tiles, in core)")
    if streamed["fits"] != twin["fits"]:
        _fail(f"darpa searched streamed fits {streamed['fits']} vs its "
              f"in-core twin {twin['fits']}")
    fs = streamed["res"].factors
    ms = mode_times(m, at, ps, hs, fs)
    static_ms = mode_times(m, at, static_ps, hs, fs)   # the same streams
    print(f"chip_smoke: darpa streaming search: {srep.runs_used} runs in "
          f"{s_seconds:.1f} s; chunk_m {ps.streaming.chunk_m} "
          f"({ps.streaming.n_chunks} chunks; ladder times "
          f"{srep.chunk_times}), block_m {[mp.block_m for mp in ps.modes]}, "
          f"r_block {[mp.r_block for mp in ps.modes]}; chunked MTTKRP ms "
          f"per mode {ms} vs {static_ms} on the static streaming plan "
          f"(chunk_m {static_ps.streaming.chunk_m}); streamed fits "
          f"{streamed['fits']} equal the in-core twin's")
    return {"plan": plan, "streaming_plan": ps, "seconds": seconds,
            "runs_used": rep.runs_used,
            "measured_s": rep.seconds_used,
            "model_samples": rep.model_samples,
            "winners": [dataclasses.asdict(w) for w in rep.winners],
            "streaming": {"seconds": s_seconds,
                          "runs_used": srep.runs_used,
                          "measured_s": srep.seconds_used,
                          "chunk_m": ps.streaming.chunk_m,
                          "n_chunks": ps.streaming.n_chunks,
                          "chunk_times": srep.chunk_times,
                          "modes": [_gene(mp) for mp in ps.modes],
                          "chunked_ms_per_mode": ms,
                          "static_chunk_m": static_ps.streaming.chunk_m,
                          "static_chunked_ms_per_mode": static_ms,
                          "fits": streamed["fits"],
                          "launches": streamed["launches"]}}


def phase_tilings(m, tilings) -> dict:
    """Every kernel of the main path at tilings ``(block_m, r_block,
    threads)`` it does not run at there, on the small adversarial layouts
    at rank `RANK`: K1, K2 + the split, K3, K5, K6, K7, K8 and K9 (both
    Π policies) against their plain versions (the checks of the small
    phases, CPU copies included), and the ops of one ``block_m`` equal
    bit for bit whatever their ``r_block`` and ``threads``."""
    dims = (29, 13, 7)
    ops, stream = m["ops"], m["stream"]
    worst = {}
    for block_m in sorted({t[0] for t in tilings}):
        here = sorted({t for t in tilings if t[0] == block_m})
        for name, counts in _small_layouts(block_m).items():
            x = _stream_tensor(counts, dims, seed=block_m)
            x.values[:] = np.abs(x.values) + 1.0       # counts are > 0
            at = m["alto"].build_device(x, n_partitions=4, device=DEVICE)
            fs = _factors(dims, seed=block_m)
            B = fs[0] * 3.0
            view = m["alto"].oriented_view_device(at, 0)
            hs = stream.host_stream(at, 0)
            pi_view = m["ops"].pi_rows(at.meta.enc, view.words, fs, 0)
            cm = 2 * block_m
            first = {}
            for _, rb, th in here:
                label = (f"tiling {name} block_m={block_m} r_block={rb} "
                         f"threads={th}")
                errs = check_oriented_kernels(m, view, fs, block_m, rb, th,
                                              label, cpu_copies=True)
                errs["recursive_partials"] = check_recursive_kernel(
                    m, at, fs, 0, rb, th, label, cpu_copies=True)
                errs.update(check_chunk_kernels(m, hs, B, fs, block_m, cm,
                                                None, label, r_block=rb,
                                                threads=th))
                for policy in ("otf", "pre"):
                    errs.update(check_phi_oriented_kernels(
                        m, view, B, _phi_operands(m, at.meta.enc, view.words,
                                                  fs, 0, policy),
                        block_m, th, f"{label} {policy}", cpu_copies=True))
                    errs.update(check_phi_recursive_kernel(
                        m, at, B, _phi_operands(m, at.meta.enc, at.words, fs,
                                                0, policy),
                        0, th, f"{label} {policy}", cpu_copies=True))
                    errs.update(check_chunk_kernels(
                        m, hs, B, fs, block_m, cm, policy,
                        f"{label} {policy}", threads=th))
                outs = {
                    "K1": ops.mttkrp_oriented_carry(view, fs, block_m, rb,
                                                    th),
                    "K2": ops.mttkrp_oriented(view, fs, block_m, rb, th),
                    "K3": ops.mttkrp(at, fs, 0, rb, th),
                    "K5": ops.cpapr_phi_oriented_carry(
                        view, B, pi=pi_view, block_m=block_m, threads=th),
                    "K6": ops.cpapr_phi_oriented(
                        view, B, pi=pi_view, block_m=block_m, threads=th),
                    "K7": ops.cpapr_phi(at, B, 0, factors=fs, threads=th),
                    "K8": ops.mttkrp_oriented_chunked(
                        hs, fs, chunk_m=cm, block_m=block_m, r_block=rb,
                        threads=th),
                    "K9": ops.cpapr_phi_oriented_chunked(
                        hs, B, fs, pre=True, chunk_m=cm, block_m=block_m,
                        threads=th)}
                for k, v in outs.items():
                    if k in first:
                        _check_equal(f"{label} {k} vs r_block={first[k][0]}"
                                     f" threads={first[k][1]}", v,
                                     first[k][2])
                    else:
                        first[k] = (rb, th, v)
                _check_equal(f"{label} K1 vs K2", outs["K1"], outs["K2"])
                _check_equal(f"{label} K5 vs K6", outs["K5"], outs["K6"])
                _check_equal(f"{label} K8 vs K1", outs["K8"], outs["K1"])
                _check_equal(f"{label} K9 vs K5", outs["K9"], outs["K5"])
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
    print(f"chip_smoke: {len(tilings)} tilings on the small layouts ok, "
          f"worst errors {worst}")
    return worst


def phase_tuning(m, chicago, darpa, chicago_apr, darpa_apr, d_str) -> dict:
    """The measured plans, with a plan store in a temporary directory:
    MTTKRP tuning of Chicago and DARPA and CP-ALS on the
    winners, Φ tuning and CP-APR on its winners, the budgeted search in
    core and streamed, then every kernel at the tilings this picked and
    at the extremes of the space (`phase_tilings`)."""
    import tempfile
    limit = m["common"].smem_limit(torch.device(DEVICE))
    if limit < m["plan"].SMEM_BYTES:
        _fail(f"the card's shared memory per CTA {limit} is below "
              f"plan.SMEM_BYTES {m['plan'].SMEM_BYTES}")
    t0 = time.perf_counter()
    out = {"smem_limit": limit}
    with tempfile.TemporaryDirectory(prefix="repro_torch_plans_") as d:
        store = pathlib.Path(d) / "plans.json"
        c_als = tune_exhaustive(m, chicago["at"], "chicago mttkrp tuning",
                                store, "mttkrp")
        d_als = tune_exhaustive(m, darpa["at"], "darpa mttkrp tuning",
                                store, "mttkrp")
        out["chicago_mttkrp"] = {**c_als, "cp_als": tuned_cp_als(
            m, chicago["at"], c_als["plan"], chicago["run"], 10,
            "chicago cp_als (tuned)")}
        out["darpa_mttkrp"] = {**d_als, "cp_als": tuned_cp_als(
            m, darpa["at"], d_als["plan"], darpa["run"], 3,
            "darpa cp_als (tuned)")}
        c_phi = tune_exhaustive(m, chicago["at"], "chicago phi tuning",
                                store, "phi")
        d_phi = tune_exhaustive(m, darpa["at"], "darpa phi tuning", store,
                                "phi")
        out["chicago_phi"] = {**c_phi, "cp_apr": tuned_cp_apr(
            m, chicago["at"], c_phi["plan"], chicago_apr["run"], 5,
            "chicago cp_apr (tuned)")}
        out["darpa_phi"] = {**d_phi, "cp_apr": tuned_cp_apr(
            m, darpa["at"], d_phi["plan"], darpa_apr["run"], 2,
            "darpa cp_apr (tuned)")}
        out["darpa_search"] = search_darpa(m, darpa, d_str, store)
        out["store_records"] = len(m["autotune"].load_store(store))
    tune_s = time.perf_counter() - t0
    plans = [out[k]["plan"] for k in ("chicago_mttkrp", "darpa_mttkrp",
                                      "chicago_phi", "darpa_phi",
                                      "darpa_search")]
    plans.append(out["darpa_search"]["streaming_plan"])
    tilings = {(8, RANK, 128), (1024, RANK, 128), (64, RANK, 128),
               (64, 1, 128), (64, 2, 128), (64, 4, 128), (64, RANK, 64),
               (64, RANK, 256)}
    tilings |= {(mp.block_m, mp.r_block, mp.threads)
                for p in plans for mp in p.modes}
    t0 = time.perf_counter()
    out["tilings"] = sorted(tilings)
    out["tilings_worst_err"] = phase_tilings(m, sorted(tilings))
    out["tilings_s"] = time.perf_counter() - t0
    out["tuning_s"] = tune_s
    for k in ("chicago_mttkrp", "darpa_mttkrp", "chicago_phi", "darpa_phi",
              "darpa_search"):
        out[k].pop("plan")
    out["darpa_search"].pop("streaming_plan")
    print(f"chip_smoke: tuning phase {tune_s:.1f} s, tilings "
          f"{out['tilings_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Shape-class buckets (batched CP-ALS / CP-APR on the tenant axis)
# ---------------------------------------------------------------------------

# Network-traffic tenants (source × destination × time window, one tensor
# per customer subnet and day) at DARPA-like proportions: dims and nnz
# drawn uniformly from each range with the class's seed.
BUCKET_CLASSES = {
    "A": dict(tenants=64, dims=((2049, 4096), (2049, 4096), (32769, 65536)),
              nnz=(131073, 262144), seed=101),
    "B": dict(tenants=16, dims=((16385, 32768), (16385, 32768),
                                (2097153, 4194304)),
              nnz=(32769, 65536), seed=202),
    # Crime tenants at Chicago's proportions (days × hours × community
    # areas × crime types, one tensor per district): short modes of high
    # fiber reuse, the recursive traversal's regime, from the seeded
    # `blocked_tensor` recipe of phase_chicago. Mode 0 starts past 4096
    # and nnz past 131072 and the duplicates the recipe drops, so every
    # tenant falls into the class (8192, 32, 128, 32) with 262,144.
    "C": dict(tenants=16, dims=((4097, 6186), (24, 24), (77, 77), (32, 32)),
              nnz=(135169, 262144), seed=303, generator="blocked_tensor",
              recipe=dict(block=16, n_blocks=64)),
}
CLASS_C_CAPACITIES = (16, 32)
SOLO_RTOL, SOLO_ATOL, SOLO_FIT, SOLO_LAM = 2e-4, 2e-5, 1e-6, 2e-4
DARPA_MODE2_GROWTH = 34_000_000    # past 2**25: the encoding gains a bit


def _bucket_tensors(m, spec) -> list:
    rng = np.random.default_rng(spec["seed"])
    make = getattr(m["synthetic"], spec.get("generator", "uniform_tensor"))
    xs = []
    for i in range(spec["tenants"]):
        dims = tuple(int(rng.integers(lo, hi + 1)) for lo, hi in spec["dims"])
        nnz = int(rng.integers(spec["nnz"][0], spec["nnz"][1] + 1))
        xs.append(make(dims, nnz, seed=spec["seed"] * 1000 + i,
                       count_data=True, **spec.get("recipe", {})))
    return xs


def _members(m, xs, sc, p):
    shc, alto = m["shapeclass"], m["alto"]
    ats, views = [], []
    for x in xs:
        at = shc.canonicalize_tensor(alto.build_device(
            shc.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False), sc)
        ats.append(at)
        views.append(m["plan"].build_views(at, p))
    return ats, views


def _bucket_kernels(m, p, apr: bool) -> dict:
    """Launches a bucket's sweep (CP-ALS) or mode pass of one inner step
    (CP-APR) makes per kernel: one per mode routed to it."""
    trav = m["heuristics"].Traversal
    per = {}
    for mp in p.modes:
        if mp.traversal is trav.RECURSIVE:        # K3 / K7, then the pull
            ks = ["phi_partials" if apr else "recursive_partials",
                  "carry_fixup"]
        elif mp.traversal is trav.ORIENTED_CARRY:
            ks = ["phi_carry_runs" if apr else "carry_runs", "carry_fixup"]
        else:
            ks = ["phi_oriented_partials" if apr else "oriented_partials",
                  "segment_split", "carry_fixup"]
        for k in ks:
            per[k] = per.get(k, 0) + 1
    return per


def _counted(m, label, fn, expect: set):
    b = m["build"]
    _sync()
    b.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    _sync()
    seconds = time.perf_counter() - t0
    counts = b.counts()
    for k in expect:
        if counts["launches"][k] == 0:
            _fail(f"{label}: kernel {k} was never launched")
    if any(counts["plain_on_cuda"].values()):
        _fail(f"{label}: plain versions ran on CUDA tensors: "
              f"{counts['plain_on_cuda']}")
    return res, seconds, counts


def _same_bits(label, got, solo, fields) -> None:
    for f in fields:
        if getattr(got, f) != getattr(solo, f):
            _fail(f"{label}: {f} {getattr(got, f)} vs solo "
                  f"{getattr(solo, f)}")
    for n, (a, b) in enumerate(zip(got.factors, solo.factors)):
        if not torch.equal(a, b[:a.shape[0]]):
            _fail(f"{label}: factor {n} differs from the solo run")
        if bool(b[a.shape[0]:].any()):
            _fail(f"{label}: padded rows of factor {n} are not zero")
    if not torch.equal(got.lam, solo.lam):
        _fail(f"{label}: λ differs from the solo run")


def _near(label, got, ref) -> float:
    worst = 0.0
    for n, (a, b) in enumerate(zip(got.factors, ref.factors)):
        if not torch.allclose(a, b, rtol=SOLO_RTOL, atol=SOLO_ATOL):
            _fail(f"{label}: factor {n} beyond rtol={SOLO_RTOL}, "
                  f"atol={SOLO_ATOL} of the unpadded run: "
                  f"{float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    if not torch.allclose(got.lam, ref.lam, rtol=SOLO_LAM, atol=0.0):
        _fail(f"{label}: λ beyond rtol={SOLO_LAM} of the unpadded run")
    return worst


def _nan(shape):
    return torch.full(shape, float("nan"), device="cuda")


@_index_order()
def _check_hand_off(m, label, got, K, plain_t, solo_t) -> tuple:
    """A bucket's hand-off to the fix-up (a runs pass or the split), ``got
    = (out, carry_row, carry_val)`` run into a NaN-filled ``out``, tenant
    by tenant against ``plain_t(t)``, the plain version's, and
    ``solo_t(t)``, the solo launch's into a NaN-filled ``out``: carry rows
    equal; NaN exactly at the carried pieces' rows (every other row
    written); ``out`` off those rows and the carry values within tolerance
    of the plain version and equal to the solo launch. Then the whole op:
    the stacked fix-up on ``got`` within tolerance of the plain fix-up on
    the plain hand-off, and equal to the solo fix-up on the solo one.
    Returns the largest differences from the plain version, of the
    hand-off (``out`` and carry values) and of the whole op."""
    kori = m["kori"]
    out, crow, cval = got
    fixed = kori.carry_fixup(crow, cval, out.clone())
    err = whole = 0.0
    for t in range(K):
        tag = f"{label} tenant {t}"
        p_out, p_crow, p_cval = plain_t(t)
        s_out, s_crow, s_cval = solo_t(t)
        _check_equal(f"{tag} carry_row", crow[t], p_crow)
        _check_equal(f"{tag} carry_row vs solo", crow[t], s_crow)
        _check_equal(f"{tag} carry_val vs solo", cval[t], s_cval)
        _check_equal(f"{tag} out vs solo", out[t].nan_to_num(7.0),
                     s_out.nan_to_num(7.0))
        carried = torch.zeros(out.shape[1], dtype=torch.bool,
                              device=out.device)
        carried[crow[t][crow[t] >= 0].long()] = True
        if not (bool(out[t][carried].isnan().all())
                and not bool(out[t][~carried].isnan().any())):
            _fail(f"{tag}: the rows written are not exactly the rows "
                  f"without a carried piece")
        err = max(err, _check_close(f"{tag} out", out[t][~carried],
                                    p_out[~carried]),
                  _check_close(f"{tag} carry_val", cval[t], p_cval))
        whole = max(whole, _check_close(
            f"{tag} with the fix-up", fixed[t],
            kori.carry_fixup_plain(p_crow, p_cval, p_out)))
        _check_equal(f"{tag} with the fix-up vs solo", fixed[t],
                     kori.carry_fixup(s_crow, s_cval, s_out))
    return err, whole


def check_tenant_kernels(m, p, ats, views, res_als, res_apr, label) -> list:
    """Each tenant-axis launch of the bucket's path, on its final state,
    against its plain version (tenant by tenant, on the card) within
    tolerance and against T solo launches bit for bit: the slots of K2 and
    K6 whole; the runs passes of K1 and K5 and the split of K2's and K6's
    slots by `_check_hand_off`, with the fix-up after them (the whole op);
    a recursive mode's K3, K7 and pull by `check_tenant_recursive`.
    Times of the stacked launch, the T solo launches, the plain version,
    the bound. A fix-up entry's ``max_abs_err`` is the whole op's, runs
    pass and fix-up against their plain versions."""
    kori, ops, batched = m["kori"], m["ops"], m["batched"]
    trav = m["heuristics"].Traversal
    K = len(ats)
    sc_dims = p.meta.dims
    fac = m["batched"].stack_tenants(
        [m["batched"].embed_factors(r.factors, sc_dims)
         for r in res_als.results])
    apr_fac = m["batched"].stack_tenants(
        [m["batched"].embed_factors(r.factors, sc_dims)
         for r in res_apr.results])
    lam = torch.stack([r.lam for r in res_apr.results])
    enc, R = p.meta.enc, p.rank
    out, rec = [], []
    for mp in p.modes:
        n = mp.mode
        if mp.traversal is trav.RECURSIVE:
            rec += check_tenant_recursive(m, p, ats, n, res_als, res_apr,
                                          label)
            continue
        vb = batched.stack_tenants([views[i][n] for i in range(K)])
        bm, th = mp.block_m, mp.threads
        rows, words, values, _ = ops.pad_sorted_stream(vb.rows, vb.words,
                                                       vb.values, bm)
        M = rows.shape[1]
        I_n = sc_dims[n]
        f = fac
        B = (apr_fac[n] * lam[:, None, :]).contiguous()
        if p.pi_policy.value == "pre":
            phi_op = dict(pi=ops.pad_sorted_stream(
                None, vb.words, None, bm,
                pi=ops.pi_rows(enc, vb.words, apr_fac, n))[3])
        else:
            phi_op = dict(factors=apr_fac)
        W = enc.n_words
        stream = K * M * (4 + 4 * W + 4)
        # Rows the stream touches, tenant by tenant: the factor rows a
        # gather must read once and the B rows of the Φ kernels.
        coords = ops.delinearize(enc, vb.words.reshape(-1, W)).reshape(
            K, -1, enc.ndim)
        touched = [sum(int(torch.unique(coords[t, :, k]).numel())
                       for t in range(K)) for k in range(enc.ndim)]
        del coords
        fbytes = sum(touched[k] for k in range(enc.ndim) if k != n) * R * 4
        b_rows = touched[n] * R * 4
        out_b = K * I_n * R * 4
        if "pi" in phi_op:
            out.append(check_tenant_pi_rows(
                m, label, enc, vb.words, apr_fac, n,
                vb.words.shape[:2].numel() * (W + R) * 4 + fbytes))
        carry = mp.traversal is trav.ORIENTED_CARRY
        cases = []
        if carry:
            cases.append(("carry_runs",
                          lambda *a, **k: kori.carry_runs(
                              enc, n, *a, bm, mp.r_block, th, **k),
                          lambda *a: kori.carry_runs_plain(enc, n, *a, bm),
                          (rows, words, values, f), stream + fbytes + out_b))
            cases.append(("phi_carry_runs",
                          lambda r, w, v, b, o, **k: kori.phi_carry_runs(
                              enc, n, 1e-10, r, w, v, b, block_m=bm,
                              threads=th, **{next(iter(phi_op)): o}, **k),
                          lambda r, w, v, b, o: kori.phi_carry_runs_plain(
                              enc, n, 1e-10, r, w, v, b, block_m=bm,
                              **{next(iter(phi_op)): o}),
                          (rows, words, values, B, next(iter(
                              phi_op.values()))),
                          stream + b_rows + out_b + (
                              K * M * R * 4 if "pi" in phi_op else fbytes)))
        else:
            cases.append(("oriented_partials",
                          lambda *a: kori.oriented_partials(
                              enc, n, *a, bm, mp.r_block, th),
                          lambda *a: kori.oriented_partials_plain(
                              enc, n, *a, bm),
                          (rows, words, values, f),
                          stream + fbytes + K * M * R * 4))
            cases.append(("phi_oriented_partials",
                          lambda r, w, v, b, o: kori.phi_oriented_partials(
                              enc, n, 1e-10, r, w, v, b, block_m=bm,
                              threads=th, **{next(iter(phi_op)): o}),
                          lambda r, w, v, b, o:
                          kori.phi_oriented_partials_plain(
                              enc, n, 1e-10, r, w, v, b, block_m=bm,
                              **{next(iter(phi_op)): o}),
                          (rows, words, values, B, next(iter(
                              phi_op.values()))),
                          stream + b_rows + K * M * R * 4 + (
                              K * M * R * 4 if "pi" in phi_op else fbytes)))
        at = m["common"].at_tenant
        for name, kern, plain, args, nbytes in cases:
            tag = f"{label} {name} mode {n}"
            entry = {"kernel": name, "class": label, "mode": n,
                     "tenants": K, "elements": K * M}
            if carry:            # the runs pass's hand-off, then the whole op
                got = kern(*args, out=_nan((K, I_n, R)))
                err, whole = _check_hand_off(
                    m, tag, got, K,
                    lambda t: plain(*(at(a, t) for a in args)),
                    lambda t: kern(*(at(a, t) for a in args),
                                   out=_nan((I_n, R))))
            else:                # the slots, then the split and the whole op
                got = kern(*args)
                _sync()
                with _index_order():
                    want = kori.tenant_loop(plain, (K,), *args)
                err = _check_close(f"{tag} stacked", got, want)
                del want
                _check_equal(f"{tag} vs {K} solo launches", got,
                             kori.tenant_loop(kern, (K,), *args))
                split_err, whole = _check_hand_off(
                    m, f"{label} segment_split of {name} mode {n}",
                    kori.segment_split(got, rows, I_n, th,
                                       out=_nan((K, I_n, R))), K,
                    lambda t: kori.segment_split_plain(got[t], rows[t], I_n),
                    lambda t: kori.segment_split(got[t], rows[t], I_n, th,
                                                 out=_nan((I_n, R))))
            entry.update(
                max_abs_err=err, with_fixup_max_abs_err=whole,
                ms=_ms(m, kern, *args, iters=5),
                solo_ms=_ms(m, lambda: kori.tenant_loop(kern, (K,), *args),
                            iters=3),
                plain_ms=_ms(m, lambda: kori.tenant_loop(plain, (K,), *args),
                             iters=1))
            entry["bound_ms"], entry["bound_by"] = _bound(nbytes, 0.0)
            out.append(entry)
            if name == "carry_runs":
                o, crow, cval = got
                out.append({
                    "kernel": "carry_fixup", "class": label, "mode": n,
                    "tenants": K, "elements": crow.numel(),
                    "max_abs_err": whole,
                    "ms": _ms(m, lambda: kori.carry_fixup(crow, cval, o),
                              iters=5),
                    "solo_ms": _ms(m, lambda: [kori.carry_fixup(
                        crow[t], cval[t], o[t]) for t in range(K)], iters=3),
                    "plain_ms": _ms(m, lambda: [kori.carry_fixup_plain(
                        crow[t], cval[t], o[t]) for t in range(K)], iters=1),
                    "bound_ms": _bound(crow.numel() * (4 + 4 * R), 0)[0],
                    "bound_by": "bytes"})
                del o, crow, cval
            elif name == "oriented_partials":
                out.append({
                    "kernel": "segment_split", "class": label, "mode": n,
                    "tenants": K, "elements": K * M,
                    "max_abs_err": split_err, "with_fixup_max_abs_err": whole,
                    "ms": _ms(m, kori.segment_split, got, rows, I_n, th,
                              iters=5),
                    "solo_ms": _ms(m, lambda: kori.tenant_loop(
                        lambda a, r: kori.segment_split(a, r, I_n, th),
                        (K,), got, rows), iters=3),
                    "plain_ms": _ms(m, lambda: kori.tenant_loop(
                        lambda a, r: kori.segment_split_plain(a, r, I_n),
                        (K,), got, rows), iters=1),
                    "bound_ms": _bound(K * M * 4 + K * I_n * R * 4
                                       + K * M * R * 4, 0)[0],
                    "bound_by": "bytes"})
            del got
        del vb, rows, words, values, B, phi_op
    for e in out:
        _print_axis(label, e)
    return out + rec


def check_tenant_pi_rows(m, label, enc, words, factors, n,
                         nbytes) -> dict:
    """A bucket's Π of mode ``n`` (``words`` ``(T, M, W)``, ``factors``
    ``(T, I_m, R)``): one `ops.pi_rows` launch, equal bit for bit to the
    plain version tenant by tenant and to the T solo launches; times of
    the stacked launch, the T solo launches, the plain version, and the
    bound of ``nbytes``."""
    ops, build = m["ops"], m["build"]
    loop = m["kori"].tenant_loop
    K, M = words.shape[:2]
    tag = f"{label} pi_rows mode {n}"
    before = build.LAUNCHES["pi_rows"]
    got = ops.pi_rows(enc, words, factors, n)
    _sync()
    if build.LAUNCHES["pi_rows"] != before + 1:
        _fail(f"{tag}: {build.LAUNCHES['pi_rows'] - before} launches for "
              f"the bucket")
    _check_equal(f"{tag} stacked vs plain", got, loop(
        m["k4"].pi_rows_plain, (K,), enc, words, factors, n))
    _check_equal(f"{tag} vs {K} solo launches", got,
                 loop(ops.pi_rows, (K,), enc, words, factors, n))
    e = {"kernel": "pi_rows", "class": label, "mode": n, "tenants": K,
         "elements": K * M, "max_abs_err": 0.0,
         "ms": _ms(m, ops.pi_rows, enc, words, factors, n, iters=5),
         "solo_ms": _ms(m, lambda: loop(ops.pi_rows, (K,), enc, words,
                                        factors, n), iters=3),
         "plain_ms": _ms(m, lambda: loop(m["k4"].pi_rows_plain, (K,), enc,
                                         words, factors, n), iters=1)}
    e["bound_ms"], e["bound_by"] = _bound(nbytes, 0.0)
    return e


def _print_axis(label, e) -> None:
    print(f"chip_smoke: {label} tenant axis {e.get('op') or e['kernel']} "
          f"mode {e['mode']}{' ' + e['policy'] if 'policy' in e else ''}: "
          f"{e['ms']:.3f} ms for {e['tenants']} tenants against "
          f"{e['solo_ms']:.3f} ms in {e['tenants']} solo launches (plain "
          f"{e['plain_ms']:.2f}, bound {e['bound_ms']:.4f}), max_abs_err "
          f"{e['max_abs_err']}")


@_index_order()
def check_tenant_recursive(m, p, ats, n, res_als, res_apr, label) -> list:
    """The tenant-axis launches of a recursive mode ``n`` on the bucket's
    final state: K3 (the CP-ALS factors), K7 under ALTO-OTF and ALTO-PRE
    (the CP-APR model's B and Π in ALTO order) and the pull of K7's Temp,
    each against its plain version tenant by tenant within tolerance and
    against its T solo launches bit for bit (the pull's solo launches in
    each member's cached order); times of the stacked launch, the T solo
    launches, the plain version and the bound. K7's windows: Temp rows
    over `common.window_rows` with B rows."""
    k3, k7, ops, batched = m["k3"], m["k7"], m["ops"], m["batched"]
    loop = m["kori"].tenant_loop
    K = len(ats)
    meta, R, mp = p.meta, p.rank, p.modes[n]
    enc, L = meta.enc, meta.n_partitions
    T_rows, I_n = meta.temp_rows[n], meta.dims[n]
    W, N = enc.n_words, enc.ndim
    at_b = batched.stack_tenants(ats)
    Mp = at_b.values.shape[1]
    fac = batched.stack_tenants([batched.embed_factors(r.factors, meta.dims)
                                 for r in res_als.results])
    apr_fac = batched.stack_tenants([
        batched.embed_factors(r.factors, meta.dims)
        for r in res_apr.results])
    lam = torch.stack([r.lam for r in res_apr.results])
    B = (apr_fac[n] * lam[:, None, :]).contiguous()
    pi = ops.pi_rows(enc, at_b.words, apr_fac, n)
    coords = ops.delinearize(enc, at_b.words.reshape(-1, W)).reshape(
        K, Mp, N)
    touched = [sum(int(torch.unique(coords[t, :, k]).numel())
                   for t in range(K)) for k in range(N)]
    del coords
    stream = K * (Mp * (4 * W + 4) + L * N * 4)
    fbytes = sum(touched[k] for k in range(N) if k != n) * R * 4
    temp_b = K * L * T_rows * R * 4
    window = m["common"].window_rows(
        T_rows, R, m["common"].smem_limit(at_b.words.device), True)
    windows = -(-T_rows // window)
    th = mp.threads
    cases = [("recursive_partials", None,
              lambda w, v, s_, f: k3.recursive_partials(
                  enc, n, T_rows, w, v, s_, f, mp.r_block, th),
              lambda w, v, s_, f: k3.recursive_partials_plain(
                  enc, n, T_rows, w, v, s_, f),
              (at_b.words, at_b.values, at_b.part_start, fac),
              stream + fbytes + temp_b, K * Mp * R * N)]
    for policy, key, op in (("otf", "factors", apr_fac), ("pre", "pi", pi)):
        cases.append((
            "phi_partials", policy,
            lambda w, v, s_, b, o, key=key: k7.phi_partials(
                enc, n, T_rows, 1e-10, w, v, s_, b, threads=th,
                **{key: o}),
            lambda w, v, s_, b, o, key=key: k7.phi_partials_plain(
                enc, n, T_rows, 1e-10, w, v, s_, b, **{key: o}),
            (at_b.words, at_b.values, at_b.part_start, B, op),
            stream + touched[n] * R * 4 + temp_b
            + (K * Mp * R * 4 if policy == "pre" else fbytes),
            K * Mp * R * (N + 2)))
    out, temp = [], None
    for name, policy, kern, plain, args, nbytes, nops in cases:
        tag = f"{label} {name} mode {n}" + (f" {policy}" if policy else "")
        got = kern(*args)
        _sync()
        want = loop(plain, (K,), *args)
        err = _check_close(f"{tag} stacked", got, want)
        del want
        _check_equal(f"{tag} vs {K} solo launches", got,
                     loop(kern, (K,), *args))
        e = {"kernel": name, "class": label, "mode": n, "tenants": K,
             "elements": K * Mp, "max_abs_err": err,
             "ms": _ms(m, kern, *args, iters=5),
             "solo_ms": _ms(m, lambda: loop(kern, (K,), *args), iters=3),
             "plain_ms": _ms(m, lambda: loop(plain, (K,), *args), iters=1),
             "temp_rows": T_rows}
        e["bound_ms"], e["bound_by"] = _bound(nbytes, nops)
        if policy:
            e.update(policy=policy, k7_window_rows=window,
                     k7_windows=windows)
        out.append(e)
        if policy == "otf":
            temp = got
        del got
    # The pull of K7's Temp: each tenant's pieces in its own order.
    starts = at_b.part_start[..., n]
    orders = [m["views"].get_pull_order(a, n) for a in ats]
    order = m["views"].stack_pull_orders(orders)

    def pull():
        return ops.pull_reduction(temp, starts, I_n, th, order)

    def pull_solo():
        return torch.stack([ops.pull_reduction(temp[t], starts[t], I_n, th,
                                               orders[t]) for t in range(K)])

    def pull_plain():
        return torch.stack([m["mttkrp"].pull_rows(temp[t], starts[t], I_n)
                            for t in range(K)])
    got = pull()
    err = _check_close(f"{label} pull mode {n} stacked", got, pull_plain())
    _check_equal(f"{label} pull mode {n} vs {K} solo launches", got,
                 pull_solo())
    _check_equal(f"{label} pull mode {n} vs the dense order", got,
                 ops.pull_reduction(temp, starts, I_n, th))
    pieces = order.order.numel()    # the stacked reach orders, padding in
    e = {"kernel": "carry_fixup", "op": "pull_reduction", "class": label,
         "mode": n, "tenants": K, "elements": pieces,
         "max_abs_err": err, "ms": _ms(m, pull, iters=5),
         "solo_ms": _ms(m, pull_solo, iters=3),
         "plain_ms": _ms(m, pull_plain, iters=1)}
    # Each piece: its Temp row read, its row (int32) and index (int64).
    e["bound_ms"], e["bound_by"] = _bound(
        pieces * (R * 4 + 12) + K * I_n * R * 4, 0.0)
    out.append(e)
    out.append(check_tenant_pi_rows(m, label, enc, at_b.words, apr_fac, n,
                                    K * Mp * (W + R) * 4 + fbytes))
    del temp, got, at_b, pi, B
    for e in out:
        _print_axis(label, e)
    return out


def _route(m, plan, traversals: dict):
    """``plan`` with mode n routed ``traversals[n]``, its tiles kept: the
    forced class plans of the recursive buckets."""
    return dataclasses.replace(plan, modes=tuple(
        dataclasses.replace(mp, traversal=traversals.get(mp.mode,
                                                         mp.traversal))
        for mp in plan.modes))


PHI_KERNELS = {"recursive": "phi_partials",
               "oriented_carry": "phi_carry_runs",
               "oriented": "phi_oriented_partials"}


@contextlib.contextmanager
def _phi_calls(m, calls: dict):
    """Counts a bucket's Φ evaluations (`batched._phi`) by the traversal
    of their mode: each launches that traversal's Φ kernel once
    (`PHI_KERNELS`), whatever the bucket holds."""
    bat = m["batched"]
    orig = bat._phi

    def counted(plan, at_b, pull, view_b, B, mode, *args, **kw):
        t = plan.modes[mode].traversal.value
        calls[t] = calls.get(t, 0) + 1
        return orig(plan, at_b, pull, view_b, B, mode, *args, **kw)
    bat._phi = counted
    try:
        yield calls
    finally:
        bat._phi = orig


def bucket_als(m, label, p, ats, views, dims, seeds, n_sweeps, cap,
               solo=True):
    """Batched CP-ALS counted (each kernel of the plan launched once a
    mode a sweep), then, with ``solo``, every tenant against its solo run
    on its padded tensor, bit for bit. Returns (result, seconds, counts,
    solo seconds summed)."""
    cpals, batched = m["cpals"], m["batched"]
    per = _bucket_kernels(m, p, apr=False)
    res, seconds, c = _counted(
        m, f"{label} batched cp_als", lambda: batched.batched_cp_als(
            ats, views, dims, RANK, plan=p, n_iters=n_sweeps, tol=0.0,
            seeds=seeds, capacity=cap), set(per))
    for k, n in per.items():
        if c["launches"][k] != n * res.n_sweeps:
            _fail(f"{label}: {k} launched {c['launches'][k]} times in "
                  f"{res.n_sweeps} sweeps, expected {n} a sweep")
    solo_s = 0.0
    for i in range(len(ats) if solo else 0):
        init = cpals.init_factors(dims[i], RANK, seed=seeds[i])
        _sync()
        t0 = time.perf_counter()
        one = cpals.cp_als(ats[i], RANK, n_iters=n_sweeps, tol=0.0, plan=p,
                           views=views[i],
                           factors=batched.embed_factors(init, p.meta.dims))
        _sync()
        solo_s += time.perf_counter() - t0
        _same_bits(f"{label} tenant {i} cp_als", res.results[i], one,
                   ("fits",))
    return res, seconds, c, solo_s


def bucket_apr(m, label, p, ats, views, dims, seeds, params, cap,
               solo=True):
    """Batched CP-APR counted under the plan's Π policy (each Φ
    evaluation launching its mode's Φ kernel once, `_phi_calls`), then,
    with ``solo``, every tenant against its solo run, bit for bit.
    Returns (result, seconds, counts, solo seconds, Φ evaluations)."""
    cpapr, batched = m["cpapr"], m["batched"]
    pre = p.pi_policy.value == "pre"
    expect = set(_bucket_kernels(m, p, apr=True)) | (
        {"pi_rows"} if pre else set())
    with _phi_calls(m, {}) as calls:
        res, seconds, c = _counted(
            m, f"{label} batched cp_apr", lambda: batched.batched_cp_apr(
                ats, views, dims, RANK, plan=p, params=params, seeds=seeds,
                capacity=cap), expect)
    for trav, k in PHI_KERNELS.items():
        if c["launches"][k] != calls.get(trav, 0):
            _fail(f"{label}: {k} launched {c['launches'][k]} times in "
                  f"{calls.get(trav, 0)} Φ evaluations of its modes")
    updates = res.n_outer * len(p.modes) if pre else 0
    if c["launches"]["pi_rows"] != updates:
        _fail(f"{label}: pi_rows launched {c['launches']['pi_rows']} times "
              f"in {updates} mode updates under ALTO-PRE")
    solo_s = 0.0
    for i in range(len(ats) if solo else 0):
        lam0, f0 = cpapr.init_factors(dims[i], RANK, seed=seeds[i],
                                      total=float(ats[i].values.sum()))
        _sync()
        t0 = time.perf_counter()
        one = cpapr.cp_apr(ats[i], RANK, params, plan=p, views=views[i],
                           factors=batched.embed_factors(f0, p.meta.dims),
                           lam=lam0)
        _sync()
        solo_s += time.perf_counter() - t0
        _same_bits(f"{label} tenant {i} cp_apr", res.results[i], one,
                   ("kkt_violations", "n_outer", "n_inner_total"))
    return res, seconds, c, solo_s, dict(calls)


def run_bucket(m, name, spec, seeds_offset=0, plan_fn=None,
               policies=None) -> dict:
    """One shape class: its tenants, the class plan (or ``plan_fn(sc)``),
    batched CP-ALS (5 sweeps) and CP-APR (3 outer iterations, under each
    Π policy of ``policies``, default the plan's) counted, every tenant
    against its solo run on the padded tensor bit for bit, four against
    their unpadded solo runs, and the tenant-axis launches."""
    shc, cpals, cpapr = m["shapeclass"], m["cpals"], m["cpapr"]
    t0 = time.perf_counter()
    xs = _bucket_tensors(m, spec)
    gen_s = time.perf_counter() - t0
    scs = {shc.classify(x, RANK) for x in xs}
    if len(scs) != 1:
        _fail(f"class {name}: tenants fall into {len(scs)} classes")
    (sc,) = scs
    p = (plan_fn or m["plan"].make_class_plan)(sc)
    t0 = time.perf_counter()
    ats, views = _members(m, xs, sc, p)
    _sync()
    build_s = time.perf_counter() - t0
    K, dims = len(xs), [x.dims for x in xs]
    seeds = [seeds_offset + i for i in range(K)]
    n_sweeps, k_max = 5, 3
    params = cpapr.CpaprParams(k_max=k_max, l_max=10)
    res_als, als_s, als_c, solo_als_s = bucket_als(
        m, f"class {name}", p, ats, views, dims, seeds, n_sweeps, K)
    policies = policies or (p.pi_policy.value,)
    apr_plans = {pol: dataclasses.replace(
        p, pi_policy=m["heuristics"].PiPolicy(pol)) for pol in policies}
    aprs = {pol: bucket_apr(m, f"class {name} {pol}", pp, ats, views, dims,
                            seeds, params, K)
            for pol, pp in apr_plans.items()}
    res_apr = aprs[policies[0]][0]
    # Four tenants against their own unpadded solo runs, under the class
    # plan's routing and tiles.
    unpadded = []
    for i in range(4):
        raw = m["alto"].build_device(xs[i], n_partitions=sc.n_partitions)
        rp = dataclasses.replace(apr_plans[policies[0]], meta=raw.meta)
        r = cpals.cp_als(raw, RANK, n_iters=n_sweeps, tol=0.0, plan=rp,
                         factors=cpals.init_factors(dims[i], RANK,
                                                    seed=seeds[i]))
        g = res_als.results[i]
        if abs(g.fits[-1] - r.fits[-1]) > SOLO_FIT:
            _fail(f"class {name} tenant {i}: last fit {g.fits[-1]} vs "
                  f"unpadded {r.fits[-1]}")
        e_als = _near(f"class {name} tenant {i} cp_als", g, r)
        lam0, f0 = cpapr.init_factors(dims[i], RANK, seed=seeds[i],
                                      total=float(raw.values.sum()))
        ra = cpapr.cp_apr(raw, RANK, params, plan=rp, factors=f0, lam=lam0)
        e_apr = _near(f"class {name} tenant {i} cp_apr",
                      res_apr.results[i], ra)
        unpadded.append({"tenant": i, "plan": r.plan.traversals(),
                         "fit_diff": g.fits[-1] - r.fits[-1],
                         "als_max_abs": e_als, "apr_max_abs": e_apr})
        del raw
    kernels = check_tenant_kernels(m, apr_plans[policies[0]], ats, views,
                                   res_als, res_apr, name)

    def apr_info(pol):
        res, secs, c, solo_s, calls = aprs[pol]
        return {"seconds": secs, "n_outer": res.n_outer,
                "outer_ms": secs / res.n_outer * 1e3,
                "solo_outer_ms_sum": solo_s / k_max * 1e3,
                "tenants_per_s": K / secs, "solo_tenants_per_s": K / solo_s,
                "kkt_violations": [r.kkt_violations for r in res.results],
                "n_inner_total": [r.n_inner_total for r in res.results],
                "phi_evaluations": calls, "launches": c["launches"]}
    info = {
        "class": {"dims": sc.dims, "nnz": sc.nnz, "tenants": K,
                  "n_partitions": sc.n_partitions},
        "traversals": p.traversals(), "pi_policy": policies[0],
        "tiles": [(mp.r_block, mp.block_m, mp.threads) for mp in p.modes],
        "gen_s": gen_s, "build_s": build_s,
        "tenant_nnz": [x.nnz for x in xs],
        "cp_als": {"seconds": als_s, "sweep_ms": als_s / n_sweeps * 1e3,
                   "solo_sweep_ms_sum": solo_als_s / n_sweeps * 1e3,
                   "tenants_per_s": K / als_s,
                   "solo_tenants_per_s": K / solo_als_s,
                   "fits": [r.fits for r in res_als.results],
                   "launches": als_c["launches"]},
        "cp_apr": apr_info(policies[0]),
        "cp_apr_policies": {pol: apr_info(pol) for pol in policies},
        "unpadded": unpadded, "tenant_axis": kernels,
        "runs": [{"launches": c["launches"], "elements": c["elements"]}
                 for c in [als_c] + [aprs[pol][2] for pol in policies]]}
    print(f"chip_smoke: class {name} {sc.dims} nnz {sc.nnz}, {K} tenants, "
          f"{p.traversals()}: batched CP-ALS sweep "
          f"{info['cp_als']['sweep_ms']:.2f} ms against "
          f"{info['cp_als']['solo_sweep_ms_sum']:.2f} ms of {K} solo "
          f"sweeps ({info['cp_als']['tenants_per_s']:.1f} against "
          f"{info['cp_als']['solo_tenants_per_s']:.1f} tenants/s); "
          + "; ".join(
              f"CP-APR {pol} outer iteration {a['outer_ms']:.1f} ms against "
              f"{a['solo_outer_ms_sum']:.1f} ms solo"
              for pol, a in info["cp_apr_policies"].items())
          + f"; every tenant equal to its solo run bit for bit; unpadded "
          f"{unpadded}; launches {als_c['launches']} / "
          f"{[aprs[pol][2]['launches'] for pol in policies]}")
    return {**info, "sc": sc, "plan": p, "ats": ats, "views": views,
            "xs": xs}


def class_a_recursive(m, a) -> dict:
    """Class A with mode 0 routed recursive: 1 sweep and 1 outer
    iteration, every tenant bit for bit its solo run; its Temp of 4,096
    rows spans several K7 windows on the tenant axis."""
    trav = m["heuristics"].Traversal
    p = _route(m, a["plan"], {0: trav.RECURSIVE})
    ats, K = a["ats"], len(a["ats"])
    views = [m["plan"].build_views(at, p) for at in ats]
    dims, seeds = [x.dims for x in a["xs"]], list(range(K))
    res_als, als_s, als_c, _ = bucket_als(
        m, "class A mode 0 recursive", p, ats, views, dims, seeds, 1, K)
    res_apr, apr_s, apr_c, _, calls = bucket_apr(
        m, "class A mode 0 recursive", p, ats, views, dims, seeds,
        m["cpapr"].CpaprParams(k_max=1, l_max=10), K)
    axis = check_tenant_recursive(m, p, ats, 0, res_als, res_apr,
                                  "A mode 0 recursive")
    k7 = next(e for e in axis if e.get("policy") == "otf")
    if k7["k7_windows"] < 2:
        _fail(f"class A mode 0: {k7['temp_rows']} Temp rows fit one K7 "
              f"window")
    print(f"chip_smoke: class A, mode 0 recursive: sweep "
          f"{als_s * 1e3:.2f} ms, outer iteration {apr_s * 1e3:.1f} ms, "
          f"{k7['temp_rows']} Temp rows in {k7['k7_windows']} K7 windows of "
          f"{k7['k7_window_rows']}; every tenant equal to its solo run")
    return {"traversals": p.traversals(), "sweep_ms": als_s * 1e3,
            "outer_ms": apr_s * 1e3, "phi_evaluations": calls,
            "temp_rows": k7["temp_rows"], "k7_windows": k7["k7_windows"],
            "k7_window_rows": k7["k7_window_rows"], "tenant_axis": axis,
            "runs": [{"launches": c["launches"], "elements": c["elements"]}
                     for c in (als_c, apr_c)]}


def run_class_c(m) -> dict:
    """Recursive modes in buckets: class C (`BUCKET_CLASSES`) under the
    forced plan (a) (mode 0 carry, modes 1-3 recursive) through
    `run_bucket`, under ALTO-OTF and ALTO-PRE; then (b) every mode
    recursive and (c) the tuned class plan (``tune="auto"`` on a
    temporary store), bit for bit solo, and the all-oriented static plan
    for its times; capacities 16 and 32 launch alike; then the class
    through a tuned `CpdService` (capacity 16) on (c)'s store, bit for
    bit solo."""
    import tempfile
    trav, Pi = m["heuristics"].Traversal, m["heuristics"].PiPolicy
    t_start = time.perf_counter()

    def forced(sc):
        return _route(m, m["plan"].make_class_plan(sc),
                      {0: trav.ORIENTED_CARRY, 1: trav.RECURSIVE,
                       2: trav.RECURSIVE, 3: trav.RECURSIVE})
    c = run_bucket(m, "C", BUCKET_CLASSES["C"], seeds_offset=3000,
                   plan_fn=forced, policies=("otf", "pre"))
    sc, ats, views, xs = c["sc"], c["ats"], c["views"], c["xs"]
    K, dims = len(xs), [x.dims for x in xs]
    seeds = [3000 + i for i in range(K)]
    params = m["cpapr"].CpaprParams(k_max=3, l_max=10)
    out = {k: v for k, v in c.items()
           if k not in ("sc", "plan", "ats", "views", "xs")}
    runs, axis = list(c["runs"]), list(c["tenant_axis"])
    # Capacities 16 and 32: the same launches a sweep and an outer
    # iteration.
    bat, cap = m["batched"], {}
    for n in CLASS_C_CAPACITIES:
        _, _, ca = _counted(
            m, f"class C capacity {n}", lambda: bat.batched_cp_als(
                ats, views, dims, RANK, plan=c["plan"], n_iters=1, tol=0.0,
                seeds=seeds, capacity=n), {"recursive_partials"})
        _, _, cp = _counted(
            m, f"class C capacity {n} cp_apr", lambda: bat.batched_cp_apr(
                ats, views, dims, RANK, plan=c["plan"], seeds=seeds,
                params=m["cpapr"].CpaprParams(k_max=1, l_max=10),
                capacity=n), {"phi_partials"})
        cap[n] = (ca["launches"], cp["launches"])
    if len({json.dumps(v, sort_keys=True) for v in cap.values()}) != 1:
        _fail(f"class C: capacities launch differently: {cap}")
    out["capacity_launches"] = cap
    static = m["plan"].make_class_plan(sc)
    env = m["autotune"].PLAN_CACHE_ENV
    saved = os.environ.get(env)
    with tempfile.TemporaryDirectory(prefix="repro_torch_class_c_") as d:
        os.environ[env] = str(pathlib.Path(d) / "plans.json")
        try:
            r0, t0 = m["ops"].timing_runs(), time.perf_counter()
            tuned = m["plan"].make_class_plan(sc, tune="auto", at=ats[0])
            out["tune"] = {"timing_runs": m["ops"].timing_runs() - r0,
                           "seconds": time.perf_counter() - t0}
            plans = {"all_recursive": _route(
                         m, static, {n: trav.RECURSIVE for n in range(4)}),
                     "tuned": tuned, "all_oriented": static}
            out["plans"] = {}
            for label, p in plans.items():
                solo = label != "all_oriented"
                vs = [m["plan"].build_views(a, p) for a in ats]
                res_als, als_s, c_als, solo_als = bucket_als(
                    m, f"class C {label}", p, ats, vs, dims, seeds, 5, K,
                    solo=solo)
                runs.append(c_als)
                e = {"traversals": p.traversals(),
                     "tiles": [(mp.r_block, mp.block_m, mp.threads)
                               for mp in p.modes],
                     "sweep_ms": als_s / 5 * 1e3,
                     "solo_sweep_ms_sum": solo_als / 5 * 1e3 if solo
                     else None, "launches": c_als["launches"]}
                for pol in ("otf", "pre"):
                    res, secs, c_apr, solo_s, calls = bucket_apr(
                        m, f"class C {label} {pol}",
                        dataclasses.replace(p, pi_policy=Pi(pol)), ats, vs,
                        dims, seeds, params, K, solo=solo)
                    runs.append(c_apr)
                    e[f"cp_apr_{pol}"] = {
                        "outer_ms": secs / res.n_outer * 1e3,
                        "solo_outer_ms_sum": solo_s / res.n_outer * 1e3
                        if solo else None, "phi_evaluations": calls,
                        "launches": c_apr["launches"]}
                    if label == "all_recursive" and pol == "otf":
                        # Mode 0's 8,192 Temp rows over several K7 windows.
                        rec0 = check_tenant_recursive(
                            m, p, ats, 0, res_als, res, "C all recursive")
                        axis += rec0
                        k7 = next(x for x in rec0
                                  if x.get("policy") == "otf")
                        if k7["k7_windows"] < 2:
                            _fail("class C mode 0: Temp fits one K7 window")
                        e["mode0_k7_windows"] = k7["k7_windows"]
                out["plans"][label] = e
            # The service on (c)'s store: a hit, the tuned plan, every
            # tenant bit for bit its solo run.
            svc = m["serve"].CpdService(RANK, "cp_als", capacity=16,
                                        n_iters=5, tol=0.0, tune="auto")
            r0 = m["ops"].timing_runs()
            served, wall, c_srv = _served(m, "serve class C", svc, xs, seeds,
                                          threads=False)
            if (m["ops"].timing_runs() != r0
                    or svc._class_plan(sc) != tuned):
                _fail("serve class C: the service measured, or took "
                      "another plan than the tuned class plan")
            _serve_stats_zero("serve class C", svc.stats())
            _solo_equal(m, "serve class C", svc, xs, seeds, served, 5,
                        apr=False)
            runs.append(c_srv)
            out["serve"] = {"wall_s": wall, "tenants": K, "capacity": 16,
                            "buckets_run": svc.stats()["buckets_run"],
                            "launches": c_srv["launches"]}
            # Plan (a) stored as the class's plan: a second service serves
            # its recursive modes, every tenant bit for bit solo.
            ac = m["autotune"]
            ac.save_store({ac.class_plan_key(sc, "cuda", device=ats[0].device):
                           ac.serialize_plan(c["plan"])})
            svc = m["serve"].CpdService(RANK, "cp_als", capacity=16,
                                        n_iters=5, tol=0.0, tune="auto")
            served, wall, c_srv = _served(m, "serve class C plan (a)", svc,
                                          xs, seeds, threads=False)
            if svc._class_plan(sc) != c["plan"]:
                _fail("serve class C: the stored plan (a) was not served")
            for k in ("recursive_partials", "carry_runs"):
                if c_srv["launches"][k] != 5 * (3 if k[0] == "r" else 1):
                    _fail(f"serve class C plan (a): {k} launched "
                          f"{c_srv['launches'][k]} times in 5 sweeps")
            _serve_stats_zero("serve class C plan (a)", svc.stats())
            _solo_equal(m, "serve class C plan (a)", svc, xs, seeds, served,
                        5, apr=False)
            runs.append(c_srv)
            out["serve_forced"] = {"wall_s": wall,
                                   "launches": c_srv["launches"]}
        finally:
            if saved is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = saved
    out["tenant_axis"] = axis
    out["runs"] = [{"launches": r["launches"], "elements": r["elements"]}
                   for r in runs]
    out["seconds"] = time.perf_counter() - t_start
    pl = out["plans"]
    print(f"chip_smoke: class C plans: forced {c['traversals']}, tuned "
          f"{pl['tuned']['traversals']} ({out['tune']['timing_runs']} "
          f"timing runs): CP-ALS sweep ms forced "
          f"{c['cp_als']['sweep_ms']:.2f}, all recursive "
          f"{pl['all_recursive']['sweep_ms']:.2f}, tuned "
          f"{pl['tuned']['sweep_ms']:.2f}, all oriented "
          f"{pl['all_oriented']['sweep_ms']:.2f}; CP-APR OTF outer ms "
          f"forced {c['cp_apr']['outer_ms']:.1f}, all recursive "
          f"{pl['all_recursive']['cp_apr_otf']['outer_ms']:.1f}, tuned "
          f"{pl['tuned']['cp_apr_otf']['outer_ms']:.1f}, all oriented "
          f"{pl['all_oriented']['cp_apr_otf']['outer_ms']:.1f}; capacities "
          f"{CLASS_C_CAPACITIES} launch alike; the service served "
          f"{K} tenants bit for bit solo under (c) and (a); "
          f"{out['seconds']:.1f} s")
    return out


def phase_batched(m) -> dict:
    """Classes A and B (`BUCKET_CLASSES`), then the capacity check (16 and
    64 tenants of class A launch the same kernels a sweep), the class
    plan's store key and warm store, class A with mode 0 recursive, and
    class C's recursive buckets (`run_class_c`)."""
    import tempfile
    t_start = time.perf_counter()
    out = {}
    a = run_bucket(m, "A", BUCKET_CLASSES["A"])
    # Capacity 16 and 64: the same launches a sweep.
    launches = {}
    for cap in (16, 64):
        _, _, c = _counted(
            m, f"class A capacity {cap}", lambda: m["batched"].batched_cp_als(
                a["ats"][:cap], a["views"][:cap],
                [x.dims for x in a["xs"][:cap]], RANK, plan=a["plan"],
                n_iters=1, tol=0.0, capacity=cap), {"carry_runs"})
        launches[cap] = c["launches"]
    if launches[16] != launches[64]:
        _fail(f"capacity 16 and 64 launch differently: {launches}")
    # The store key is the class's; a second make of the class plan under
    # tune="auto" is a store hit.
    ac, shc = m["autotune"], m["shapeclass"]
    keys = {ac.class_plan_key(shc.classify(x, RANK), "cuda")
            for x in a["xs"]}
    if len(keys) != 1:
        _fail(f"class A tenants give {len(keys)} store keys")
    with tempfile.TemporaryDirectory(prefix="repro_torch_plans_") as d:
        store = pathlib.Path(d) / "plans.json"
        t0 = time.perf_counter()
        r0 = m["ops"].timing_runs()
        tuned = m["plan"].make_class_plan(a["sc"], tune="auto",
                                          at=a["ats"][0], store_path=store)
        first = m["ops"].timing_runs() - r0
        tune_s = time.perf_counter() - t0
        r0 = m["ops"].timing_runs()
        again = m["plan"].make_class_plan(a["sc"], tune="auto",
                                          at=a["ats"][1], store_path=store)
        second = m["ops"].timing_runs() - r0
    if first == 0 or second != 0 or again != tuned:
        _fail(f"class plan store: {first} timing runs, then {second}")
    out["A"] = {k: v for k, v in a.items()
                if k not in ("sc", "plan", "ats", "views", "xs")}
    out["A"].update(capacity_launches=launches, store_key=keys.pop(),
                    tune_timing_runs=first, tune_s=tune_s,
                    second_make_timing_runs=second,
                    tuned=[(mp.traversal.value, mp.block_m)
                           for mp in tuned.modes],
                    mode0_recursive=class_a_recursive(m, a))
    del a
    b = run_bucket(m, "B", BUCKET_CLASSES["B"], seeds_offset=1000)
    out["B"] = {k: v for k, v in b.items()
                if k not in ("sc", "plan", "ats", "views", "xs")}
    del b
    out["C"] = run_class_c(m)
    rec = out["A"]["mode0_recursive"]
    out["runs"] = (out["A"]["runs"] + rec["runs"] + out["B"]["runs"]
                   + out["C"]["runs"])
    out["tenant_axis"] = (out["A"]["tenant_axis"] + rec["tenant_axis"]
                          + out["B"]["tenant_axis"]
                          + out["C"]["tenant_axis"])
    out["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: batched phase {out['seconds']:.1f} s; class A "
          f"capacity 16 and 64 launch {launches[16]}; class A store key "
          f"{out['A']['store_key']}: {first} timing runs to tune "
          f"({tune_s:.1f} s), {second} on the second make")
    return out


# ---------------------------------------------------------------------------
# Incremental ingest and warm starts
# ---------------------------------------------------------------------------

def _same_tensor(label, got, ref) -> None:
    if got.meta != ref.meta:
        _fail(f"{label}: meta {got.meta} vs {ref.meta}")
    for f in ("words", "values", "part_start", "part_end"):
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            _fail(f"{label}: {f} differ")


def _delta(dims, n, seed, resident=None, dup=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = hi or dims
    coords = np.stack([rng.integers(0, h, n) for h in hi],
                      axis=1).astype(np.int32)
    if dup:
        coords[:dup] = resident[rng.integers(0, resident.shape[0], dup)]
    return coords, rng.integers(1, 10, n).astype(np.float32)


CHICAGO_WARM_MARGIN = 1e-3   # first warm fit against the resident's last


def warm_chicago(m, chicago, grown) -> dict:
    """Warm- and cold-start CP-ALS (3 iterations) on the Chicago tensor
    grown by an append, the warm one from `phase_chicago`'s model: the
    first warm fit must reach that model's last fit less
    `CHICAGO_WARM_MARGIN` (the delta is 1,000 of 5.3 M nonzeros), and
    exceed the first cold fit."""
    p = m["plan"].plan_for(grown, RANK)
    expect = als_kernels(m, p)
    last = chicago["run"]["fits"][-1]
    warm, warm_s, warm_c = _counted(
        m, "chicago warm cp_als", lambda: m["cpals"].cp_als(
            grown, RANK, n_iters=3, tol=0.0, plan=p,
            warm_start=chicago["run"]["res"]), expect)
    cold, cold_s, cold_c = _counted(
        m, "chicago cold cp_als", lambda: m["cpals"].cp_als(
            grown, RANK, n_iters=3, tol=0.0, plan=p, seed=0), expect)
    if not (warm.fits[0] >= last - CHICAGO_WARM_MARGIN
            and warm.fits[0] > cold.fits[0]):
        _fail(f"chicago warm start: first fit {warm.fits[0]} against the "
              f"resident model's {last} (margin {CHICAGO_WARM_MARGIN}) "
              f"and the cold start's {cold.fits[0]}")
    print(f"chip_smoke: chicago grown to {grown.dims}: warm CP-ALS fits "
          f"{warm.fits} from the resident model's {last}, cold {cold.fits}")
    return {"resident_fit": last, "warm_fits": warm.fits,
            "cold_fits": cold.fits, "warm_s": warm_s, "cold_s": cold_s,
            "runs": [{"launches": c["launches"], "elements": c["elements"]}
                     for c in (warm_c, cold_c)]}


def phase_ingest(m, chicago, darpa) -> dict:
    """Appends to the Chicago tensor against the host rebuild, the
    warm-start CP-ALS on the grown Chicago tensor (`warm_chicago`), appends
    to the DARPA tensor against the device rebuild, the warm-start CP-ALS
    on the grown DARPA tensor, and the views an append drops."""
    ingest, alto = m["ingest"], m["alto"]
    out = {}
    t_start = time.perf_counter()
    at = chicago["at"]
    resident = chicago["x"].coords
    d = max(1, at.nnz // 100)
    cases = {"sum": _delta(at.dims, d, 1),
             "last": _delta(at.dims, d, 2, resident, dup=d // 4),
             "growth": _delta(at.dims, 1000, 3,
                              hi=(9000,) + at.dims[1:])}
    for label, (coords, values) in cases.items():
        policy = "last" if label == "last" else "sum"
        _sync()
        t0 = time.perf_counter()
        got = ingest.append_delta(at, coords, values, policy=policy,
                                  invalidate_stale=False)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = alto.merge_reference(at, coords, values, policy=policy)
        ref_ms = (time.perf_counter() - t0) * 1e3
        _same_tensor(f"chicago append ({label})", got, ref)
        out[f"chicago_{label}"] = {"delta": len(values), "append_ms": ms,
                                   "host_rebuild_ms": ref_ms,
                                   "dims": got.dims,
                                   "re_encoded": got.meta.enc != at.meta.enc}
        del ref
    out["chicago_warm"] = warm_chicago(m, chicago, got)    # grown: the last
    del got
    # DARPA: append 1 % of its nonzeros, then push mode 2 past 2**25.
    at = darpa["at"]
    steps = {"append": _delta(at.dims, at.nnz // 100, 4),
             "growth": _delta(at.dims, 1000, 5,
                              hi=at.dims[:2] + (DARPA_MODE2_GROWTH,))}
    cur = at
    for label, (coords, values) in steps.items():
        _sync()
        t0 = time.perf_counter()
        got = ingest.append_delta(cur, coords, values,
                                  invalidate_stale=False)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        merged = alto.merge_coo(alto.to_sparse(cur), coords, values)
        _sync()
        t0 = time.perf_counter()
        ref = alto.build_device(merged, n_partitions=cur.n_partitions)
        _sync()
        ref_ms = (time.perf_counter() - t0) * 1e3
        _same_tensor(f"darpa append ({label})", got, ref)
        out[f"darpa_{label}"] = {"delta": len(values), "append_ms": ms,
                                 "device_rebuild_ms": ref_ms,
                                 "dims": got.dims,
                                 "re_encoded": got.meta.enc != cur.meta.enc}
        del merged, ref
        if cur is not at:
            del cur
        cur = got
    grown = cur
    # Warm start from phase_darpa's result against a cold start.
    p = m["plan"].plan_for(grown, RANK)
    expect = als_kernels(m, p)
    warm, warm_s, warm_c = _counted(
        m, "darpa warm cp_als", lambda: m["cpals"].cp_als(
            grown, RANK, n_iters=3, tol=0.0, plan=p,
            warm_start=darpa["run"]["res"]), expect)
    cold, cold_s, cold_c = _counted(
        m, "darpa cold cp_als", lambda: m["cpals"].cp_als(
            grown, RANK, n_iters=3, tol=0.0, plan=p, seed=0), expect)
    for label, r in (("warm", warm), ("cold", cold)):
        if not all(math.isfinite(f) for f in r.fits):
            _fail(f"darpa {label} cp_als fits {r.fits}")
    # The views an append drops: none after a no-op, every mode after a
    # content change.
    views = m["views"]
    views.build_views(at, darpa["plan"])
    noop = ingest.append_delta(at, np.zeros((0, 3), np.int32),
                               np.zeros(0, np.float32),
                               invalidate_stale=False)
    dropped_noop = views.invalidate_changed(at, noop)
    content = ingest.append_delta(at, *steps["append"],
                                  invalidate_stale=False)
    dropped = views.invalidate_changed(at, content)
    if dropped_noop != 0 or dropped < len(darpa["plan"].modes):
        _fail(f"invalidate_changed dropped {dropped_noop} after a no-op "
              f"append, {dropped} after a content one")
    del noop, content
    out.update(warm_fits=warm.fits, cold_fits=cold.fits,
               warm_s=warm_s, cold_s=cold_s,
               dropped_after_noop=dropped_noop, dropped_after_append=dropped,
               grown_dims=grown.dims, seconds=time.perf_counter() - t_start,
               runs=[*out["chicago_warm"]["runs"],
                     *({"launches": c["launches"], "elements": c["elements"]}
                       for c in (warm_c, cold_c))])
    print(f"chip_smoke: ingest: " + "; ".join(
        f"{k} {v['append_ms']:.1f} ms append against "
        f"{v.get('host_rebuild_ms', v.get('device_rebuild_ms')):.1f} ms "
        f"rebuild (delta {v['delta']}, re-encoded {v['re_encoded']})"
        for k, v in out.items() if isinstance(v, dict) and "append_ms" in v)
        + f"; darpa grown to {grown.dims}: warm CP-ALS fits {warm.fits} "
        f"against cold {cold.fits}; views dropped: {dropped_noop} after a "
        f"no-op append, {dropped} after a content append; "
        f"{out['seconds']:.1f} s")
    del grown
    return out


# ---------------------------------------------------------------------------
# The multi-tenant service: clean runs, deltas and the fault sites
# ---------------------------------------------------------------------------

SERVE_CAPACITY = {"A": 16, "B": 8}
SERVE_THREADS = 4
SERVE_TIMEOUT_S = 600.0


def _serve_threads(m, svc, xs, seeds) -> tuple[dict, float]:
    """``xs`` submitted from `SERVE_THREADS` threads with the worker
    running, each thread waiting on its own requests; returns the
    responses by tenant index and the wall seconds."""
    out, errors = {}, []
    lock = threading.Lock()

    def client(k):
        try:
            mine = [(i, svc.submit(xs[i], seed=seeds[i]))
                    for i in range(k, len(xs), SERVE_THREADS)]
            for i, rid in mine:
                r = svc.wait(rid, timeout=SERVE_TIMEOUT_S)
                with lock:
                    out[i] = r
        except Exception as exc:  # noqa: BLE001 — reported below
            with lock:
                errors.append(exc)

    svc.serve(poll_s=0.002)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(SERVE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    svc.shutdown(timeout=SERVE_TIMEOUT_S)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or svc.serving:
        _fail("serve: a submitter or the worker did not finish")
    if sorted(out) != list(range(len(xs))):
        _fail(f"serve: {len(out)} of {len(xs)} responses")
    return out, wall


def _served(m, label, svc, xs, seeds, threads=True):
    """One counted serve: worker and submitter threads, or the caller's
    `process()`; every response must be ok."""
    def run():
        if threads:
            return _serve_threads(m, svc, xs, seeds)
        t0 = time.perf_counter()
        ids = [svc.submit(x, seed=s) for x, s in zip(xs, seeds)]
        got = {r.request_id: r for r in svc.process()}
        return {i: got[rid] for i, rid in enumerate(ids)}, \
            time.perf_counter() - t0
    (out, wall), seconds, counts = _counted(m, label, run, set())
    bad = {i: r.error for i, r in out.items() if not r.ok}
    if bad:
        _fail(f"{label}: errors {bad}")
    return out, wall, counts


def _serve_stats_zero(label, s) -> None:
    for k in ("retries", "degraded_dispatches", "quarantined_tenants",
              "plan_evictions", "errors", "deadline_expired",
              "worker_recoveries"):
        if s[k]:
            _fail(f"{label}: stats {k} = {s[k]} on a clean run")


def _solo_equal(m, label, svc, xs, seeds, out, n_iters, apr) -> list:
    """Every served tenant against its solo run on its padded tensor under
    the service's class plan, from the embedded start, bit for bit;
    returns the canonical tensors and views."""
    cpals, cpapr, batched = m["cpals"], m["cpapr"], m["batched"]
    members = []
    for i, x in enumerate(xs):
        sc = m["shapeclass"].classify(x, RANK)
        p = svc._class_plan(sc)
        (at,), (views,) = _members(m, [x], sc, p)
        if apr:
            lam0, f0 = cpapr.init_factors(x.dims, RANK, seed=seeds[i],
                                          total=float(at.values.sum()))
            solo = cpapr.cp_apr(
                at, RANK, cpapr.CpaprParams(k_max=n_iters, tau=svc.tol),
                plan=p, views=views, lam=lam0,
                factors=batched.embed_factors(f0, sc.dims))
            fields = ("kkt_violations", "n_outer", "n_inner_total")
        else:
            f0 = cpals.init_factors(x.dims, RANK, seed=seeds[i])
            solo = cpals.cp_als(at, RANK, n_iters=n_iters, tol=svc.tol,
                                plan=p, views=views,
                                factors=batched.embed_factors(f0, sc.dims))
            fields = ("fits",)
        _same_bits(f"{label} tenant {i}", out[i].result, solo, fields)
        members.append((at, views))
    return members


def _fault(m, label, site, arm, run, expect_fired=1) -> tuple:
    """``run()`` with ``site`` armed; the site must fire ``expect_fired``
    times. Returns (run's result, seconds)."""
    fl = m["faults"]
    fl.reset()
    fl.arm(site, **arm)
    _sync()
    t0 = time.perf_counter()
    out = run()
    _sync()
    seconds = time.perf_counter() - t0
    fired = fl.fired().get(site, 0)
    fl.reset()
    if fired != expect_fired:
        _fail(f"{label}: {site} fired {fired} times, expected "
              f"{expect_fired}")
    return out, seconds


def _bucket_now(m, svc, xs, seeds):
    """``xs`` served by the caller's `process()`, responses in order."""
    ids = [svc.submit(x, seed=s) for x, s in zip(xs, seeds)]
    got = {r.request_id: r for r in svc.process()}
    return [got[rid] for rid in ids]


def serve_faults(m, clean_a, xs_a, clean_b, xs_b, chicago, store) -> dict:
    """Each fault site armed on its own, with the outcome it must give."""
    Svc = m["serve"].CpdService
    out = {}
    K = SERVE_CAPACITY["A"]
    xa, sa = xs_a[:K], list(range(K))

    def svc_a(**kw):
        kw.setdefault("tune", "auto")
        return Svc(RANK, "cp_als", capacity=K, n_iters=5, tol=0.0,
                   retry_base_s=1e-3, **kw)

    def mates_equal(label, rs, skip=()):
        for i, r in enumerate(rs):
            if i in skip:
                continue
            if not r.ok:
                _fail(f"{label}: tenant {i} error {r.error}")
            _same_bits(f"{label} tenant {i}", r.result, clean_a[i].result,
                       ("fits",))

    # batched.nan: NaN, then a huge but finite value, in slot 3 at sweep 3.
    for value in (float("nan"), 1e30):
        label = f"serve batched.nan {value}"
        svc = svc_a()
        rs, sec = _fault(m, label, "batched.nan",
                         dict(data={"tenant": 3, "value": value}, after=2),
                         lambda: _bucket_now(m, svc, xa, sa))
        r3 = rs[3]
        if r3.ok or "quarantined" not in r3.error or not r3.degraded:
            _fail(f"{label}: tenant 3 ok={r3.ok} error={r3.error}")
        if r3.result.fits != clean_a[3].result.fits[:2] or not all(
                bool(torch.isfinite(f).all()) for f in r3.result.factors):
            _fail(f"{label}: tenant 3 rollback {r3.result.fits}")
        mates_equal(label, rs, skip=(3,))
        s = svc.stats()
        if s["quarantined_tenants"] != 1 or s["errors"] != 1:
            _fail(f"{label}: stats {s}")
        out[f"batched_nan_{value}"] = {"seconds": sec}
    # batched.sweep x1: the bucket is bisected, every member served alone.
    svc = svc_a()
    rs, sec = _fault(m, "serve batched.sweep", "batched.sweep", {},
                     lambda: _bucket_now(m, svc, xa, sa))
    if any(r.bucket_size != 1 for r in rs):
        _fail("serve batched.sweep: a member was not re-run alone")
    mates_equal("serve batched.sweep", rs)
    out["batched_sweep_bisect"] = {"seconds": sec}
    # batched.sweep twice, after one good sweep: the first solo re-run
    # fails too, and only that tenant gets an error.
    svc = svc_a()
    rs, sec = _fault(m, "serve batched.sweep x2", "batched.sweep",
                     dict(times=2, after=1),
                     lambda: _bucket_now(m, svc, xa, sa),
                     expect_fired=2)
    if rs[0].ok or "quarantined after repeated failures" not in rs[0].error:
        _fail(f"serve batched.sweep x2: tenant 0 {rs[0].error}")
    mates_equal("serve batched.sweep x2", rs, skip=(0,))
    if svc.stats()["quarantined_tenants"] != 1:
        _fail(f"serve batched.sweep x2: stats {svc.stats()}")
    out["batched_sweep_quarantine"] = {"seconds": sec}
    # views.build x1: one retry, the same bits.
    m["views"].cache_clear()
    svc = svc_a()
    rs, sec = _fault(m, "serve views.build", "views.build", {},
                     lambda: _bucket_now(m, svc, xa, sa))
    if any(r.retries != 1 for r in rs) or svc.stats()["retries"] != 1:
        _fail(f"serve views.build: retries {[r.retries for r in rs]}")
    mates_equal("serve views.build", rs)
    out["views_build_retry"] = {"seconds": sec}
    # autotune.store: the corrupt store reads as a miss (the class is
    # tuned again), not a crash.
    svc = svc_a()
    r0 = m["ops"].timing_runs()
    rs, sec = _fault(m, "serve autotune.store", "autotune.store", {},
                     lambda: _bucket_now(m, svc, xa, sa))
    if not all(r.ok for r in rs) or m["ops"].timing_runs() == r0:
        _fail("serve autotune.store: not served, or the corrupt store "
              "was not a miss")
    out["autotune_store_miss"] = {"seconds": sec,
                                  "timing_runs": m["ops"].timing_runs() - r0}
    # plan.dispatch on the stored plan: evicted, the static plan served.
    sc = m["shapeclass"].classify(xa[0], RANK)
    key = m["autotune"].class_plan_key(sc, "cuda")
    if key not in m["autotune"].load_store(store):
        _fail("serve plan.dispatch: class A's plan is not stored")
    svc = svc_a()
    rs, sec = _fault(m, "serve plan.dispatch", "plan.dispatch", {},
                     lambda: _bucket_now(m, svc, xa, sa))
    s = svc.stats()
    if (not all(r.ok and r.degraded for r in rs) or s["plan_evictions"] != 1
            or s["degraded_dispatches"] != 0
            or key in m["autotune"].load_store(store)):
        _fail(f"serve plan.dispatch: stats {s}")
    static = m["plan"].make_class_plan(sc)
    if svc._class_plan(sc) != static:
        _fail("serve plan.dispatch: the static plan did not take over")
    out["plan_dispatch_evict"] = {"seconds": sec,
                                  "same_bits_as_tuned": all(
                                      r.result.fits == clean_a[i].result.fits
                                      for i, r in enumerate(rs))}
    # ops.exec twice on a class B bucket: a DispatchError under the static
    # plan has no rung (the kernels are never swapped for their plain
    # versions), so the bucket is bisected; the first solo re-run fails
    # too and only that tenant gets an error. Its mates are served alone
    # on the kernels, each with the clean run's bits.
    KB = SERVE_CAPACITY["B"]
    svc = Svc(RANK, "cp_apr", capacity=KB, n_iters=3, tune="off",
              retry_base_s=1e-3)
    sc_b = m["shapeclass"].classify(xs_b[0], RANK)
    kernels_b = set(_bucket_kernels(m, m["plan"].make_class_plan(sc_b),
                                    apr=True))

    def run_b():
        return _counted(m, "serve ops.exec", lambda: _bucket_now(
            m, svc, xs_b[:KB], list(range(1000, 1000 + KB))), kernels_b)
    (rs, _, counts), sec = _fault(m, "serve ops.exec", "ops.exec",
                                  dict(times=2), run_b, expect_fired=2)
    s = svc.stats()
    r0 = rs[0]
    if (r0.ok or "quarantined after repeated failures" not in r0.error
            or "injected dispatch failure" not in r0.error):
        _fail(f"serve ops.exec: tenant 0 ok={r0.ok} error={r0.error}")
    if (any(r.degraded for r in rs) or s["degraded_dispatches"]
            or s["plan_evictions"] or s["quarantined_tenants"] != 1
            or s["errors"] != 1 or svc._class_plan(sc_b).backend != "cuda"):
        _fail(f"serve ops.exec: stats {s}")
    for i, r in enumerate(rs[1:], 1):
        if not r.ok or r.bucket_size != 1:
            _fail(f"serve ops.exec tenant {i}: ok={r.ok} bucket "
                  f"{r.bucket_size} error={r.error}")
        _same_bits(f"serve ops.exec tenant {i}", r.result, clean_b[i].result,
                   ("kkt_violations", "n_outer", "n_inner_total"))
    out["ops_exec_bisect"] = {
        "seconds": sec, "launches": {k: v for k, v in
                                     counts["launches"].items() if v}}
    # ingest.merge: the delta gets an error, its base stays serviceable.
    svc = svc_a()
    base = _bucket_now(m, svc, xa[:1], sa[:1])[0]
    coords, values = _delta(xa[0].dims, 100, 7)

    def delta():
        did = svc.submit_delta(base.request_id, coords, values)
        return {x.request_id: x for x in svc.process()}[did]
    r, sec = _fault(m, "serve ingest.merge", "ingest.merge", {}, delta)
    if r.ok or "resubmit is safe" not in r.error:
        _fail(f"serve ingest.merge: {r.error}")
    did = svc.submit_delta(base.request_id, coords, values)
    r = {x.request_id: x for x in svc.process()}[did]
    if not r.ok:
        _fail(f"serve ingest.merge resubmit: {r.error}")
    out["ingest_merge"] = {"seconds": sec}
    out.update(serve_stream_faults(m, chicago))
    return out


def serve_stream_faults(m, chicago) -> dict:
    """``ops.chunk_oom`` on Chicago's streamed plan through
    `health.degrade_plan` (chunk_m halved, the same bits), then
    ``stream.memmap_load``, ``stream.checksum`` and ``stream.respill`` on
    a spilled Chicago mode stream."""
    at, stream = chicago["at"], m["stream"]
    ps = streamed_plan(m, at.meta)
    hs, _ = _streamed_views(m, at, ps)
    fs = _factors(at.dims, seed=0)

    def als(p):
        return m["cpals"].cp_als(at, RANK, n_iters=2, tol=0.0, factors=fs,
                                 plan=p, views=hs)
    clean = als(ps)
    fl = m["faults"]
    fl.reset()
    fl.arm("ops.chunk_oom", after=ps.streaming.n_chunks + 3)
    t0 = time.perf_counter()
    try:
        als(ps)
        _fail("serve ops.chunk_oom: no allocator failure")
    except torch.OutOfMemoryError as exc:
        halved, why = m["health"].degrade_plan(ps, exc)
    fl.reset()
    if halved is None or halved.streaming.chunk_m >= ps.streaming.chunk_m:
        _fail(f"serve ops.chunk_oom: no halved plan ({why})")
    again = als(halved)
    _sync()
    sec = time.perf_counter() - t0
    _same_bits("serve ops.chunk_oom", again, clean, ("fits",))
    out = {"chunk_oom_halve": {"seconds": sec, "why": why,
                               "n_chunks": [ps.streaming.n_chunks,
                                            halved.streaming.n_chunks]}}
    # A spilled Chicago mode stream.
    spill = ROOT / "build" / "chip_smoke_serve" / "spill"
    shutil.rmtree(spill, ignore_errors=True)
    mode = 1
    mapped = stream.to_memmap(hs[mode], spill)
    t0 = time.perf_counter()
    fl.arm("stream.memmap_load")
    try:
        stream.from_memmap(spill, at.meta, mode)
        _fail("serve stream.memmap_load: the read did not fail")
    except OSError:
        again = stream.from_memmap(spill, at.meta, mode)
    fl.reset()
    if again.checksum != mapped.checksum:
        _fail("serve stream.memmap_load: the retry read another stream")
    out["memmap_load_retry"] = {"seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rebuilds = stream.integrity_stats()["rebuilds"]
    fl.arm("stream.checksum")
    rebuilt = stream.load_or_rebuild(spill, at, mode)
    fl.reset()
    if (stream.integrity_stats()["rebuilds"] != rebuilds + 1
            or not all(torch.equal(getattr(rebuilt, f), getattr(mapped, f))
                       for f in ("rows", "words", "values"))):
        _fail("serve stream.checksum: no rebuild, or another stream")
    out["checksum_rebuild"] = {"seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    coords, values = _delta(at.dims, 1000, 11)
    grown = m["ingest"].append_delta(at, coords, values,
                                     invalidate_stale=False)
    fl.arm("stream.respill")
    try:
        stream.append_stream(rebuilt, grown)
        _fail("serve stream.respill: the respill did not fail")
    except m["faults"].InjectedInterrupt:
        pass
    fl.reset()
    old = stream.from_memmap(spill, at.meta, mode)
    if old.checksum != mapped.checksum or not torch.equal(old.words,
                                                          mapped.words):
        _fail("serve stream.respill: the old generation did not survive")
    redo = stream.append_stream(old, grown)
    fresh = stream.host_stream(grown, mode)
    if not (torch.equal(redo.words, fresh.words)
            and torch.equal(redo.values, fresh.values)):
        _fail("serve stream.respill: the retry differs from a rebuild")
    out["respill_interrupt"] = {"seconds": time.perf_counter() - t0}
    del hs, grown, fresh, redo, old, rebuilt, mapped
    m["views"].cache_clear()
    shutil.rmtree(spill, ignore_errors=True)
    return out


def phase_serve(m, buckets, chicago) -> dict:
    """The service (`launch.serve_cpd`) on classes A and B at full width:
    clean runs with the worker and submitter threads, a second service on
    the warm store, deltas, the guard's cost, then every fault site."""
    env = m["autotune"].PLAN_CACHE_ENV
    saved = os.environ.get(env)
    root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    os.environ[env] = str(root / "plans.json")
    try:
        return _phase_serve(m, buckets, chicago, root / "plans.json")
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
        m["faults"].reset()
        shutil.rmtree(root, ignore_errors=True)


def _phase_serve(m, buckets, chicago, store) -> dict:
    Svc, fl = m["serve"].CpdService, m["faults"]
    t_start = time.perf_counter()
    fl.reset()
    out, runs = {}, []
    # 1. Clean CP-ALS service, class A, tuned on a cold store.
    K = SERVE_CAPACITY["A"]
    xs_a = _bucket_tensors(m, BUCKET_CLASSES["A"])
    seeds_a = list(range(len(xs_a)))
    svc = Svc(RANK, "cp_als", capacity=K, n_iters=5, tol=0.0, guard=True,
              tune="auto", max_wait_s=0.05)
    r0 = m["ops"].timing_runs()
    clean_a, wall_a, c = _served(m, "serve class A", svc, xs_a, seeds_a)
    runs.append(c)
    sa = svc.stats()
    _serve_stats_zero("serve class A", sa)
    members = _solo_equal(m, "serve class A", svc, xs_a, seeds_a, clean_a,
                          5, apr=False)
    sc_a = m["shapeclass"].classify(xs_a[0], RANK)
    p_a = svc._class_plan(sc_a)
    out["A"] = {"tenants": len(xs_a), "capacity": K, "wall_s": wall_a,
                "tune_timing_runs": m["ops"].timing_runs() - r0,
                "plan": [(mp.traversal.value, mp.r_block, mp.block_m)
                         for mp in p_a.modes],
                "launches": c["launches"],
                **{k: sa[k] for k in ("buckets_run", "tenants_per_s",
                                      "latency_p50_s", "latency_p99_s")},
                "wall_tenants_per_s": len(xs_a) / wall_a,
                "direct_bucket_tenants_per_s":
                    buckets["A"]["cp_als"]["tenants_per_s"]}
    # Zero warm-up: a second service on the same store, 16 more tenants,
    # one bucket: no timing run, one launch per kernel and mode a sweep.
    xs_w = _bucket_tensors(m, dict(BUCKET_CLASSES["A"], tenants=K,
                                   seed=103))
    svc_w = Svc(RANK, "cp_als", capacity=K, n_iters=5, tol=0.0,
                tune="auto", max_wait_s=0.05)
    r0 = m["ops"].timing_runs()
    _, wall_w, c = _served(m, "serve class A warm", svc_w, xs_w,
                           list(range(K)))
    runs.append(c)
    if m["ops"].timing_runs() != r0 or svc_w._class_plan(sc_a) != p_a:
        _fail("serve: the second service measured, or took another plan")
    per_sweep = {k: v // 5 for k, v in c["launches"].items() if v}
    expect = _bucket_kernels(m, p_a, apr=False)
    if per_sweep != expect or any(v % 5 for v in c["launches"].values()):
        _fail(f"serve: launches {c['launches']} in 5 sweeps, expected "
              f"{expect} a sweep")
    # phase_batched's capacity-16 bucket (the same 16 tenants, one sweep)
    # under the service's class plan: the same launches a sweep; under the
    # static plan, also phase_batched's own count.
    ats = [a for a, _ in members[:K]]
    vws = [v for _, v in members[:K]]
    dims = [x.dims for x in xs_a[:K]]
    bat = m["batched"]
    _, _, c = _counted(m, "serve class A capacity 16", lambda:
                       bat.batched_cp_als(ats, vws, dims, RANK, plan=p_a,
                                          n_iters=1, tol=0.0, capacity=K),
                       set())
    cap16_tuned = {k: v for k, v in c["launches"].items() if v}
    if per_sweep != cap16_tuned:
        _fail(f"serve: launches a sweep {per_sweep} against phase_batched's "
              f"capacity-16 bucket under the same plan {cap16_tuned}")
    static_a = m["plan"].make_class_plan(sc_a)
    cap16 = {k: v for k, v in
             buckets["A"]["capacity_launches"][16].items() if v}
    if p_a == static_a and per_sweep != cap16:
        _fail(f"serve: launches a sweep {per_sweep} against phase_batched's "
              f"{cap16} at capacity 16")
    out["A"].update(warm_wall_s=wall_w, warm_launches_per_sweep=per_sweep,
                    cap16_same_plan=cap16_tuned, phase_batched_cap16=cap16,
                    plan_is_static=p_a == static_a)
    # The guard: class A again unguarded (the same bits), and its share
    # of a direct bucket's sweep.
    svc_ng = Svc(RANK, "cp_als", capacity=K, n_iters=5, tol=0.0,
                 guard=False, tune="auto")
    ng, wall_ng, c = _served(m, "serve class A unguarded", svc_ng, xs_a,
                             seeds_a, threads=False)
    runs.append(c)
    for i in range(len(xs_a)):
        _same_bits(f"serve class A unguarded tenant {i}", ng[i].result,
                   clean_a[i].result, ("fits",))
    times = {True: [], False: []}
    for guard in (False, True, True, False) * 2:
        _sync()
        t0 = time.perf_counter()
        bat.batched_cp_als(ats, vws, dims, RANK, plan=p_a, n_iters=5,
                           tol=0.0, seeds=seeds_a[:K], capacity=K,
                           guard=guard)
        _sync()
        times[guard].append((time.perf_counter() - t0) / 5 * 1e3)
    sweep = {g: sum(v) / len(v) for g, v in times.items()}
    fac = bat.stack_tenants([m["batched"].embed_factors(
        m["cpals"].init_factors(d, RANK, seed=i), sc_a.dims)
        for i, d in enumerate(dims)])
    leaves = [*fac, torch.ones((K, RANK), device=fac[0].device), fac[-1]]
    check_ms = _ms(m, m["health"].tenants_finite, leaves)
    out["guard"] = {"sweep_ms": sweep[True], "unguarded_sweep_ms":
                    sweep[False], "share": (sweep[True] - sweep[False])
                    / sweep[False], "check_ms": check_ms,
                    "check_share": check_ms / sweep[False]}
    # 2. Clean CP-APR service, class B.
    KB = SERVE_CAPACITY["B"]
    xs_b = _bucket_tensors(m, BUCKET_CLASSES["B"])
    seeds_b = [1000 + i for i in range(len(xs_b))]
    svc_b = Svc(RANK, "cp_apr", capacity=KB, n_iters=3, tune="off",
                max_wait_s=0.05)
    clean_b, wall_b, c = _served(m, "serve class B", svc_b, xs_b, seeds_b)
    runs.append(c)
    sb = svc_b.stats()
    _serve_stats_zero("serve class B", sb)
    _solo_equal(m, "serve class B", svc_b, xs_b, seeds_b, clean_b, 3,
                apr=True)
    out["B"] = {"tenants": len(xs_b), "capacity": KB, "wall_s": wall_b,
                "launches": c["launches"],
                **{k: sb[k] for k in ("buckets_run", "tenants_per_s",
                                      "latency_p50_s", "latency_p99_s")},
                "wall_tenants_per_s": len(xs_b) / wall_b,
                "direct_bucket_tenants_per_s":
                    buckets["B"]["cp_apr"]["tenants_per_s"]}
    # 3. Deltas: 1 % of eight class A tenants' nonzeros, each equal to a
    # direct append and warm start.
    ids = {}
    for i in range(8):
        coords, values = _delta(xs_a[i].dims, max(1, xs_a[i].nnz // 100),
                                500 + i)
        ids[i] = (svc.submit_delta(clean_a[i].request_id, coords, values),
                  coords, values)
    got, delta_s, c = _counted(m, "serve deltas", lambda: {
        r.request_id: r for r in svc.process()}, set())
    runs.append(c)
    lat = []
    for i, (did, coords, values) in ids.items():
        r = got[did]
        if not r.ok:
            _fail(f"serve delta {i}: {r.error}")
        at = m["alto"].build_device(xs_a[i], n_partitions=8,
                                    compute_reuse=False)
        grown = m["ingest"].append_delta(at, coords, values)
        want = m["cpals"].cp_als(grown, RANK, n_iters=5, tol=0.0,
                                 warm_start=clean_a[i].result, guard=True)
        _same_bits(f"serve delta {i}", r.result, want, ("fits",))
        lat.append(r.latency_s)
    out["deltas"] = {"count": len(ids), "seconds": delta_s,
                     "latency_s": lat}
    # 4. The clean runs fired nothing and counted nothing.
    if fl.fired():
        _fail(f"serve: faults fired on the clean runs: {fl.fired()}")
    for label, s in (("class A", svc.stats()), ("class B", svc_b.stats()),
                     ("warm", svc_w.stats()), ("unguarded", svc_ng.stats())):
        _serve_stats_zero(f"serve {label}", s)
    # 5. The fault sites.
    out["faults"] = serve_faults(m, clean_a, xs_a, clean_b, xs_b, chicago,
                                 store)
    out["runs"] = [{"launches": c["launches"], "elements": c["elements"]}
                   for c in runs]
    out["seconds"] = time.perf_counter() - t_start
    del members, ats, vws
    m["views"].cache_clear()
    a, b, g = out["A"], out["B"], out["guard"]
    print(f"chip_smoke: serve: class A {a['tenants']} tenants, capacity "
          f"{a['capacity']}, {SERVE_THREADS} submitters: "
          f"{a['wall_tenants_per_s']:.1f} tenants/s wall "
          f"({a['tenants_per_s']:.1f} busy; direct bucket "
          f"{a['direct_bucket_tenants_per_s']:.1f}), p50 "
          f"{a['latency_p50_s'] * 1e3:.0f} ms, p99 "
          f"{a['latency_p99_s'] * 1e3:.0f} ms, {a['buckets_run']} buckets, "
          f"plan {a['plan']} (static {a['plan_is_static']}), tuned in "
          f"{a['tune_timing_runs']} timing runs; warm store: 0 timing runs, "
          f"launches a sweep {a['warm_launches_per_sweep']}; class B "
          f"{b['tenants']} CP-APR tenants: {b['wall_tenants_per_s']:.2f} "
          f"tenants/s wall (direct bucket "
          f"{b['direct_bucket_tenants_per_s']:.2f}), p50 "
          f"{b['latency_p50_s']:.2f} s, p99 {b['latency_p99_s']:.2f} s; "
          f"every tenant equal to its solo run; {out['deltas']['count']} "
          f"deltas equal to append + warm start; guard {g['sweep_ms']:.1f} "
          f"against {g['unguarded_sweep_ms']:.1f} ms a sweep (check "
          f"{g['check_ms']:.3f} ms); faults: " + ", ".join(
              f"{k} {v['seconds']:.2f} s" for k, v in out["faults"].items())
          + f"; {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Row-range-sharded CP-ALS and CP-APR over a process group (dist.cpd)
# ---------------------------------------------------------------------------

DIST_SHARDS = (2, 4, 8)     # shard counts run one slice at a time
DIST_RANKS = 2              # gloo ranks sharing the one card
DIST_TIMEOUT_S = 600.0
DIST_FIT_TOL = 1e-4


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same_plan_tiles(label, a, b) -> None:
    tiles = [[(mp.traversal, mp.r_block, mp.block_m, mp.threads)
              for mp in p.modes] for p in (a, b)]
    if tiles[0] != tiles[1]:
        _fail(f"{label}: sharded plan {tiles[0]} against {tiles[1]}")


def run_dist_cp_als(m, at, n_iters: int, label: str) -> dict:
    """One counted `distributed_cp_als` run on the world group, from
    `_factors` with seed 0 (as `run_cp_als`)."""
    sp = m["plan"].make_plan(at.meta, RANK,
                             shards=torch.distributed.get_world_size())
    fs = _factors(at.dims, seed=0)
    (lam, factors, fits), seconds, counts = _counted(
        m, label, lambda: m["cpd"].distributed_cp_als(
            at, RANK, n_iters=n_iters, tol=0.0, factors=fs),
        als_kernels(m, sp))
    if len(fits) != n_iters or not all(math.isfinite(f) for f in fits):
        _fail(f"{label}: fits {fits}")
    print(f"chip_smoke: {label}: traversals {sp.traversals()} fits {fits} "
          f"in {seconds:.3f} s; launches {counts['launches']}")
    return {"traversals": sp.traversals(), "fits": fits, "seconds": seconds,
            "launches": counts["launches"], "elements": counts["elements"],
            "lam": lam, "factors": factors, "plan": sp}


def _sweep_ms(m, at, p, factors, lam, gram_fn=None) -> float:
    views = m["plan"].build_views(at, p)
    _sync()
    t0 = time.perf_counter()
    m["cpals"]._sweep(p, at, views, factors, lam, gram_fn)
    _sync()
    return (time.perf_counter() - t0) * 1e3


def _typical(plain) -> float:
    """The median |value| of the nonzero entries of ``plain``, from a
    strided sample of about 2^20 of its elements."""
    flat = plain.reshape(-1)
    flat = flat[::max(1, flat.numel() >> 20)].abs()
    flat = flat[flat > 0]
    return float(flat.median()) if flat.numel() else 0.0


def check_shard_slices(m, at, mode, factors, B, label, *, pi=None,
                       phi_factors=None) -> dict:
    """`DIST_SHARDS` ranks' slices of one mode's stream, one slice at a
    time on the card, through the shard-local functions the sharded path
    calls (`cpd.local_mttkrp`, `cpd.local_phi`: the kernels on the
    slice's row window): K1, K2 + the split + the fix-up (on the CP-ALS
    ``factors``), K5 and K6 (Φ of the CP-APR model ``B``, with ``pi``
    under ALTO-PRE, else ``phi_factors``: the model's own factors, so
    that its values at the nonzeros are positive and Φ stays at the
    scale of the data) on each slice against their plain versions on the
    same slice at full width; K1 ≡ K2 + merge and K5 ≡ K6 + merge; zeros
    off the slice's rows; K1 on the window into a NaN-filled output equal
    to K1 (every row written). Then the slices summed in rank order
    against the unsharded kernel at that tolerance. Returns the largest
    errors, beside each the largest and the smallest median |plain| the
    tolerance was taken from, and the seconds."""
    if (pi is None) == (phi_factors is None):
        _fail(f"{label}: pass exactly one of pi= / phi_factors=")
    ops, kori, cpd = m["ops"], m["kori"], m["cpd"]
    trav = m["heuristics"].Traversal
    enc = at.meta.enc
    I_n = at.dims[mode]
    eps = 1e-10
    view = m["views"].get_view(at, mode)
    keys = ("K1", "K2", "K5", "K6", "K1_sum", "K5_sum")
    errs = dict.fromkeys(keys, 0.0)
    max_plain = dict.fromkeys(keys, 0.0)
    median_plain = dict.fromkeys(keys, math.inf)
    bitwise = dict.fromkeys(keys, 0)    # comparisons equal bit for bit
    n_checks = dict.fromkeys(keys, 0)

    def close(key, name, got, ref):
        errs[key] = max(errs[key], _check_close(name, got, ref))
        max_plain[key] = max(max_plain[key], float(ref.abs().max()))
        median_plain[key] = min(median_plain[key], _typical(ref))
        bitwise[key] += torch.equal(got, ref)
        n_checks[key] += 1

    def plain(runs):
        """The plain runs pass ``runs()`` through the plain fix-up, with
        `index_add_` in index order."""
        with _index_order():
            o, cr, cv = runs()
            return kori.carry_fixup_plain(cr, cv, o)
    t0 = time.perf_counter()
    for D in DIST_SHARDS:
        sp = m["plan"].make_plan(at.meta, RANK, shards=D)
        mp = sp.modes[mode]
        bm, rb, th = mp.block_m, mp.r_block, mp.threads
        routed = {t: dataclasses.replace(sp, modes=tuple(
            dataclasses.replace(q, traversal=t) if q.mode == mode else q
            for q in sp.modes))
            for t in (trav.ORIENTED_CARRY, trav.OUTPUT_ORIENTED)}
        carry, onehot = routed[trav.ORIENTED_CARRY], routed[
            trav.OUTPUT_ORIENTED]
        rows, words, values, pi_p = ops.pad_sorted_stream(
            view.rows, view.words, view.values, D * bm, pi=pi)
        s1 = s5 = None
        for r in range(D):
            sl = cpd._slice(rows.shape[0], D, r)
            tag = f"{label} D={D} slice {r}"
            rs, ws, vs = rows[sl], words[sl], values[sl]
            args = (enc, mode, rs, ws, vs, factors)
            phi_kw = (dict(factors=None, pi=pi_p[sl]) if pi is not None
                      else dict(factors=phi_factors, pi=None))
            k1 = cpd.local_mttkrp(carry, mode, rs, ws, vs, factors)
            lo, hi = int(rs[0]), int(rs[-1])
            if bool(k1[:lo].any()) or bool(k1[hi + 1:].any()):
                _fail(f"{tag} K1: a row off the slice's rows {lo}..{hi} "
                      f"is not zero")
            w = hi - lo + 1
            _check_equal(f"{tag} K1 on the window into a NaN-filled output",
                         k1[lo:hi + 1], kori.mttkrp_oriented_carry(
                             enc, mode, rs - lo, ws, vs, factors, bm, rb, th,
                             out=torch.full((w, RANK), float("nan"),
                                            device=k1.device), n_rows=w))
            close("K1", f"{tag} K1", k1,
                  plain(lambda: kori.carry_runs_plain(*args, bm)))
            k2 = cpd.local_mttkrp(onehot, mode, rs, ws, vs, factors)
            close("K2", f"{tag} K2 + split + fix-up", k2,
                  plain(lambda: kori.split_block_runs(
                      kori.oriented_partials_plain(*args, bm), rs, I_n)))
            _check_equal(f"{tag} K1 vs K2 + segment_merge", k1, k2)
            del k2
            k5 = cpd.local_phi(carry, mode, eps, rs, ws, vs, B, **phi_kw)
            close("K5", f"{tag} K5", k5,
                  plain(lambda: kori.phi_carry_runs_plain(
                      enc, mode, eps, rs, ws, vs, B, **phi_kw, block_m=bm)))
            k6 = cpd.local_phi(onehot, mode, eps, rs, ws, vs, B, **phi_kw)
            close("K6", f"{tag} K6 + split + fix-up", k6,
                  plain(lambda: kori.split_block_runs(
                      kori.phi_oriented_partials_plain(
                          enc, mode, eps, rs, ws, vs, B, **phi_kw,
                          block_m=bm), rs, I_n)))
            _check_equal(f"{tag} K5 vs K6 + segment_merge", k5, k6)
            del k6
            s1 = k1 if s1 is None else s1 + k1
            s5 = k5 if s5 is None else s5 + k5
        close("K1_sum", f"{label} D={D} K1 slices summed", s1,
              ops.mttkrp_oriented_carry(view, factors, bm, rb, th))
        whole_kw = (dict(pi=pi) if pi is not None
                    else dict(factors=phi_factors))
        close("K5_sum", f"{label} D={D} K5 slices summed", s5,
              ops.cpapr_phi_oriented_carry(view, B, eps=eps, block_m=bm,
                                           threads=th, **whole_kw))
        del s1, s5, rows, words, values, pi_p
    out = {"max_abs_err": errs, "max_plain": max_plain,
           "median_plain": median_plain, "bitwise": bitwise,
           "checks": n_checks, "seconds": time.perf_counter() - t0}
    print(f"chip_smoke: {label}: slices of {DIST_SHARDS} shards ok, worst "
          f"errors {errs}; max|plain| {max_plain}; smallest median "
          f"|plain| (nonzero) {median_plain}; bit for bit {bitwise} of "
          f"{n_checks}")
    return out


def _dist_rank(rank: int, world: int, addr: str, out_dir: str,
               coo_dir: str, n_iters: int) -> None:
    """One gloo rank of `phase_dist`'s run on the one card (a spawned
    process): builds the DARPA tensor from the saved COO, holds each mode's
    MTTKRP of the first sweep against the in-process sum of the
    ``world`` slices, runs ``n_iters`` counted CP-ALS iterations through
    `distributed_cp_als`, and appends the 1 % delta through
    `sharded_append_delta` against `append_delta`. Writes its results to
    ``out_dir/rank<r>.json``."""
    import functools
    import traceback
    out_dir = pathlib.Path(out_dir)
    marks = [("start", time.perf_counter())]

    def mark(what):
        _sync()
        marks.append((what, time.perf_counter()))
    try:
        m = _imports()
        m["build"].build_all()          # loads the parent's build
        dist, cpd = torch.distributed, m["cpd"]
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
        mark("imports")
        dist.init_process_group("gloo", init_method=addr, world_size=world,
                                rank=rank)
        mark("init")
        from repro_torch.sparse.tensor import SparseTensor
        coo = pathlib.Path(coo_dir)
        x = SparseTensor(tuple(json.loads((coo / "dims.json").read_text())),
                         np.load(coo / "coords.npy"),
                         np.load(coo / "values.npy"))
        _sync()
        t0 = time.perf_counter()
        at = m["alto"].build_device(x, n_partitions=1024)
        _sync()
        build_s = time.perf_counter() - t0
        del x
        sp = m["plan"].make_plan(at.meta, RANK, shards=world)
        views = m["plan"].build_views(at, sp)
        fs = _factors(at.dims, seed=0)
        mark("tensor and views")
        # The first sweep: each mode's all-reduced MTTKRP against the sum
        # of the world's slices computed in this process, in rank order.
        calls = []
        sharded = cpd.sharded_mttkrp

        def capture(plan, at_, views_, factors, mode, group=None):
            out = sharded(plan, at_, views_, factors, mode, group=group)
            calls.append((mode, list(factors), out))
            return out
        cpd.sharded_mttkrp = capture
        try:
            m["cpals"]._sweep(sp, at, views, fs,
                              torch.ones(RANK, device=at.device),
                              functools.partial(cpd.sharded_gram))
        finally:
            cpd.sharded_mttkrp = sharded
        bitwise = []
        ops = m["ops"]
        for mode, factors, got in calls:
            v = views[mode]
            rows, words, values, _ = ops.pad_sorted_stream(
                v.rows, v.words, v.values, cpd._shard_mult(sp, mode))
            acc = None
            for r in range(world):
                sl = cpd._slice(rows.shape[0], world, r)
                part = cpd.local_mttkrp(sp, mode, rows[sl], words[sl],
                                        values[sl], factors)
                acc = part if acc is None else acc + part
            bitwise.append(bool(torch.equal(got, acc)))
            del acc, part, rows, words, values
        del calls
        mark("first sweep and its checks")
        m["build"].reset_counts()
        t0 = time.perf_counter()
        lam, factors, fits = cpd.distributed_cp_als(
            at, RANK, n_iters=n_iters, tol=0.0, factors=fs)
        _sync()
        seconds = time.perf_counter() - t0
        counts = m["build"].counts()
        mark("cp_als")
        # The collective that carries a sweep's largest output: the mode-2
        # MTTKRP, through gloo (host copies and a TCP ring) on one card.
        big = torch.ones((max(at.dims), RANK), device=at.device)
        _sync()
        t0 = time.perf_counter()
        dist.all_reduce(big)
        _sync()
        gloo_ms = (time.perf_counter() - t0) * 1e3
        if not bool((big == world).all()):
            _fail(f"rank {rank}: gloo all_reduce of ones gave "
                  f"{float(big.min())}..{float(big.max())}")
        del big
        mark("all_reduce")
        coords, vals = _delta(at.dims, at.nnz // 100, 4)
        _sync()
        t0 = time.perf_counter()
        got = cpd.sharded_append_delta(at, coords, vals,
                                       invalidate_stale=False)
        _sync()
        append_ms = (time.perf_counter() - t0) * 1e3
        ref = m["ingest"].append_delta(at, coords, vals,
                                       invalidate_stale=False)
        same = (torch.equal(got.words, ref.words)
                and torch.equal(got.values, ref.values)
                and torch.equal(got.part_start, ref.part_start)
                and torch.equal(got.part_end, ref.part_end)
                and got.meta == ref.meta)
        mark("appends")
        dist.destroy_process_group()
        result = {"rank": rank, "traversals": sp.traversals(),
                  "split_s": {b[0]: b[1] - a[1]
                              for a, b in zip(marks, marks[1:])},
                  "tiles": [(mp.r_block, mp.block_m, mp.threads)
                            for mp in sp.modes],
                  "build_s": build_s, "first_sweep_bitwise": bitwise,
                  "fits": fits, "seconds": seconds,
                  "all_reduce_mode2_ms": gloo_ms,
                  "launches": counts["launches"],
                  "elements": counts["elements"],
                  "plain_on_cuda": counts["plain_on_cuda"],
                  "append_delta": len(vals), "append_ms": append_ms,
                  "append_bitwise": bool(same),
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def dist_ranks(m, darpa, ws1_fits) -> dict:
    """`DIST_RANKS` gloo ranks on the one card, spawned: 3 CP-ALS
    iterations of DARPA and the sharded 1 % append (`_dist_rank`). Every
    first-sweep MTTKRP must equal its in-process sum bit for bit, the
    ranks' fits must agree and lie within `DIST_FIT_TOL` of the one-rank
    run's, the append must equal `append_delta` bit for bit, and each
    rank must have launched its plan's kernels and no plain version."""
    import multiprocessing
    work = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    x = darpa["x"]
    np.save(work / "coords.npy", x.coords)
    np.save(work / "values.npy", x.values)
    (work / "dims.json").write_text(json.dumps(list(x.dims)))
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    addr = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, DIST_RANKS, addr, str(work), str(work), 3))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            _fail(f"dist ranks still running after {DIST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall_s = time.perf_counter() - t0
    errors = [(work / f"rank{r}.err").read_text()
              for r in range(DIST_RANKS) if (work / f"rank{r}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        _fail("dist ranks failed: exit codes "
              f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    expect = als_kernels(m, m["plan"].make_plan(darpa["at"].meta, RANK,
                                                shards=DIST_RANKS))
    for res in ranks:
        tag = f"dist darpa {DIST_RANKS} ranks (gloo), rank {res['rank']}"
        if not all(res["first_sweep_bitwise"]) or len(
                res["first_sweep_bitwise"]) != len(darpa["at"].dims):
            _fail(f"{tag}: first-sweep MTTKRP against the in-process sum "
                  f"of the slices: {res['first_sweep_bitwise']}")
        if res["fits"] != ranks[0]["fits"]:
            _fail(f"{tag}: fits {res['fits']} against rank 0's "
                  f"{ranks[0]['fits']}")
        diff = max(abs(a - b) for a, b in zip(res["fits"], ws1_fits))
        if len(res["fits"]) != len(ws1_fits) or diff > DIST_FIT_TOL:
            _fail(f"{tag}: fits {res['fits']} against the one-rank run's "
                  f"{ws1_fits}")
        if not res["append_bitwise"]:
            _fail(f"{tag}: sharded_append_delta differs from append_delta")
        for k in expect:
            if res["launches"][k] == 0:
                _fail(f"{tag}: kernel {k} was never launched")
        if any(res["plain_on_cuda"].values()):
            _fail(f"{tag}: plain versions ran on CUDA tensors: "
                  f"{res['plain_on_cuda']}")
        res["fit_diff_to_one_rank"] = diff
    print(f"chip_smoke: dist darpa {DIST_RANKS} ranks (gloo, one card): "
          + "; ".join(f"rank {r['rank']}: fits {r['fits']} in "
                      f"{r['seconds']:.3f} s (a mode-2 all-reduce "
                      f"{r['all_reduce_mode2_ms']:.0f} ms), build "
                      f"{r['build_s']:.2f} s, "
                      f"append {r['append_ms']:.1f} ms, peak "
                      f"{r['peak_memory_bytes'] / 1e9:.2f} GB, launches "
                      f"{r['launches']}" for r in ranks)
          + f"; {wall_s:.1f} s wall with the spawn")
    return {"ranks": ranks, "wall_s": wall_s}


def dist_tuning(m, at) -> dict:
    """The sharded tuner at one rank on a temporary store: its key is not
    the single-device key, the winner is oriented on every mode, and a
    second ``tune="auto"`` is a store hit with no timing run."""
    autotune, plan, ops = m["autotune"], m["plan"], m["ops"]
    store = ROOT / "build" / "chip_smoke_dist_plans.json"
    store.unlink(missing_ok=True)
    try:
        runs0 = ops.timing_runs()
        t0 = time.perf_counter()
        tuned = plan.make_plan(at.meta, RANK, shards=1, tune="auto", at=at,
                               store_path=store)
        tune_s = time.perf_counter() - t0
        runs1 = ops.timing_runs()
        again = plan.make_plan(at.meta, RANK, shards=1, tune="auto", at=at,
                               store_path=store)
        runs2 = ops.timing_runs()
        key = autotune.plan_key(at.meta, RANK, "cuda", device=at.device,
                                shards=1)
        single_key = autotune.plan_key(at.meta, RANK, "cuda",
                                       device=at.device)
        stored = list(autotune.load_store(store))
    finally:
        store.unlink(missing_ok=True)
    if key == single_key or stored != [key]:
        _fail(f"dist tuning: sharded key {key}, single-device key "
              f"{single_key}, stored {stored}")
    if runs2 != runs1 or again != tuned:
        _fail(f"dist tuning: the second make took {runs2 - runs1} timing "
              f"runs")
    if not all(m["heuristics"].is_oriented(mp.traversal)
               for mp in tuned.modes) or tuned.shards != 1:
        _fail(f"dist tuning: winner {tuned.traversals()} shards "
              f"{tuned.shards}")
    print(f"chip_smoke: dist tuning (Chicago, 1 rank): winner "
          f"{tuned.traversals()} tiles "
          f"{[(mp.r_block, mp.block_m) for mp in tuned.modes]} after "
          f"{runs1 - runs0} timing runs in {tune_s:.2f} s; the second make "
          f"{runs2 - runs1}")
    return {"key": key, "single_device_key": single_key,
            "timing_runs": runs1 - runs0, "second_timing_runs": runs2 - runs1,
            "seconds": tune_s, "traversals": tuned.traversals()}


def phase_dist(m, chicago, chicago_apr, darpa, darpa_apr) -> dict:
    """Row-range-sharded CPD (`repro_torch.dist.cpd`) on the one card.

    World size 1 over NCCL: DARPA's 3 CP-ALS iterations through
    `distributed_cp_als` and 2 CP-APR outer iterations under the sharded
    plan, bit for bit `phase_darpa`'s and `phase_darpa_apr`'s runs, the
    sweep's ms against the single-device sweep's; Chicago's 10 CP-ALS
    iterations (mode 0 oriented, not recursive) within `DIST_FIT_TOL` of
    `phase_chicago`'s fits; the sharded tuner (`dist_tuning`). Then the
    slices of 2, 4 and 8 shards one at a time (`check_shard_slices`) on
    DARPA mode 2 (ALTO-PRE) and Chicago modes 0 and 1 (ALTO-OTF), and
    `DIST_RANKS` gloo ranks sharing the card (`dist_ranks`)."""
    dist = torch.distributed
    t_start = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        # NCCL makes its communicator on the first collective: outside the
        # counted runs.
        dist.all_reduce(torch.zeros(1, device=DEVICE))
        _sync()
        init_s = time.perf_counter() - t_start
        d_at, c_at = darpa["at"], chicago["at"]
        _same_plan_tiles("dist darpa",
                         m["plan"].make_plan(d_at.meta, RANK, shards=1),
                         darpa["plan"])
        als = run_dist_cp_als(m, d_at, 3, "dist darpa cp_als (1 rank, nccl)")
        ref = darpa["run"]
        if (als["fits"] != ref["fits"]
                or not torch.equal(als["lam"], ref["res"].lam)
                or not all(torch.equal(a, b) for a, b in
                           zip(als["factors"], ref["res"].factors))):
            _fail(f"dist darpa cp_als (1 rank): fits {als['fits']} against "
                  f"phase_darpa's {ref['fits']}, or factors differ")
        sp = als["plan"]
        single_ms, sharded_ms = [], []
        gram = m["cpd"].sharded_gram
        for turn in range(6):
            for kind in (("single", "sharded") if turn % 2 == 0
                         else ("sharded", "single")):
                if kind == "single":
                    single_ms.append(_sweep_ms(m, d_at, darpa["plan"],
                                               als["factors"], als["lam"]))
                else:
                    sharded_ms.append(_sweep_ms(m, d_at, sp, als["factors"],
                                                als["lam"], gram))
        # What the sharded sweep adds: the all-reduce of the largest
        # output, and a Gram through the collective against A.T @ A.
        big = torch.empty((max(d_at.dims), RANK), device=DEVICE)
        A = als["factors"][0]
        collective_ms = {
            "all_reduce_mode2_out": _ms(m, dist.all_reduce, big),
            "sharded_gram": _ms(m, gram, A), "gram": _ms(m, lambda: A.T @ A)}
        del big
        apr = run_cp_apr(m, d_at, sp, 2, "dist darpa cp_apr (1 rank, nccl)")
        aref = darpa_apr["run"]
        if (apr["log_likelihoods"] != aref["log_likelihoods"]
                or apr["kkt_violations"] != aref["kkt_violations"]):
            _fail(f"dist darpa cp_apr (1 rank): {apr['log_likelihoods']} "
                  f"{apr['kkt_violations']} against phase_darpa_apr's "
                  f"{aref['log_likelihoods']} {aref['kkt_violations']}")
        # The JAX routing (one-hot on every mode: K2 + split + fix-up, K6)
        # under the sharded plan: phase_darpa's fits, bit for bit.
        onehot = jax_routing(m, sp)
        fs = _factors(d_at.dims, seed=0)
        oh, oh_s, oh_c = _counted(
            m, "dist darpa cp_als (1 rank, one-hot routing)",
            lambda: m["cpals"].cp_als(d_at, RANK, n_iters=3, tol=0.0,
                                      factors=fs, plan=onehot,
                                      gram_fn=gram),
            als_kernels(m, onehot))
        if oh.fits != darpa["onehot_run"]["fits"]:
            _fail(f"dist darpa cp_als (1 rank, one-hot routing): fits "
                  f"{oh.fits} against phase_darpa's "
                  f"{darpa['onehot_run']['fits']}")
        oh_apr = run_cp_apr(m, d_at, onehot, 2,
                            "dist darpa cp_apr (1 rank, one-hot routing)")
        if (oh_apr["log_likelihoods"] != aref["log_likelihoods"]
                or oh_apr["kkt_violations"] != aref["kkt_violations"]):
            _fail("dist darpa cp_apr (1 rank, one-hot routing) differs from "
                  "phase_darpa_apr's")
        print(f"chip_smoke: dist darpa cp_als (1 rank, one-hot routing): "
              f"fits {oh.fits} in {oh_s:.3f} s; launches "
              f"{oh_c['launches']}")
        c_als = run_dist_cp_als(m, c_at, 10,
                                "dist chicago cp_als (1 rank, nccl)")
        c_diff = max(abs(a - b) for a, b in
                     zip(c_als["fits"], chicago["run"]["fits"]))
        if c_diff > DIST_FIT_TOL:
            _fail(f"dist chicago cp_als: fits {c_als['fits']} against "
                  f"phase_chicago's {chicago['run']['fits']}")
        tuning = dist_tuning(m, c_at)
    finally:
        dist.destroy_process_group()
    one_rank_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    # One slice at a time.
    d_res, c_res = darpa_apr["run"]["res"], chicago_apr["run"]["res"]
    d_fs = darpa["run"]["res"].factors
    d_view = m["views"].get_view(d_at, 2)
    d_pi = m["ops"].pi_rows(d_at.meta.enc, d_view.words, d_res.factors, 2)
    slices = {"darpa_mode2": check_shard_slices(
        m, d_at, 2, d_fs, d_res.factors[2] * d_res.lam[None, :],
        "dist darpa mode 2 (pre)", pi=d_pi)}
    del d_pi, d_view
    c_fs = chicago["run"]["res"].factors
    for mode in (0, 1):
        slices[f"chicago_mode{mode}"] = check_shard_slices(
            m, c_at, mode, c_fs, c_res.factors[mode] * c_res.lam[None, :],
            f"dist chicago mode {mode} (otf)", phi_factors=c_res.factors)
    slices_s = time.perf_counter() - t0
    ranks = dist_ranks(m, darpa, als["fits"])
    out = {
        "darpa_1_rank": {
            "fits": als["fits"], "seconds": als["seconds"],
            "traversals": als["traversals"], "launches": als["launches"],
            "bitwise_phase_darpa": True,
            "sweep_ms": sorted(sharded_ms)[len(sharded_ms) // 2],
            "single_sweep_ms": sorted(single_ms)[len(single_ms) // 2],
            "sweep_ms_all": sharded_ms, "single_sweep_ms_all": single_ms,
            "collective_ms": collective_ms,
            "cp_apr": _apr_detail(apr), "cp_apr_bitwise": True,
            "onehot_seconds": oh_s, "onehot_launches": oh_c["launches"],
            "onehot_cp_apr": _apr_detail(oh_apr)},
        "chicago_1_rank": {
            "fits": c_als["fits"], "seconds": c_als["seconds"],
            "traversals": c_als["traversals"],
            "launches": c_als["launches"], "max_fit_diff": c_diff},
        "tuning": tuning, "slices": slices, "two_ranks": ranks,
        "runs": [{"launches": r["launches"], "elements": r["elements"]}
                 for r in (als, apr, oh_c, oh_apr, c_als, *ranks["ranks"])]}
    out["seconds"] = time.perf_counter() - t_start
    out.update(nccl_init_s=init_s, one_rank_s=one_rank_s,
               slices_s=slices_s)
    print(f"chip_smoke: dist: one-rank DARPA sweep "
          f"{out['darpa_1_rank']['sweep_ms']:.2f} ms against "
          f"{out['darpa_1_rank']['single_sweep_ms']:.2f} ms single-device "
          f"(collectives, ms: {collective_ms}); NCCL start {init_s:.2f} s, "
          f"one-rank runs {one_rank_s:.1f} s, slices {slices_s:.1f} s, two "
          f"ranks {ranks['wall_s']:.1f} s; phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The paper's format comparison (Fig. 9, Fig. 12) and the examples
# ---------------------------------------------------------------------------

HICOO_BLOCK_BITS = 7     # the block size of bench_storage.py and of
                         # bench_format_generation.py
FORMAT_AGREE = 1e-4      # max|out - ALTO| / max|ALTO| for every format
E2E_CUT = 5              # the e2e example's first checkpoint, where it is cut


def _rel_to_max(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    return float((got - ref).abs().max()) / float(ref.abs().max())


def format_comparison(m, label, x, at, plans, build_s) -> dict:
    """All-modes MTTKRP, build seconds and storage of one tensor in COO
    (`core.mttkrp.mttkrp_coo`), HiCOO (7-bit blocks), CSF-ALL (one tree
    per mode) and ALTO under each of ``plans`` (`plan.execute_mttkrp`:
    the hand-written kernels), at rank `RANK` on random factors. The
    baselines are the JAX package's formulations in plain PyTorch, not
    SPLATT's or HiCOO's own codes. Every format's output of every mode is
    held within `FORMAT_AGREE` of ALTO's under the first plan (the
    baselines' scatters in index order), and every other ALTO plan's
    equal to it bit for bit. ms: CUDA events, median of 10 after 2
    warm-ups. The ALTO runs are counted (``run``)."""
    base, b = m["baselines"], m["build"]
    N = x.ndim
    fs = _factors(x.dims, seed=7)
    t0 = time.perf_counter()
    h = base.build_hicoo(x, block_bits=HICOO_BLOCK_BITS, device=DEVICE)
    _sync()
    hicoo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csf = base.CsfAll(x, device=DEVICE)
    _sync()
    csf_s = time.perf_counter() - t0
    coords = torch.from_numpy(x.coords).to(DEVICE)
    values = torch.from_numpy(x.values).to(DEVICE)
    fns = {"coo": lambda n: m["mttkrp"].mttkrp_coo(coords, values, fs, n),
           "hicoo": lambda n: base.mttkrp_hicoo(h, fs, n),
           "csf_all": lambda n: csf.mttkrp(fs, n)}
    views = {k: m["plan"].build_views(at, p) for k, p in plans.items()}
    for k, p in plans.items():
        fns[k] = (lambda n, p=p, v=views[k]:
                  m["plan"].execute_mttkrp(p, at, v, fs, n))
    alto = next(iter(plans))
    _sync()
    b.reset_counts()
    ref = [fns[alto](n) for n in range(N)]
    agree = {}
    for k in fns:
        if k in plans:
            for n in range(N):
                _check_equal(f"{label} {k} mode {n} vs {alto}",
                             fns[k](n), ref[n])
            continue
        with _index_order():
            agree[k] = [_rel_to_max(fns[k](n), ref[n]) for n in range(N)]
        if not all(e < FORMAT_AGREE for e in agree[k]):
            _fail(f"{label} {k}: max|out - alto| / max|alto| per mode "
                  f"{agree[k]}, beyond {FORMAT_AGREE}")
    del ref
    per_mode = {k: [_ms(m, fn, n) for n in range(N)] for k, fn in fns.items()}
    all_modes = {k: _ms(m, lambda fn=fn: [fn(n) for n in range(N)])
                 for k, fn in fns.items()}
    _sync()
    counts = b.counts()
    if any(counts["plain_on_cuda"].values()):
        _fail(f"{label} formats: plain versions ran on CUDA tensors: "
              f"{counts['plain_on_cuda']}")
    for k, p in plans.items():
        for kern in als_kernels(m, p):
            if counts["launches"][kern] == 0:
                _fail(f"{label} formats: {k}'s kernel {kern} never launched")
    enc = at.meta.enc
    coo_b = x.nnz * (enc.storage_bits_coo(32) // 8 + x.values.itemsize)
    storage = {"coo": coo_b, "alto": at.storage_bytes(),
               "alto_resident": m["plan"].resident_bytes(at, views[alto]),
               "hicoo": h.storage_bytes(), "csf_all": csf.storage_bytes()}
    out = {
        "all_modes_ms": all_modes, "per_mode_ms": per_mode,
        "speedup_over_coo": {k: all_modes["coo"] / v
                             for k, v in all_modes.items()},
        "agreement": agree,
        "build_s": {"alto_build_device": build_s, "hicoo": hicoo_s,
                    "csf_all": csf_s},
        "storage_bytes": storage,
        "storage_over_coo": {k: v / coo_b for k, v in storage.items()},
        "hicoo_blocks": h.n_blocks,
        "csf_level_nodes": [[len(f) for f in t.fids] for t in csf.trees],
        "traversals": {k: p.traversals() for k, p in plans.items()},
        "run": {"launches": counts["launches"],
                "elements": counts["elements"]}}
    print(f"chip_smoke: formats {label}: all-modes MTTKRP ms {all_modes}; "
          f"speedup over COO {out['speedup_over_coo']}; per-mode ms "
          f"{per_mode}; max|out - alto| / max|alto| {agree}; build s "
          f"{out['build_s']}; storage bytes {storage}, over COO "
          f"{out['storage_over_coo']}")
    return out


def _example(name: str):
    """The example ``examples/<name>.py`` imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(m, label, mod, argv, expect) -> tuple:
    """``mod.main(argv)`` counted; ``expect(result)`` names the kernels it
    must have launched."""
    b = m["build"]
    _sync()
    b.reset_counts()
    t0 = time.perf_counter()
    try:
        res = mod.main(argv)
    except Exception as e:          # an example's failure fails the script
        _fail(f"example {label}: {e!r}")
    _sync()
    seconds = time.perf_counter() - t0
    counts = b.counts()
    for k in expect(res):
        if counts["launches"][k] == 0:
            _fail(f"example {label}: kernel {k} was never launched")
    if any(counts["plain_on_cuda"].values()):
        _fail(f"example {label}: plain versions ran on CUDA tensors: "
              f"{counts['plain_on_cuda']}")
    return res, {"seconds": seconds, "launches": counts["launches"],
                 "elements": counts["elements"]}


def run_examples(m) -> dict:
    """The three single-process CPD examples at their default sizes on the
    card, in this process: quickstart, the CP-APR anomaly example (its
    closing assert included) and the end-to-end example, cut after its
    first checkpoint (``--iters`` `E2E_CUT`) and resumed to its default
    30 iterations from that checkpoint. The resumed run's fits and
    factors must equal, bit for bit, the chain of the same
    ``cp_als(factors=)`` calls run here without a checkpoint."""
    runs = {}
    qs = _example("torch_quickstart")
    res, runs["quickstart"] = _run_example(
        m, "torch_quickstart", qs, [], lambda r: als_kernels(m, r.plan))
    if not all(math.isfinite(f) for f in res.fits):
        _fail(f"example torch_quickstart: fits {res.fits}")
    runs["quickstart"]["fits"] = res.fits
    anomaly = _example("torch_cp_apr_anomaly")
    res, runs["cp_apr_anomaly"] = _run_example(
        m, "torch_cp_apr_anomaly", anomaly, [],
        lambda r: apr_kernels(m, r.plan))
    runs["cp_apr_anomaly"]["log_likelihoods"] = res.log_likelihoods
    e2e = _example("torch_decompose_e2e")
    ckpt = ROOT / "build" / "chip_smoke_e2e"
    shutil.rmtree(ckpt, ignore_errors=True)

    def e2e_kernels(r):
        return als_kernels(m, m["plan"].plan_for(r["at"], RANK))
    args = ["--ckpt-dir", str(ckpt)]
    cut, runs["e2e_cut"] = _run_example(
        m, "torch_decompose_e2e (cut)", e2e,
        args + ["--iters", str(E2E_CUT)], e2e_kernels)
    got, runs["e2e_resumed"] = _run_example(
        m, "torch_decompose_e2e (resumed)", e2e, args, e2e_kernels)
    shutil.rmtree(ckpt, ignore_errors=True)
    if cut["start"] != 0 or got["start"] != E2E_CUT:
        _fail(f"example torch_decompose_e2e: started at {cut['start']}, "
              f"resumed at {got['start']}, expected 0 and {E2E_CUT}")
    factors, fits = None, []
    for _ in range(len(got["fits"]) // e2e.CHUNK):
        r = m["cpals"].cp_als(got["at"], RANK, n_iters=e2e.CHUNK, tol=0,
                              seed=0, factors=factors)
        factors = r.factors
        fits += r.fits
    if got["fits"] != fits or len(fits) != 30:
        _fail(f"example torch_decompose_e2e: resumed fits {got['fits']} "
              f"against the uninterrupted chain's {fits}")
    for n, (a, c) in enumerate(zip(got["factors"], factors)):
        _check_equal(f"example torch_decompose_e2e factor {n} after the "
                     f"resume", a, c)
    runs["e2e_resumed"]["fits"] = got["fits"]
    print(f"chip_smoke: examples: "
          f"{ {k: round(v['seconds'], 3) for k, v in runs.items()} } s; "
          f"the e2e run resumed at iteration {E2E_CUT} equals the "
          f"uninterrupted chain bit for bit (fits, factors)")
    return runs


def phase_formats(m, chicago, darpa) -> dict:
    """The paper's Fig. 9 and Fig. 12 on the card (`format_comparison`):
    Chicago under its static plan (K3 on mode 0, K1 on 1-3), DARPA under
    the port's plan (K1) and the JAX package's routing (K2 + the split +
    the fix-up); then the examples (`run_examples`)."""
    t0 = time.perf_counter()
    out = {"chicago": format_comparison(
               m, "chicago", chicago["x"], chicago["at"],
               {"alto": chicago["plan"]}, chicago["build_s"]),
           "darpa": format_comparison(
               m, "darpa", darpa["x"], darpa["at"],
               {"alto": darpa["plan"],
                "alto_jax_routing": jax_routing(m, darpa["plan"])},
               darpa["build_s"])}
    formats_s = time.perf_counter() - t0
    examples = run_examples(m)
    out.update(examples=examples, formats_s=formats_s,
               seconds=time.perf_counter() - t0,
               runs=[out["chicago"]["run"], out["darpa"]["run"],
                     *examples.values()])
    print(f"chip_smoke: phase_formats {out['seconds']:.1f} s (formats "
          f"{formats_s:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# Real-size kernel checks and timings
# ---------------------------------------------------------------------------

CSRC = "src/repro_torch/kernels/csrc/"
JAX_KERNELS = "src/repro/kernels/"
KERNEL_SOURCES = {   # name -> (port source, TPU kernel it replaces)
    "carry_runs": ("alto_scan.cuh", "mttkrp_oriented.py:358"),
    "carry_fixup": ("carry_fixup.cuh", "mttkrp_oriented.py:254"),
    # not a Pallas kernel: the JAX segment_merge is a jnp scatter-add
    "segment_split": ("segment_split.cuh", "ops.py:171"),
    "oriented_partials": ("alto_scan.cuh", "mttkrp_oriented.py:132"),
    "recursive_partials": ("alto_scan.cuh", "mttkrp.py:75"),
    "delinearize": ("delinearize.cu", "delinearize.py:37"),
    "phi_carry_runs": ("phi_oriented.cu", "mttkrp_oriented.py:437"),
    "phi_oriented_partials": ("phi_scan.cuh", "mttkrp_oriented.py:204"),
    "phi_partials": ("cpapr_phi.cu", "cpapr_phi.py:57"),
    "carry_chunk": ("mttkrp_oriented.cu", "mttkrp_oriented.py:541"),
    "phi_carry_chunk": ("phi_oriented.cu", "mttkrp_oriented.py:637"),
    # not a Pallas kernel: the JAX Π build is K4 and jnp gathers
    "pi_rows": ("delinearize.cu", "src/repro/core/cpapr.py:104"),
}


def _entry(name, launches, err, ms, plain_ms, nbytes, nops, library_ms,
           shape, op=None, op_ms=None, op_plain_ms=None,
           op_bytes=None) -> dict:
    """One element of the ``kernels`` line. ``launches`` holds the main
    path's launch counts and, under "elements", the stream lengths they
    were launched on, summed."""
    bound, by = _bound(nbytes, nops)
    source, replaces = KERNEL_SOURCES[name]
    e = {"name": name, "route": "cuda", "source": CSRC + source,
         "replaces": (replaces if replaces.startswith("src/")
                      else JAX_KERNELS + replaces),
         "launches": launches[name],
         "elements": launches["elements"][name], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
         "library_ms": library_ms, "shape": shape}
    if op is not None:          # the op the main path calls around it
        e.update(op=op, op_ms=op_ms, op_plain_ms=op_plain_ms,
                 op_bound_ms=_bound(op_bytes, nops)[0])
    return e


def _stream_bytes(M, W):
    return M * (4 + 4 * W + 4)


def _distinct(rows) -> int:
    """Distinct target rows of a stream: the rows of B a Φ kernel
    gathers."""
    return int(torch.unique(rows).numel())


def _factor_bytes(meta, mode, R):
    return sum(I for n, I in enumerate(meta.dims) if n != mode) * R * 4


def time_oriented(m, view, factors, mp, launches) -> list[dict]:
    ops, kori = m["ops"], m["kori"]
    meta, mode = view.meta, view.mode
    N, W, R = meta.enc.ndim, meta.enc.n_words, RANK
    bm, rb, th = mp.block_m, mp.r_block, mp.threads
    errs = check_oriented_kernels(m, view, factors, bm, rb, th,
                                  f"mode {mode} real size")
    rows, words, values, _ = ops.pad_sorted_stream(view.rows, view.words,
                                                   view.values, bm)
    M = rows.shape[0]
    nb = M // bm
    I_n = meta.dims[mode]
    args = (meta.enc, mode, rows, words, values, factors)
    stream = _stream_bytes(M, W)
    fac = _factor_bytes(meta, mode, R)
    out_b = I_n * R * 4
    carries = nb * 2 * (4 + 4 * R)
    krp_ops = M * R * N                       # N-2 products, scale, add
    out, crow, cval = kori.carry_runs(*args, bm, rb, th)
    present = crow[crow >= 0]
    fix_rows = int(torch.unique(present).numel())
    keep_rows = present.long()
    keep_vals = cval.reshape(-1, R)[(crow >= 0).reshape(-1)]
    shape = f"mode {mode} of {meta.dims}, M={M}, R={R}, block_m={bm}"

    def k1_plain():
        o, r, v = kori.carry_runs_plain(*args, bm)
        return kori.carry_fixup_plain(r, v, o)

    def k2_plain():
        part = kori.oriented_partials_plain(*args, bm)
        o, r, v = kori.split_block_runs(part, rows, I_n)
        return kori.carry_fixup_plain(r, v, o)

    part_b = nb * bm * R * 4
    part = kori.oriented_partials(*args, bm, rb, th)
    rows_b = rows.reshape(nb, bm)
    n_runs = nb + int((rows_b[:, 1:] != rows_b[:, :-1]).sum())
    split_b = M * 4 + n_runs * R * 4 + out_b + carries
    # JAX's segment_merge in one call: every slot added to its run's row
    # (unused slots, zeros, to row 0) into zeros.
    seg_rows = torch.zeros_like(rows_b).scatter_(
        1, kori.run_rank_segments(rows_b), rows_b).reshape(-1).long()
    flat = part.reshape(-1, R)

    def merge_plain():
        o, r, v = kori.split_block_runs(part, rows, I_n)
        return kori.carry_fixup_plain(r, v, o)
    split = _entry(
        "segment_split", launches, errs["segment_split"],
        _ms(m, kori.segment_split, part, rows, I_n, th),
        _ms(m, kori.segment_split_plain, part, rows, I_n, iters=3),
        split_b, 0, _ms(m, lambda: torch.zeros(
            (I_n, R), device=rows.device).index_add_(0, seg_rows, flat)),
        shape + f", {n_runs} runs", "ops.segment_merge",
        _ms(m, ops.segment_merge, part, rows, I_n, th),
        _ms(m, merge_plain, iters=3),
        split_b + fix_rows * R * 4)
    split["note"] = ("not a Pallas kernel: the JAX segment_merge "
                     "(ops.py:171) is a jnp scatter-add")
    del part, seg_rows, flat
    return [
        split,
        _entry("carry_runs", launches, errs["carry_runs"],
               _ms(m, kori.carry_runs, *args, bm, rb, th),
               _ms(m, kori.carry_runs_plain, *args, bm, iters=3),
               stream + fac + out_b + carries, krp_ops, None, shape,
               "ops.mttkrp_oriented_carry",
               _ms(m, ops.mttkrp_oriented_carry, view, factors, bm, rb, th),
               _ms(m, k1_plain, iters=3), stream + fac + out_b),
        _entry("carry_fixup", launches, errs["carry_fixup"],
               _ms(m, kori.carry_fixup, crow, cval, out.clone(), None, th),
               _ms(m, kori.carry_fixup_plain, crow, cval, out.clone(),
                   iters=3),
               carries + fix_rows * R * 4, present.numel() * R,
               _ms(m, lambda: out.clone().index_add_(0, keep_rows,
                                                     keep_vals)), shape),
        _entry("oriented_partials", launches, errs["oriented_partials"],
               _ms(m, kori.oriented_partials, *args, bm, rb, th),
               _ms(m, kori.oriented_partials_plain, *args, bm, iters=3),
               stream + fac + part_b, krp_ops, None, shape,
               "ops.mttkrp_oriented",
               _ms(m, ops.mttkrp_oriented, view, factors, bm, rb, th),
               _ms(m, k2_plain, iters=3), stream + fac + part_b + split_b)]


def time_recursive(m, at, factors, mp, launches) -> dict:
    ops, k3 = m["ops"], m["k3"]
    meta, mode = at.meta, mp.mode
    W, N, R = meta.enc.n_words, meta.enc.ndim, RANK
    L, T = meta.n_partitions, meta.temp_rows[mode]
    Mp = at.words.shape[0]
    err = check_recursive_kernel(m, at, factors, mode, mp.r_block,
                                 mp.threads, f"mode {mode} real size",
                                 windows=(16,))
    args = (meta.enc, mode, T, at.words, at.values, at.part_start, factors)
    stream = Mp * (4 * W + 4) + L * N * 4
    fac = _factor_bytes(meta, mode, R)
    temp_b = L * T * R * 4

    def plain_op():
        return ops.pull_reduction(k3.recursive_partials_plain(*args),
                                  at.part_start[:, mode], meta.dims[mode])

    e = _entry(
        "recursive_partials", launches, err,
        _ms(m, k3.recursive_partials, *args, mp.r_block, mp.threads),
        _ms(m, k3.recursive_partials_plain, *args, iters=3),
        stream + fac + temp_b, Mp * R * N, None,
        f"mode {mode} of {meta.dims}, Mp={Mp}, L={L}, T={T}, R={R}",
        "ops.mttkrp",
        _ms(m, ops.mttkrp, at, factors, mode, mp.r_block, mp.threads),
        _ms(m, plain_op, iters=3),
        stream + fac + 2 * temp_b + meta.dims[mode] * R * 4)
    e["window_rows"] = m["common"].window_rows(
        T, mp.r_block, m["common"].smem_limit(at.words.device), False)
    return e


def time_phi_recursive(m, at, res, mp, launches) -> dict:
    """K7 on a recursive mode under ALTO-OTF, from a CP-APR run's final
    state."""
    ops, k7 = m["ops"], m["k7"]
    meta, mode = at.meta, mp.mode
    W, N, R = meta.enc.n_words, meta.enc.ndim, RANK
    L, T = meta.n_partitions, meta.temp_rows[mode]
    Mp = at.words.shape[0]
    fs = res.factors
    B = fs[mode] * res.lam[None, :]
    errs = check_phi_recursive_kernel(m, at, B, {"factors": fs}, mode,
                                      mp.threads, f"phi mode {mode} real size",
                                      windows=(16,))
    args = (meta.enc, mode, T, 1e-10, at.words, at.values, at.part_start, B)
    stream = Mp * (4 * W + 4) + L * N * 4
    fac = _factor_bytes(meta, mode, R)
    out_b = meta.dims[mode] * R * 4
    b_bytes = _distinct(at.coords()[:, mode]) * R * 4    # rows gathered
    temp_b = L * T * R * 4
    nops = Mp * R * (N + 2)      # krp, dot (mul + add), term, run sum

    def plain_op():
        return ops.pull_reduction(k7.phi_partials_plain(*args, factors=fs),
                                  at.part_start[:, mode], meta.dims[mode])

    e = _entry(
        "phi_partials", launches, errs["phi_partials"],
        _ms(m, k7.phi_partials, *args, fs, None, None, mp.threads),
        _ms(m, k7.phi_partials_plain, *args, fs, iters=3),
        stream + b_bytes + fac + temp_b, nops, None,
        f"mode {mode} of {meta.dims}, Mp={Mp}, L={L}, T={T}, R={R}, otf",
        "ops.cpapr_phi",
        _ms(m, ops.cpapr_phi, at, B, mode, fs, None, 1e-10, mp.threads),
        _ms(m, plain_op, iters=3),
        stream + b_bytes + fac + 2 * temp_b + out_b)
    temp = k7.phi_partials(*args, fs, None, None, mp.threads)
    start = at.part_start[:, mode]
    e["pull_ms"] = _ms(m, ops.pull_reduction, temp, start, meta.dims[mode],
                       mp.threads, m["views"].get_pull_order(at, mode))
    e["pull_dense_ms"] = _ms(m, ops.pull_reduction, temp, start,
                             meta.dims[mode], mp.threads)
    e["window_rows"] = m["common"].window_rows(
        T, R, m["common"].smem_limit(temp.device), True)
    return e


def time_phi_oriented(m, view, res, mp, launches) -> list[dict]:
    """K5 and K6 on an oriented mode under ALTO-PRE, from a CP-APR run's
    final state."""
    ops, kori = m["ops"], m["kori"]
    meta, mode = view.meta, view.mode
    W, R, bm, th = meta.enc.n_words, RANK, mp.block_m, mp.threads
    I_n = meta.dims[mode]
    B = res.factors[mode] * res.lam[None, :]
    pi = m["ops"].pi_rows(meta.enc, view.words, res.factors, mode)
    errs = check_phi_oriented_kernels(m, view, B, {"pi": pi}, bm, th,
                                      f"phi mode {mode} real size")
    rows, words, values, pi_p = ops.pad_sorted_stream(
        view.rows, view.words, view.values, bm, pi=pi)
    M = rows.shape[0]
    nb = M // bm
    args = (meta.enc, mode, 1e-10, rows, words, values, B, None, pi_p, bm)
    stream = M * (4 + 4)         # rows, values: PRE decodes no words
    pi_b = M * R * 4
    b_bytes = _distinct(view.rows) * R * 4          # B rows gathered
    out_b = I_n * R * 4
    carries = nb * 2 * (4 + 4 * R)
    part_b = nb * bm * R * 4
    nops = M * R * 4              # dot (mul + add), term, run sum
    shape = (f"mode {mode} of {meta.dims}, M={M}, R={R}, block_m={bm}, "
             f"pre")

    def k5_plain():
        o, r, v = kori.phi_carry_runs_plain(*args)
        return kori.carry_fixup_plain(r, v, o)

    def k6_plain():
        part = kori.phi_oriented_partials_plain(*args)
        o, r, v = kori.split_block_runs(part, rows, I_n)
        return kori.carry_fixup_plain(r, v, o)

    entries = [
        _entry("phi_carry_runs", launches, errs["phi_carry_runs"],
               _ms(m, kori.phi_carry_runs, *args, None, th),
               _ms(m, kori.phi_carry_runs_plain, *args, iters=3),
               stream + pi_b + b_bytes + out_b + carries, nops, None,
               shape, "ops.cpapr_phi_oriented_carry",
               _ms(m, ops.cpapr_phi_oriented_carry, view, B, None, pi,
                   1e-10, bm, th),
               _ms(m, k5_plain, iters=3), stream + pi_b + b_bytes + out_b),
        _entry("phi_oriented_partials", launches,
               errs["phi_oriented_partials"],
               _ms(m, kori.phi_oriented_partials, *args, None, th),
               _ms(m, kori.phi_oriented_partials_plain, *args, iters=3),
               stream + pi_b + b_bytes + part_b, nops, None, shape,
               "ops.cpapr_phi_oriented",
               _ms(m, ops.cpapr_phi_oriented, view, B, None, pi, 1e-10, bm,
                   th),
               _ms(m, k6_plain, iters=3),
               stream + pi_b + b_bytes + out_b + 2 * part_b + M * 4)]
    return entries


def time_delinearize(m, at, chicago_at, chunk_m, launches) -> dict:
    """K4 on the DARPA tensor's whole ALTO stream (under each decode
    route too), on one chunk's ragged length and on the Chicago stream;
    equal to its plain version there and at lengths 1, 1023 and 1025,
    under every route."""
    k4, ops = m["k4"], m["ops"]
    enc = at.meta.enc
    check_delinearize(m, enc, at.words, "darpa",
                      lengths=(None, chunk_m, 1, 1023, 1025))
    check_delinearize(m, chicago_at.meta.enc, chicago_at.words, "chicago")
    words = at.words
    M, W, N = words.shape[0], enc.n_words, enc.ndim

    def nbytes(enc, M):
        return M * enc.n_words * 4 + M * enc.ndim * 4
    chunk = words[:chunk_m]
    cw = chicago_at.words
    cenc = chicago_at.meta.enc
    e = _entry(
        "delinearize", launches, 0.0, _ms(m, k4.delinearize, enc, words),
        _ms(m, k4.delinearize_plain, enc, words, iters=3), nbytes(enc, M),
        M * len(enc.runs) * 3, None, f"{enc.dims}, M={M}, W={W}",
        "ops.delinearize", _ms(m, ops.delinearize, enc, words),
        _ms(m, k4.delinearize_plain, enc, words, iters=3), nbytes(enc, M))
    limit = m["common"].smem_limit(words.device)
    e["route"] = k4.choose_route(enc, k4.TILE, limit)
    e["route_ms"] = {r: _ms(m, k4.delinearize, enc, words, r)
                     for r in k4.ROUTES}
    e["chunk"] = {"M": chunk_m, "ms": _ms(m, ops.delinearize, enc, chunk),
                  "bound_ms": _bound(nbytes(enc, chunk_m), 0)[0]}
    e["chicago"] = {"M": cw.shape[0],
                    "route": k4.choose_route(cenc, k4.TILE, limit),
                    "ms": _ms(m, ops.delinearize, cenc, cw),
                    "route_ms": {r: _ms(m, k4.delinearize, cenc, cw, r)
                                 for r in k4.ROUTES},
                    "bound_ms": _bound(nbytes(cenc, cw.shape[0]), 0)[0]}
    return e


def _misaligned(A):
    """A copy of ``A`` 4 bytes past a 16-byte boundary, contiguous."""
    flat = A.new_empty(A.numel() + 1)
    B = flat[1:].view(A.shape)
    B.copy_(A)
    return B


def time_pi_rows(m, views, res, launches) -> dict:
    """`pi_rows` on the DARPA view words of modes 0 and 2 (Π of a 23.8 M-
    row factor and a 22,476-row one, and of the two 22,476-row factors),
    from a CP-APR run's final state: equal to its plain version there,
    then timed beside the K4 + `krp_rows` chain it replaces
    (``library_ms``), and on its one-float column path (``one_float_ms``:
    the smaller factor it reads moved off a 16-byte boundary, the same
    bits). The entry is mode 2's; ``mode0`` holds mode 0's."""
    k4, ops, mtt = m["k4"], m["ops"], m["mttkrp"]
    fs = res.factors
    out = {}
    for mode in (0, 2):
        view = views[mode]
        enc, words = view.meta.enc, view.words
        check_pi_rows(m, enc, words, fs, f"darpa view {mode}", (mode,))
        small = min((n for n in range(enc.ndim) if n != mode),
                    key=lambda n: fs[n].shape[0])
        fs1 = list(fs)
        fs1[small] = _misaligned(fs[small])
        _check_equal(f"darpa view {mode} pi_rows (one float)",
                     ops.pi_rows(enc, words, fs1, mode),
                     ops.pi_rows(enc, words, fs, mode))
        M, W, N = words.shape[0], enc.n_words, enc.ndim
        coords = ops.delinearize(enc, words)
        rows_b = sum(_distinct(coords[:, n]) for n in range(N)
                     if n != mode) * RANK * 4
        del coords
        nbytes = M * W * 4 + M * RANK * 4 + rows_b
        out[mode] = dict(
            ms=_ms(m, ops.pi_rows, enc, words, fs, mode),
            one_float_ms=_ms(m, ops.pi_rows, enc, words, fs1, mode),
            plain_ms=_ms(m, k4.pi_rows_plain, enc, words, fs, mode, iters=3),
            library_ms=_ms(m, lambda: mtt.krp_rows(
                ops.delinearize(enc, words), fs, mode).contiguous()),
            nbytes=nbytes, nops=M * RANK * (N - 2),
            shape=f"view {mode} of {enc.dims}, M={M}, W={W}, R={RANK}")
    o = out[2]
    e = _entry("pi_rows", launches, 0.0, o["ms"], o["plain_ms"],
               o["nbytes"], o["nops"], o["library_ms"], o["shape"])
    e["one_float_ms"] = o["one_float_ms"]
    z = out[0]
    e["mode0"] = {"shape": z["shape"], "ms": z["ms"],
                  "one_float_ms": z["one_float_ms"],
                  "plain_ms": z["plain_ms"], "library_ms": z["library_ms"],
                  "bound_ms": _bound(z["nbytes"], z["nops"])[0]}
    return e


def time_chunks(m, hs, sp, mp, als_res, apr_res, launches) -> list[dict]:
    """K8 and K9 (ALTO-PRE) on the first full chunk of DARPA mode 2 in
    the middle of a stream (a carry in, none out is final), from the
    streamed runs' final states; each against its plain version."""
    kori = m["kori"]
    enc, mode = hs.meta.enc, hs.mode
    W, N, R, bm, th = enc.n_words, enc.ndim, RANK, mp.block_m, mp.threads
    C = sp.chunk_m
    rows, words, values = (t.to(DEVICE) for t in hs.chunk(0, C))
    I_n = enc.dims[mode]
    crow = rows[:1].clone()          # a carry-in joining the first run
    cval = torch.ones((1, R), device=DEVICE)
    # The rows of a chunk hold zeros in out until the chunk stores them;
    # each kernel gets its own output.
    out = torch.zeros((I_n, R), device=DEVICE)
    fs = als_res.factors
    k8_args = (enc, mode, rows, words, values, fs)
    got = kori.carry_chunk(*k8_args, out.clone(), crow, cval, bm,
                           mp.r_block, th, final=False)
    with _index_order():
        want = kori.carry_chunk_plain(*k8_args, out.clone(), crow, cval, bm,
                                      False)
    _check_equal("darpa chunk K8 carry_row", got[1], want[1])
    k8_err = max(_check_close("darpa chunk K8 out", got[0], want[0]),
                 _check_close("darpa chunk K8 carry_val", got[2], want[2]))
    d = _distinct(rows) * R * 4                 # out (and B) rows touched
    shape = f"first chunk of mode {mode} of {enc.dims}, C={C}, R={R}, " \
            f"block_m={bm}"
    entries = [_entry(
        "carry_chunk", launches, k8_err,
        _ms(m, kori.carry_chunk, *k8_args, out, crow, cval, bm, mp.r_block,
            th, False),
        _ms(m, kori.carry_chunk_plain, *k8_args, out.clone(), crow, cval,
            bm, False, iters=3),
        _stream_bytes(C, W) + _factor_bytes(hs.meta, mode, R) + d,
        C * R * N, None, shape)]

    pfs = apr_res.factors
    B = pfs[mode] * apr_res.lam[None, :]
    pi = m["ops"].pi_rows(enc, words, pfs, mode)
    k9_args = (enc, mode, 1e-10, rows, words, values, B)
    out = torch.zeros((I_n, R), device=DEVICE)
    got = kori.phi_carry_chunk(*k9_args, out.clone(), crow, cval, pi=pi,
                               block_m=bm, threads=th, final=False)
    with _index_order():
        want = kori.phi_carry_chunk_plain(*k9_args, out.clone(), crow, cval,
                                          pi=pi, block_m=bm, final=False)
    _check_equal("darpa chunk K9 carry_row", got[1], want[1])
    k9_err = max(_check_close("darpa chunk K9 out", got[0], want[0]),
                 _check_close("darpa chunk K9 carry_val", got[2], want[2]))
    entries.append(_entry(
        "phi_carry_chunk", launches, k9_err,
        _ms(m, kori.phi_carry_chunk, *k9_args, out, crow, cval, None, pi,
            bm, th, False),
        _ms(m, kori.phi_carry_chunk_plain, *k9_args, out.clone(), crow,
            cval, None, pi, bm, False, iters=3),
        C * 8 + C * R * 4 + 2 * d, C * R * 4, None, shape + ", pre"))
    return entries


def carry_split(m, at, p, fs, modes, label: str, apr_res=None) -> dict:
    """ms of K1's runs pass, its fix-up and the whole op on each of
    ``modes`` at the plan's tiles; with a CP-APR result, also the fix-up of the K5 route
    (ALTO-OTF) on the same modes."""
    ops, kori = m["ops"], m["kori"]
    enc = at.meta.enc
    out = {}
    for n in modes:
        mp = p.modes[n]
        view = m["alto"].oriented_view_device(at, n)
        rows, words, values, _ = ops.pad_sorted_stream(
            view.rows, view.words, view.values, mp.block_m)
        a = (enc, n, rows, words, values, fs, mp.block_m, mp.r_block,
             mp.threads)
        o, crow, cval = kori.carry_runs(*a)
        e = {"M": rows.shape[0], "block_m": mp.block_m, "rows": at.dims[n],
             "pieces": int((crow >= 0).sum()),
             "runs_ms": _ms(m, kori.carry_runs, *a),
             "fixup_ms": _ms(m, kori.carry_fixup, crow, cval, o, None,
                             mp.threads),
             "op_ms": _ms(m, ops.mttkrp_oriented_carry, view, fs,
                          mp.block_m, mp.r_block, mp.threads)}
        if apr_res is not None:
            B = apr_res.factors[n] * apr_res.lam[None, :]
            o, crow, cval = kori.phi_carry_runs(
                enc, n, 1e-10, rows, words, values, B,
                factors=apr_res.factors, block_m=mp.block_m,
                threads=mp.threads)
            e["k5_fixup_ms"] = _ms(m, kori.carry_fixup, crow, cval, o, None,
                                   mp.threads)
        out[f"mode{n}"] = e
    print(f"chip_smoke: {label}: K1 runs pass / fix-up / op, ms: {out}")
    return out


NEW_KERNELS = ("mttkrp_carry_runs_kernel", "carry_fixup_tiles_kernel",
               "segment_split_kernel", "delinearize_tiles_kernel",
               "mttkrp_partials_smem_kernel", "phi_carry_runs_kernel")


def stack_frames(build) -> dict:
    """Stack frame bytes and registers of every function ptxas reported
    (``-v``), by library and mangled name: ``{name: [stack, registers]}``
    (registers None for a device function)."""
    frames = {}
    for lib, log in build.BUILD_LOG.items():
        fn = None
        for line in log.splitlines():
            found = re.search(r"Function properties for (\S+)", line)
            if found:
                fn = f"{lib}:{found.group(1)}"
                continue
            found = re.search(r"(\d+) bytes stack frame", line)
            if found and fn is not None:
                frames[fn] = [int(found.group(1)), None]
                continue
            found = re.search(r"Used (\d+) registers", line)
            if found and fn in frames:
                frames[fn][1] = int(found.group(1))
                fn = None
    return frames


def check_stack_frames(build) -> dict:
    """Every instantiation of the redesigned kernels (the runs pass K1, K2
    and K8 share, the fix-up walk, the split, K4, K3, and the runs pass K5,
    K6 and K9 share) has a 0-byte stack frame (a register array indexed
    at run time would put it on the stack)."""
    frames = stack_frames(build)
    new = {k: v[0] for k, v in frames.items()
           if any(n in k for n in NEW_KERNELS)}
    for n in NEW_KERNELS:
        if not any(n in k for k in new):
            _fail(f"ptxas reported no stack frame for {n}: no build log "
                  f"beside its library (delete build/repro_torch)")
    if any(new.values()):
        _fail(f"stack frames in the redesigned kernels: "
              f"{ {k: v for k, v in new.items() if v} }")
    print(f"chip_smoke: ptxas: {len(new)} instantiations of "
          f"{NEW_KERNELS}, all with a 0-byte stack frame; registers "
          f"{ {k.split(':')[1][-60:]: frames[k][1] for k in new} }")
    return {k: frames[k] for k in new}


def mode_times(m, at, p, views, factors) -> list[float]:
    """ms of one execute_mttkrp per mode, as the sweep calls it."""
    return [_ms(m, m["plan"].execute_mttkrp, p, at, views, factors, n,
                iters=5) for n in range(len(at.dims))]


def _apr_detail(run) -> dict:
    return {k: v for k, v in run.items() if k != "res"}


# ---------------------------------------------------------------------------
# The LM stack (`phase_lm`): models, the ALTO-sorted MoE dispatch, serving
# ---------------------------------------------------------------------------

LM_SEED = 0
LM_SERVE = {"arch": "granite-moe-3b-a800m", "requests": 4, "prompt": 128,
            "tokens": 32}
LM_ARCH_BATCH, LM_ARCH_PROMPT, LM_ARCH_DECODE = 2, 64, 4
LM_CONSISTENCY = 2e-2      # prefill + decode against forward, relative to
                           # max|logits| (tests/test_archs_smoke.py's bound)
LM_CPU_RTOL = 1e-4         # card against CPU per layer, float32, TF32 off
LM_CPU_CHAIN = 1e-3        # the chained two layers (see lm_cpu_parity)
LM_CPU_LAYERS = 2          # depth of the card-against-CPU models
LM_F32_MAX_BYTES = 40e9    # float32 weights the consistency check may hold
# (arch, dtype) whose whole-model decode against forward is recorded, not
# gated: these stacks amplify last-bit differences past the bound (one
# unit in the last place of the weights moves the JAX package's own
# smollm-360m logits by 0.21 at 8 layers and 0.61 at 16, and its own
# decode misses the bound at 16 layers: tools/lm_decode_witness.py;
# tools/torch_lm_conditioning.py for the port). Their layer-by-layer
# check and whole-model prefill stay gated.
LM_CHAOTIC = {("granite-moe-3b-a800m", "float32"), ("smollm-360m", "float32"),
              ("xlstm-1.3b", "bfloat16"), ("zamba2-7b", "bfloat16")}


def _wall(fn):
    """(result, seconds) of ``fn()`` between two synchronizations."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _rel_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


@contextlib.contextmanager
def _recording_moe(m):
    """Record each `moe_ffn` call's (params, input) while the model runs."""
    mod = m["lm_moe"]
    calls, orig = [], mod.moe_ffn

    def rec(cfg, p, x):
        calls.append((p, x))
        return orig(cfg, p, x)
    mod.moe_ffn = rec
    try:
        yield calls
    finally:
        mod.moe_ffn = orig


def lm_dispatch_check(m, cfg, calls) -> dict:
    """On every layer's routing of the prompt: the ALTO sort's order, slots
    and keeps equal the reference dispatch's bit for bit (the reference's
    order: its pairs sorted by (expert, slot)), and the two MoE outputs
    agree within K roundings of their dtype, relative to max|out| (they
    sum a token's K contributions in other orders, each as the JAX package
    does)."""
    moe = m["lm_moe"]
    K, E = cfg.experts_per_token, cfg.n_experts
    worst, dropped = 0.0, 0
    for i, (p, x) in enumerate(calls):
        B, S, _ = x.shape
        top_e = moe.route(cfg, p, x)[2]
        C = moe._capacity(cfg, S)
        slot_a, keep_a, _ = moe.dispatch_slots(cfg, top_e, C, True)
        slot_r, keep_r, _ = moe.dispatch_slots(cfg, top_e, C, False)
        flat_e = top_e.reshape(B, S * K)
        order_a = moe._alto_sort_dispatch(flat_e, E, S)[0]
        order_r = torch.argsort(flat_e * (S * K) + slot_r, dim=-1)
        for name, a, r in (("slot", slot_a, slot_r), ("keep", keep_a, keep_r),
                           ("order", order_a, order_r)):
            if not torch.equal(a, r):
                _fail(f"lm dispatch layer {i}: ALTO and reference {name} "
                      "differ")
        dropped += int((~keep_a).sum())
        out_a, _ = moe.moe_ffn(dataclasses.replace(
            cfg, moe_alto_dispatch=True), p, x)
        out_r, _ = moe.moe_ffn(dataclasses.replace(
            cfg, moe_alto_dispatch=False), p, x)
        rel = _rel_err(out_a, out_r)
        bound = K * torch.finfo(x.dtype).eps / 2
        if not rel <= bound:
            _fail(f"lm dispatch layer {i}: ALTO against reference MoE "
                  f"output {rel} beyond K roundings ({bound})")
        worst = max(worst, rel)
    return {"layers": len(calls), "pairs": len(calls) * B * S * K,
            "dropped_pairs": dropped, "order_slot_keep_equal": True,
            "moe_out_rel_max": worst}


def lm_serve(m) -> tuple:
    """granite-moe-3b-a800m at its published size, bf16, seeded weights:
    4 requests of 128 prompt tokens, 32 greedy tokens each, through the
    launcher's loop (`launch.serve.generate`), twice."""
    M, sv = m["lm_model"], m["lm_serve"]
    cfg = m["lm_configs"].get_config(LM_SERVE["arch"])
    B, P, G = LM_SERVE["requests"], LM_SERVE["prompt"], LM_SERVE["tokens"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    model, init_s = _wall(lambda: M.init_model(cfg, gen, device=DEVICE))
    batch = m["lm_pipeline"].make_batch(cfg, B, P, LM_SEED, 0, device=DEVICE)
    _, first_s = _wall(lambda: sv.generate(cfg, model, batch, 2))
    runs = [sv.generate(cfg, model, batch, G) for _ in range(2)]
    for r in runs:
        if not bool(torch.isfinite(r.logits).all()):
            _fail("lm serve: non-finite logits")
    if not (torch.equal(runs[0].tokens, runs[1].tokens)
            and torch.equal(runs[0].logits, runs[1].logits)):
        _fail("lm serve: two runs differ")
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    with _recording_moe(m) as calls:
        logits_a, _ = M.forward(cfg, model, prompt)
    dispatch = lm_dispatch_check(m, cfg, calls)
    del calls
    logits_r, _ = M.forward(dataclasses.replace(cfg, moe_alto_dispatch=False),
                            model, prompt)
    out = {"arch": cfg.name, "requests": B, "prompt": P, "tokens": G,
           "layers": cfg.n_layers, "params": M.count_params(cfg),
           "weight_bytes": _param_bytes(model), "init_s": init_s,
           "first_call_s": first_s,
           "prefill_ms": [r.prefill_s * 1e3 for r in runs],
           "decode_ms_per_token": [r.decode_s / (G - 1) * 1e3 for r in runs],
           "decode_tokens_per_s": [B * (G - 1) / r.decode_s for r in runs],
           "tokens_per_s": [B * G / (r.prefill_s + r.decode_s)
                            for r in runs],
           "rerun_bitwise": True, "dispatch": dispatch,
           "full_depth_alto_vs_reference_logits_rel":
               _rel_err(logits_a, logits_r),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "first_row": runs[0].tokens[0].tolist()}
    print(f"chip_smoke: lm serve {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}, bf16, {out['weight_bytes'] / 1e9:.2f} GB "
          f"of weights): {B} requests × ({P} + {G}) tokens, prefill "
          f"{out['prefill_ms']} ms, decode {out['decode_ms_per_token']} ms a "
          f"token, {out['tokens_per_s']} tokens/s, peak "
          f"{out['peak_bytes'] / 1e9:.2f} GB; two runs bit for bit; "
          f"dispatch {dispatch}")
    return out, model


def _lm_close(label: str, got, ref, rtol: float) -> float:
    """``got`` (any device) within ``rtol=rtol, atol=rtol·max|ref|`` of
    ``ref``; returns max|got - ref| / max|ref|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=rtol, atol=rtol * scale):
        _fail(f"{label}: max_abs_err {err} beyond rtol={rtol}, "
              f"atol={rtol}·{scale}")
    return err / scale


def lm_cpu_parity(m) -> dict:
    """The first two layers of granite-moe-3b-a800m and smollm-360m at full
    width in float32, on the card and on the CPU with the same weights,
    TF32 off. Each layer runs on the CPU layer's input, and the final norm
    and unembedding on the CPU's last hidden state: each within
    ``rtol=1e-4, atol=1e-4·max|cpu|``. The chained forward's logits are
    held to 1e-3 of max|cpu|: the JAX package's init law takes the heads
    axis as fan-in for the attention projections, so attention logits
    reach ~500 and one float32 rounding moves the two-layer logits by up to
    ~1e-4 on any device (`tools/torch_lm_conditioning.py`). On the card,
    the ALTO and reference dispatches' MoE outputs on each layer's input
    agree within K float32 roundings."""
    M, lc, blk = m["lm_model"], m["lm_configs"], m["lm_blocks"]
    common = m["lm_common"]
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for arch in ("granite-moe-3b-a800m", "smollm-360m"):
            cfg = dataclasses.replace(lc.get_config(arch),
                                      n_layers=LM_CPU_LAYERS,
                                      dtype="float32")
            model_cpu = M.init_model(cfg, torch.Generator().manual_seed(
                LM_SEED), device="cpu")
            model_card = M.Model(cfg)
            model_card.load_state_dict({
                k: v.to(DEVICE) for k, v in model_cpu.state_dict().items()},
                assign=True)
            b_cpu = m["lm_pipeline"].make_batch(cfg, 2, LM_ARCH_PROMPT,
                                                LM_SEED, 0, device="cpu")
            b_cpu.pop("labels")
            b_card = {k: v.to(DEVICE) for k, v in b_cpu.items()}
            x, pos, _ = M._embed_inputs(cfg, model_cpu, b_cpu)
            e = {"layers": cfg.n_layers, "layer_rel": []}
            for i, (bt, pc, pg) in enumerate(zip(
                    M._block_types(cfg), model_cpu.layers,
                    model_card.layers)):
                want, _ = blk.block_apply(cfg, bt, pc, x, positions=pos)
                got, _ = blk.block_apply(cfg, bt, pg, x.to(DEVICE),
                                         positions=pos.to(DEVICE))
                e["layer_rel"].append(_lm_close(
                    f"lm card against CPU {arch} layer {i}", got, want,
                    LM_CPU_RTOL))
                x = want
            heads = [common.unembed(M.unembed_params(cfg, mod), common.rmsnorm(
                mod.final_norm, h, cfg.norm_eps)) for mod, h in (
                (model_cpu, x), (model_card, x.to(DEVICE)))]
            e["head_rel"] = _lm_close(f"lm card against CPU {arch} head",
                                      heads[1], heads[0], LM_CPU_RTOL)
            ref, _ = M.forward(cfg, model_cpu, b_cpu)
            with _recording_moe(m) as calls:
                got, _ = M.forward(cfg, model_card, b_card)
            e["chain_rel"] = _lm_close(f"lm card against CPU {arch} chain",
                                       got, ref, LM_CPU_CHAIN)
            if cfg.n_experts:
                e["dispatch"] = lm_dispatch_check(m, cfg, calls)
            out[arch] = e
            del model_card, calls
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
    print(f"chip_smoke: lm card against CPU (float32, {LM_CPU_LAYERS} layers "
          f"at full width, TF32 off): {out}")
    return out


def lm_consistency(m, cfg, model, batch) -> dict:
    """prefill(S-1) + one decode step against forward at S-2 and S-1,
    relative to max|forward|, the caches in the weights' dtype (a check of
    the caches, not of their rounding), as tests/test_archs_smoke.py holds
    the JAX package, under 2e-2: (1) layer by layer, each block's prefill
    and decode on the forward's input to that block; (2) the whole model,
    through the embedding, whisper's position at ``index``, the final norm
    and the vocabulary cut; its decode only recorded for the stacks of
    `LM_CHAOTIC`, which amplify the last-bit differences between the two
    paths past the bound (attention logits of ~500 and, in the MoE, top-k
    choices that flip)."""
    M, blk = m["lm_model"], m["lm_blocks"]
    S = batch["tokens"].shape[1]
    cache_dtype = model.embed["tokens"].dtype
    if "positions3" in batch:
        _fail("lm consistency: the VLM follows the JAX test's skip")
    enc = (M._encoder(cfg, model, batch["frames"]) if cfg.is_encdec
           else None)
    x, pos, _ = M._embed_inputs(cfg, model, batch)
    e_layer = [0.0, 0.0]
    for i, (bt, p) in enumerate(zip(M._block_types(cfg), model.layers)):
        y, _ = blk.block_apply(cfg, bt, p, x, positions=pos, enc_out=enc)
        y_pre, cache = blk.block_prefill(
            cfg, bt, p, x[:, :S - 1], positions=pos[:, :S - 1], enc_out=enc,
            s_max=S, cache_dtype=cache_dtype)
        y_dec, _ = blk.block_decode(cfg, bt, p, x[:, S - 1:], cache, S - 1)
        scale = float(y.float().abs().max())
        e_layer[0] = max(e_layer[0], float(
            (y_pre.float() - y[:, :S - 1].float()).abs().max()) / scale)
        e_layer[1] = max(e_layer[1], float(
            (y_dec.float() - y[:, S - 1:].float()).abs().max()) / scale)
        x = y
    if not (e_layer[0] < LM_CONSISTENCY and e_layer[1] < LM_CONSISTENCY):
        _fail(f"lm decode consistency {cfg.name}: a layer's prefill "
              f"{e_layer[0]}, decode {e_layer[1]} (bound {LM_CONSISTENCY})")
    full, _ = M.forward(cfg, model, batch)
    pre = dict(batch)
    pre["tokens"] = batch["tokens"][:, :S - 1]
    lg_pre, cache = M.prefill(cfg, model, pre, s_max=S,
                              cache_dtype=cache_dtype)
    lg_dec, _ = M.decode_step(cfg, model, batch["tokens"][:, S - 1:], cache,
                              S - 1)
    V = cfg.vocab_size
    scale = float(full.abs().max())
    out = {"layer_prefill": e_layer[0], "layer_decode": e_layer[1],
           "model_prefill": float(
               (lg_pre - full[:, S - 2, :V]).abs().max()) / scale,
           "model_decode": float(
               (lg_dec - full[:, S - 1, :V]).abs().max()) / scale,
           "model_decode_gated": (cfg.name, cfg.dtype) not in LM_CHAOTIC}
    if not (out["model_prefill"] < LM_CONSISTENCY
            and (out["model_decode"] < LM_CONSISTENCY
                 or not out["model_decode_gated"])):
        _fail(f"lm decode consistency {cfg.name} {cfg.dtype}: the model's "
              f"prefill {out['model_prefill']}, decode {out['model_decode']}"
              f" (bound {LM_CONSISTENCY})")
    return out


def _no_drop(cfg):
    """The configuration with a capacity where no routing pair can drop."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


def lm_arch(m, arch: str, model=None) -> dict:
    """One architecture at full width (one repeat of its block pattern;
    smollm-360m and the served granite at full depth): forward, prefill and
    LM_ARCH_DECODE greedy decode steps at batch 2 and prompt 64 (the VLM:
    its 256-position vision prefix + 64), finite logits, in bf16; then
    `lm_consistency` (MoE at a capacity where nothing drops; the VLM
    skipped, as in the JAX test) in bf16 and on the same weights in
    float32, the JAX test's dtype, where they fit (not kimi-k2's)."""
    M, lc = m["lm_model"], m["lm_configs"]
    cfg = lc.get_config(arch)
    if model is None and arch != "smollm-360m":
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
    torch.cuda.reset_peak_memory_stats()
    init_s = 0.0
    if model is None:
        gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
        model, init_s = _wall(lambda: M.init_model(cfg, gen, device=DEVICE))
    S = LM_ARCH_PROMPT + (cfg.vision_prefix if cfg.family == "vlm" else 0)
    batch = m["lm_pipeline"].make_batch(cfg, LM_ARCH_BATCH, S, LM_SEED, 1,
                                        device=DEVICE)
    batch.pop("labels")
    (logits, _), fwd_s = _wall(lambda: M.forward(cfg, model, batch))
    (lg, cache), pre_s = _wall(lambda: M.prefill(
        cfg, model, batch, s_max=S + LM_ARCH_DECODE))
    finite = bool(torch.isfinite(logits).all()) and \
        bool(torch.isfinite(lg).all())
    dec_s = []
    for i in range(LM_ARCH_DECODE):
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        (lg, cache), s = _wall(lambda: M.decode_step(cfg, model, tok, cache,
                                                     S + i))
        finite = finite and bool(torch.isfinite(lg).all())
        dec_s.append(s)
    if not finite:
        _fail(f"lm {arch}: non-finite logits")
    out = {"layers": cfg.n_layers, "params": M.count_params(cfg),
           "weight_bytes": _param_bytes(model), "prompt": S,
           "init_s": init_s, "forward_ms": fwd_s * 1e3,
           "prefill_ms": pre_s * 1e3,
           "decode_ms": [s * 1e3 for s in dec_s]}
    del cache, logits
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if cfg.family != "vlm":
        out["bf16"] = lm_consistency(m, _no_drop(cfg), model, batch)
        if 2 * out["weight_bytes"] <= LM_F32_MAX_BYTES:
            model.to(torch.float32)
            out["float32"] = lm_consistency(
                m, _no_drop(dataclasses.replace(cfg, dtype="float32")),
                model, batch)
        out["consistency_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"chip_smoke: lm {arch} ({cfg.n_layers} layers, "
          f"{out['weight_bytes'] / 1e9:.2f} GB): forward "
          f"{out['forward_ms']:.2f} ms, prefill {out['prefill_ms']:.2f} ms, "
          f"decode {[round(d, 2) for d in out['decode_ms']]} ms, peak "
          f"{out['peak_bytes'] / 1e9:.2f} GB; decode consistency bf16 "
          f"{out.get('bf16')}, float32 {out.get('float32')}")
    return out


def phase_lm(m) -> dict:
    """The LM stack on the card: granite served at full size, the card
    against the CPU at full width, and every architecture at full width
    with the decode consistency check."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        serve, granite = lm_serve(m)
        archs = {serve["arch"]: lm_arch(m, serve["arch"], granite)}
        del granite
        torch.cuda.empty_cache()
        cpu = lm_cpu_parity(m)
        for arch in m["lm_configs"].ARCHS:
            if arch not in archs:
                archs[arch] = lm_arch(m, arch)
                torch.cuda.empty_cache()
    peak = max([serve["peak_bytes"]] + [
        max(e["peak_bytes"], e.get("consistency_peak_bytes", 0))
        for e in archs.values()])
    return {"serve": serve, "cpu_vs_card": cpu, "archs": archs,
            "peak_bytes": peak, "seconds": time.perf_counter() - t0}


TRAIN_ARCH = "granite-moe-3b-a800m"
TRAIN_STEPS = 6            # (a)
TRAIN_RUN = ["--batch", "4", "--seq", "1024", "--lr", "3e-4", "--warmup",
             "20", "--seed", "0", "--log-every", "1"]
TRAIN_DET_STEPS = 3        # (b): steps of each run
TRAIN_CPU_LOSS = 1e-4      # (c): card against CPU, loss, relative
TRAIN_CPU_GRAD = 1e-2      # (c): each gradient leaf, of max|cpu leaf|
TRAIN_CPU_OPT = 1e-6       # (c): the optimizer alone, of max|cpu leaf|
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 64
TRAIN_RESUME = ["--repeats", "2", "--batch", "2", "--seq", "256",
                "--lr", "3e-4", "--warmup", "20", "--log-every", "1"]
TRAIN_ARCH_SEQ, TRAIN_ARCH_STEPS = 128, 2
TRAIN_SKIP = {"kimi-k2-1t-a32b": "one repeat holds 38.8 GB of bf16 weights "
              "and as much again of gradients, ~77 GB of the card's 80 "
              "before optimizer state; its Adafactor path is held by (c) "
              "and the CPU tests"}
TRAIN_CPD = ["--workload", "cpd", "--dims", "6186,24,77,32", "--nnz",
             "4860000", "--rank", "16", "--iters", "10", "--seed", "0",
             "--device", "cuda"]


def _train_args(m, arch, argv):
    return m["lm_train"].parser().parse_args(["--arch", arch] + argv)


def _finite_history(label, history) -> None:
    for h in history:
        if not all(math.isfinite(h[k]) for k in ("loss", "ce", "aux",
                                                  "grad_norm")):
            _fail(f"{label}: non-finite metrics at step {h['step']}: {h}")


def _param_copies(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def train_granite(m) -> dict:
    """(a): granite at its published size through `launch.train.train_lm`;
    step 0's loss against `make_loss_fn` run separately under no_grad."""
    M, tr = m["lm_model"], m["lm_train"]
    args = _train_args(m, TRAIN_ARCH,
                       TRAIN_RUN + ["--steps", str(TRAIN_STEPS)])
    cfg = tr.lm_config(args)
    model = M.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(
        args.seed), device=DEVICE)
    batch = m["lm_pipeline"].make_batch(cfg, args.batch, args.seq,
                                        args.seed, 0, device=DEVICE)
    with torch.no_grad():
        ref = float(m["lm_steps"].make_loss_fn(cfg)(model, batch)[0])
    del model, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run, seconds = _wall(lambda: tr.train_lm(args))
    peak = torch.cuda.max_memory_allocated()
    _finite_history("train granite", run.history)
    if run.history[0]["loss"] != ref:
        _fail(f"train granite: step 0's loss {run.history[0]['loss']} is "
              f"not the separate loss {ref}")
    steady = sorted(run.step_s[1:])
    ms = 1e3 * steady[len(steady) // 2]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "batch": args.batch, "seq": args.seq,
           "steps": args.steps, "history": run.history,
           "step_ms": [1e3 * s for s in run.step_s], "ms_per_step": ms,
           "tokens_per_s": args.batch * args.seq / (ms / 1e3),
           "weight_bytes": _param_bytes(run.model), "peak_bytes": peak,
           "step0_loss_equals_no_grad_loss": True, "seconds": seconds}
    print(f"chip_smoke: train {cfg.name} ({cfg.n_layers} layers, bf16, "
          f"AdamW, remat): {args.steps} steps of {args.batch} × {args.seq} "
          f"tokens, losses {[round(h['loss'], 4) for h in run.history]}, "
          f"{ms:.1f} ms a step (median of steps 2-{args.steps}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak / 1e9:.2f} GB; "
          f"step 0 bit for bit the separate loss")
    return out


def train_repeat(m) -> dict:
    """(b): the first TRAIN_DET_STEPS steps of (a) twice in deterministic
    mode (equal bits), twice in the default mode (the spread)."""
    tr = m["lm_train"]
    args = _train_args(m, TRAIN_ARCH,
                       TRAIN_RUN + ["--steps", str(TRAIN_DET_STEPS)])
    out = {"steps": TRAIN_DET_STEPS}
    for mode in ("deterministic", "default"):
        runs = []
        for _ in range(2):
            with (_index_order(warn_only=False) if mode == "deterministic"
                  else contextlib.nullcontext()):
                run = tr.train_lm(args)
            _finite_history(f"train {mode}", run.history)
            runs.append(([h["loss"] for h in run.history],
                         _param_copies(run.model)))
            del run
            torch.cuda.empty_cache()
        (la, pa), (lb, pb) = runs
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(pa, pb))
        out[mode] = {"losses": [la, lb], "max_param_diff": diff,
                     "params_differ": sum(not torch.equal(a, b)
                                          for a, b in zip(pa, pb)),
                     "n_params": len(pa)}
        del runs, pa, pb
        torch.cuda.empty_cache()
        if mode == "deterministic" and (la != lb or diff != 0.0):
            _fail(f"train deterministic: two runs differ: losses {la} "
                  f"against {lb}, largest parameter difference {diff}")
    print(f"chip_smoke: train repeat ({TRAIN_DET_STEPS} steps twice): "
          f"{out}")
    return out


def _leaf_grads(m, cfg, model, batch):
    """The loss and each JAX leaf's gradient (stacked) of `make_loss_fn`."""
    leaves = m["lm_model"].jax_leaves(model)
    loss, _ = m["lm_steps"].make_loss_fn(cfg)(model, batch)
    flat = iter(torch.autograd.grad(
        loss, [p for leaf in leaves for p in leaf.params]))
    grads = [[next(flat) for _ in leaf.params] for leaf in leaves]
    return float(loss.detach()), leaves, grads


def _leaf_rel(label, got, ref, bound, readings) -> None:
    """A leaf (its layers stacked) within ``bound`` of max|ref|. A
    bfloat16 leaf (Adafactor's first moment) may also round to the next
    bfloat16 value where its float32 value moved by a last bit: one
    bfloat16 ulp of each element more."""
    with torch.no_grad():
        got = torch.stack(got) if len(got) > 1 else got[0]
        ref = torch.stack(ref) if len(ref) > 1 else ref[0]
        bf16 = ref.dtype == torch.bfloat16
        got, ref = got.float().cpu(), ref.float().cpu()
        scale = float(ref.abs().max())
        err = (got - ref).abs()
        if bf16:
            ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(
                torch.finfo(torch.float32).tiny))) - 7)
            err = torch.clamp_min(err - ulp, 0.0)
        rel = float(err.max()) / scale if scale else 0.0
        finite = bool(torch.isfinite(got).all())
    readings[label] = rel
    if not (finite and rel <= bound):
        _fail(f"train card against CPU {label}: {rel} of max|cpu| "
              f"(bound {bound}{' past one bfloat16 ulp' if bf16 else ''})")


def train_cpu_parity(m) -> dict:
    """(c): one step on the card and on the CPU on the same weights and
    batch, float32, TF32 off; then each optimizer alone on identical
    gradients, parameters and state."""
    M, lc, interop = m["lm_model"], m["lm_configs"], m["interop"]
    opt_mod = m["lm_optim"]
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for arch in (TRAIN_ARCH, "smollm-360m"):
            cfg = dataclasses.replace(lc.get_config(arch),
                                      n_layers=LM_CPU_LAYERS,
                                      dtype="float32")
            cpu = M.init_model(cfg, torch.Generator().manual_seed(LM_SEED),
                               device="cpu").requires_grad_(True)
            card = M.Model(cfg)
            card.load_state_dict({k: v.to(DEVICE) for k, v in
                                  cpu.state_dict().items()}, assign=True)
            card.requires_grad_(True)
            b_cpu = m["lm_pipeline"].make_batch(
                cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, LM_SEED, 0, device="cpu")
            b_card = {k: v.to(DEVICE) for k, v in b_cpu.items()}
            loss_c, leaves_c, g_cpu = _leaf_grads(m, cfg, cpu, b_cpu)
            loss_g, leaves_g, g_card = _leaf_grads(m, cfg, card, b_card)
            e = {"loss_cpu": loss_c, "loss_card": loss_g,
                 "loss_rel": abs(loss_g - loss_c) / abs(loss_c), "grad": {}}
            if not e["loss_rel"] <= TRAIN_CPU_LOSS:
                _fail(f"train card against CPU {arch}: loss {loss_g} "
                      f"against {loss_c}")
            for leaf, a, b in zip(leaves_c, g_card, g_cpu):
                _leaf_rel(f"{arch} grad {leaf.name}", a, b, TRAIN_CPU_GRAD,
                          e["grad"])
            e["grad_worst"] = max(e["grad"].values())
            names = ["adamw"] + (["adafactor"] if arch == TRAIN_ARCH else [])
            for name in names:
                lr = opt_mod.warmup_cosine(3e-4, 20, 10)
                o_cpu = opt_mod.get_optimizer(name, leaves_c, lr=lr)
                o_cpu.step(grads=g_cpu)          # a state that is not zero
                with torch.no_grad():
                    for pc, pg in zip(cpu.parameters(), card.parameters()):
                        pg.copy_(pc)
                o_card = opt_mod.get_optimizer(name, leaves_g, lr=lr)
                interop.lm_opt_state(o_card,
                                     interop.lm_train_tree(cpu, o_cpu)[1])
                o_cpu.step(grads=g_cpu)
                o_card.step(grads=[[g.to(DEVICE) for g in leaf]
                                   for leaf in g_cpu])
                rel = {}
                for leaf_c, leaf_g in zip(leaves_c, leaves_g):
                    _leaf_rel(f"{arch} {name} param {leaf_c.name}",
                              leaf_g.params, leaf_c.params, TRAIN_CPU_OPT,
                              rel)
                for gc, gg in zip(o_cpu.param_groups, o_card.param_groups):
                    for key in ("m", "v", "vr", "vc"):
                        if key in gc:
                            _leaf_rel(f"{arch} {name} {key} {gc['leaf']}",
                                      [gg[key]], [gc[key]], TRAIN_CPU_OPT,
                                      rel)
                e[f"{name}_worst"] = max(rel.values())
            out[arch] = e
            del cpu, card, g_cpu, g_card, leaves_c, leaves_g
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
    print(f"chip_smoke: train card against CPU (float32, {LM_CPU_LAYERS} "
          f"layers at full width, TF32 off): " + "; ".join(
              f"{a}: loss {e['loss_rel']:.3g}, worst gradient leaf "
              f"{e['grad_worst']:.3g}, optimizer alone "
              + ", ".join(f"{k[:-6]} {v:.3g}" for k, v in e.items()
                          if k.endswith("_worst") and k != "grad_worst")
              for a, e in out.items()))
    return out


def train_resume(m) -> dict:
    """(d): the two-layer granite in bf16, cut after 2 steps and resumed
    from the launcher's checkpoint, against the uninterrupted 4 steps, in
    deterministic mode."""
    import tempfile
    tr = m["lm_train"]
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as d, \
            _index_order(warn_only=False):
        full = tr.train_lm(_train_args(m, TRAIN_ARCH,
                                       TRAIN_RESUME + ["--steps", "4"]))
        want = (list(full.history), _param_copies(full.model))
        del full
        tr.train_lm(_train_args(m, TRAIN_ARCH, TRAIN_RESUME + [
            "--steps", "2", "--ckpt-dir", d]))
        resumed = tr.train_lm(_train_args(m, TRAIN_ARCH, TRAIN_RESUME + [
            "--steps", "4", "--ckpt-dir", d]))
        got = _param_copies(resumed.model)
        if resumed.history != want[0][2:] or not all(
                torch.equal(a, b) for a, b in zip(got, want[1])):
            _fail(f"train resume: the resumed run {resumed.history} is not "
                  f"the uninterrupted one's {want[0][2:]} bit for bit")
        out = {"layers": resumed.model.cfg.n_layers,
               "losses": [h["loss"] for h in want[0]],
               "resumed_bitwise": True}
    print(f"chip_smoke: train cut after 2 steps and resumed: {out}")
    return out


def train_archs(m) -> dict:
    """(e): every other architecture at full width, one repeat of its
    pattern (smollm-360m at full depth), through the launcher."""
    tr, lc = m["lm_train"], m["lm_configs"]
    out = {}
    for arch in lc.ARCHS:
        if arch == TRAIN_ARCH:
            continue
        if arch in TRAIN_SKIP:
            print(f"chip_smoke: train {arch} skipped: {TRAIN_SKIP[arch]}")
            out[arch] = {"skipped": TRAIN_SKIP[arch]}
            continue
        cfg = lc.get_config(arch)
        B = max(2, cfg.grad_accum)
        S = TRAIN_ARCH_SEQ + (cfg.vision_prefix if cfg.family == "vlm"
                              else 0)
        argv = ["--steps", str(TRAIN_ARCH_STEPS), "--batch", str(B),
                "--seq", str(S), "--log-every", "1"]
        if arch != "smollm-360m":
            argv += ["--repeats", "1"]
        torch.cuda.reset_peak_memory_stats()
        run = tr.train_lm(_train_args(m, arch, argv))
        _finite_history(f"train {arch}", run.history)
        out[arch] = {"layers": run.model.cfg.n_layers,
                     "optimizer": run.model.cfg.optimizer,
                     "grad_accum": run.model.cfg.grad_accum, "batch": B,
                     "seq": S, "weight_bytes": _param_bytes(run.model),
                     "step_ms": [1e3 * s for s in run.step_s],
                     "losses": [h["loss"] for h in run.history],
                     "grad_norms": [h["grad_norm"] for h in run.history],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del run
        torch.cuda.empty_cache()
        e = out[arch]
        print(f"chip_smoke: train {arch} ({e['layers']} layers, "
              f"{e['optimizer']}, grad_accum {e['grad_accum']}, batch {B} "
              f"× {S}): steps {[round(t, 1) for t in e['step_ms']]} ms, "
              f"peak {e['peak_bytes'] / 1e9:.2f} GB, losses {e['losses']}")
    return out


def train_cpd(m) -> dict:
    """(f): the launcher's CPD workload on Chicago's shape at world size 1
    over NCCL (counted), then `distributed_cp_als` called directly."""
    tr = m["lm_train"]
    args = tr.parser().parse_args(TRAIN_CPD)
    (_, _, fits), seconds, counts = _counted(
        m, "train cpd", lambda: tr.train_cpd(args),
        {"carry_runs", "carry_fixup"})
    if not all(math.isfinite(f) for f in fits) or any(
            b < a - 1e-3 for a, b in zip(fits, fits[1:])):
        _fail(f"train cpd: fits {fits}")
    dims = tuple(int(d) for d in args.dims.split(","))
    x = m["synthetic"].zipf_tensor(dims, args.nnz, seed=args.seed)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0)
    try:
        _, _, direct = m["cpd"].distributed_cp_als(
            x, rank=args.rank, n_iters=args.iters, seed=args.seed,
            device=DEVICE)
    finally:
        torch.distributed.destroy_process_group()
    if fits != direct:
        _fail(f"train cpd: fits {fits} are not distributed_cp_als's "
              f"{direct}")
    out = {"dims": dims, "nnz": x.nnz, "rank": args.rank, "fits": fits,
           "seconds": seconds, "launches": counts["launches"],
           "elements": counts["elements"], "equals_direct": True}
    print(f"chip_smoke: train cpd {dims}, {x.nnz} nonzeros, rank "
          f"{args.rank}: fits {fits} in {seconds:.2f} s (the launcher, "
          f"zipf draw and build included), bit for bit distributed_cp_als;"
          f" launches {counts['launches']}")
    return out


def phase_train(m) -> dict:
    """The training path on the card, (a)-(f) of step 17."""
    t0 = time.perf_counter()
    out = {"granite": train_granite(m)}
    torch.cuda.empty_cache()
    out["repeat"] = train_repeat(m)
    out["cpu_vs_card"] = train_cpu_parity(m)
    out["resume"] = train_resume(m)
    out["archs"] = train_archs(m)
    out["cpd"] = train_cpd(m)
    out["seconds"] = time.perf_counter() - t0
    return out

MESH_STAGES = 2             # (a): gloo ranks sharing the one card
MESH_MICRO = 4              # (a): microbatches of TRAIN_RUN's batch
MESH_GRAD_TOL = 1e-3        # (a): each gradient leaf, of max|reference|
MESH_TIMEOUT_S = 600.0


def _grad_readings(got: dict, ref: dict) -> dict:
    """Per parameter: the largest difference of max|ref| and whether the
    two are equal bit for bit."""
    out = {}
    for name, g in got.items():
        r = ref[name]
        scale = float(r.float().abs().max())
        diff = (g.float() - r.float()).abs()
        err = float(diff.max())
        out[name] = {"rel": err / scale if scale else err,
                     "bitwise": bool(torch.equal(g, r)),
                     "finite": bool(torch.isfinite(g).all())}
        if r.dtype == torch.bfloat16:     # the error in units of last place
            ulp = torch.exp2(torch.floor(torch.log2(r.float().abs().clamp_min(
                torch.finfo(torch.float32).tiny))) - 7)
            out[name]["max_ulps"] = float((diff / ulp).max())
    return out


@contextlib.contextmanager
def _routing_tap(moe):
    """Records every MoE call's routing while it is open: the top-k
    experts (``route``) and which pairs kept a capacity slot
    (``dispatch_slots``), one dict a call."""
    calls = []
    route, slots = moe.route, moe.dispatch_slots

    def tap_route(cfg, p, x):
        out = route(cfg, p, x)
        calls.append({"top_e": out[2]})
        return out

    def tap_slots(cfg, top_e, C, alto):
        out = slots(cfg, top_e, C, alto)
        calls[-1]["keep"] = out[1]
        return out

    moe.route, moe.dispatch_slots = tap_route, tap_slots
    try:
        yield calls
    finally:
        moe.route, moe.dispatch_slots = route, slots


def _kept_experts(call, n_experts: int):
    """(B, S, E) bool: the experts each token was routed to and kept."""
    B, S, K = call["top_e"].shape
    hot = call["top_e"][..., None] == torch.arange(
        n_experts, device=call["top_e"].device)
    return (hot & call["keep"].view(B, S, K, 1)).any(dim=2)


def _routing_diff(whole: dict, parts: list, n_experts: int) -> int:
    """Tokens whose kept experts differ between one whole-batch MoE call
    and the same layer's calls on the microbatches."""
    a = _kept_experts(whole, n_experts)
    b = torch.cat([_kept_experts(c, n_experts) for c in parts])
    return int((a != b).any(dim=-1).sum())


def whole_batch_witness(m, cfg, model, tokens, n_micro: int) -> dict:
    """Where the whole-batch forward parts from the microbatched one, layer
    by layer (``no_grad``, the caller's deterministic mode). Three chains
    from the embedding: the whole batch, the ``n_micro`` microbatches one
    after another, and a twin of the microbatches whose first embedding
    element is one bf16 unit in the last place away. Per layer: ``local``,
    the layer applied to the microbatched chain's input as one batch
    against per microbatch (the gap the layer itself makes on equal
    inputs), with the tokens whose kept experts differ
    (``local_routing``); ``chain``, the whole chain against the
    microbatched one, and its routing difference (``chain_routing``);
    ``twin``, the twin against the microbatched chain. Each gap is
    max|a - b| / max|b|; the logits' gaps close the lists."""
    M, blk, moe, common = (m["lm_model"], m["lm_blocks"], m["lm_moe"],
                           m["lm_common"])
    E = cfg.n_experts

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {k: [] for k in ("local", "local_routing", "chain",
                           "chain_routing", "twin", "dropped_pairs")}
    with torch.no_grad(), _routing_tap(moe) as calls:
        xw, pos, _ = M._embed_inputs(cfg, model, {"tokens": tokens})
        xm = [M._embed_inputs(cfg, model, {"tokens": t})[0]
              for t in torch.chunk(tokens, n_micro, dim=0)]
        out["embedding_bitwise"] = bool(torch.equal(xw, torch.cat(xm)))
        xt = [x.clone() for x in xm]
        xt[0].view(torch.int16).view(-1)[0] += 1      # one ulp, one element
        for bt, p in zip(M._block_types(cfg), model.layers):
            def run(x):
                return blk.block_apply(cfg, bt, p, x, positions=pos)[0]
            calls.clear()
            yl = run(torch.cat(xm))      # MoE calls: this one, then
            ym = [run(x) for x in xm]    # the n microbatches', then
            yw = run(xw)                 # the whole chain's
            yt = [run(x) for x in xt]
            out["local"].append(rel(yl, torch.cat(ym)))
            out["chain"].append(rel(yw, torch.cat(ym)))
            out["twin"].append(rel(torch.cat(yt), torch.cat(ym)))
            if calls:
                parts = calls[1:1 + n_micro]
                out["local_routing"].append(_routing_diff(calls[0], parts, E))
                out["chain_routing"].append(
                    _routing_diff(calls[1 + n_micro], parts, E))
                out["dropped_pairs"].append(
                    int(sum(int((~c["keep"]).sum()) for c in parts)))
            xw, xm, xt = yw, ym, yt
        head = M.unembed_params(cfg, model)

        def logits(x):
            return common.unembed(head, common.rmsnorm(
                model.final_norm, x, cfg.norm_eps))
        ref = torch.cat([logits(x) for x in xm])
        out["logits_chain"] = rel(logits(xw), ref)
        out["logits_twin"] = rel(torch.cat([logits(x) for x in xt]), ref)
    return out


def mesh_pipeline_rank(m, rank: int, world: int, cfg, batch_size: int,
                       seq: int, device) -> dict:
    """(a) on one rank: the reference, `MESH_MICRO` microbatches of the
    batch through `models.model.forward` one after another on the whole
    model (the CE over their concatenated logits + the router aux, their
    auxes summed in order and divided by the count, as the pipeline does)
    and its gradient; then the model cut into ``world`` stages, this
    rank's stage kept, and `dist.pipeline.forward_with_aux` with the same
    loss, timed, and held against the reference: logits and loss bit for
    bit, this rank's gradients (its stage's, and on rank 0 the shared
    parameters') within `MESH_GRAD_TOL` of max|reference|. Deterministic
    mode throughout (`_index_order(warn_only=False)`)."""
    M, PP, steps = m["lm_model"], m["lm_pp"], m["lm_steps"]
    gen = torch.Generator(device=device).manual_seed(0)
    model = M.init_model(cfg, gen, device=device)
    model.requires_grad_(True)
    batch = m["lm_pipeline"].make_batch(cfg, batch_size, seq, 0, 0,
                                        device=device)
    labels = batch["labels"]
    out = {"rank": rank}
    with _index_order(warn_only=False):
        parts = [torch.chunk(v, MESH_MICRO, dim=0)
                 for v in (batch["tokens"], labels)]
        logits_m, aux = [], None
        for mb in range(MESH_MICRO):
            lg, a = M.forward(cfg, model, {"tokens": parts[0][mb],
                                           "labels": parts[1][mb]})
            logits_m.append(lg)
            aux = a if aux is None else aux + a
        ref_logits = torch.cat(logits_m, dim=0)
        ref_loss = steps.cross_entropy(ref_logits, labels) \
            + cfg.router_aux_coef * (aux / MESH_MICRO)
        ref_loss.backward()
        ref_logits, ref_loss = ref_logits.detach(), ref_loss.detach()
        del logits_m, aux
        if rank == 0:           # recorded, not gated
            with torch.no_grad():
                whole, _ = M.forward(cfg, model, {"tokens": batch["tokens"]})
            out["whole_batch_logits_rel"] = float(
                (whole - ref_logits).abs().max() / ref_logits.abs().max())
            del whole
            out["whole_batch_witness"] = whole_batch_witness(
                m, cfg, model, batch["tokens"], MESH_MICRO)
        pp = PP.to_pipeline_params(cfg, model, world)
        own = {id(p) for p in pp.stages[rank].parameters()}
        keep = {n: p for n, p in model.named_parameters()
                if id(p) in own or (rank == 0
                                    and not n.startswith("layers."))}
        ref_grads = {n: p.grad.detach().clone() for n, p in keep.items()}
        for s_ in range(world):
            if s_ != rank:
                pp.stages[s_] = torch.nn.ModuleList()
        model.layers = torch.nn.ModuleList()
        for p in model.parameters():
            p.grad = None
        for p in pp.stages[rank].parameters():
            p.grad = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _sync()
        torch.distributed.barrier()     # rank 0's witness stays untimed
        stats = PP.PipeStats()
        t0 = time.perf_counter()
        logits, aux = PP.forward_with_aux(cfg, pp, batch["tokens"],
                                          MESH_MICRO, stats=stats)
        loss = steps.cross_entropy(logits, labels) \
            + cfg.router_aux_coef * aux
        loss.backward()
        if device.type == "cuda":
            _sync()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device.type == "cuda" else 0)
    out["staged_bytes"] = stats.staged_bytes
    out["sends"], out["recvs"] = stats.sends, stats.recvs
    out["logits_bitwise"] = bool(torch.equal(logits.detach(), ref_logits))
    out["loss_bitwise"] = bool(torch.equal(loss.detach(), ref_loss))
    out["loss"], out["ref_loss"] = float(loss.detach()), float(ref_loss)
    out["logits_rel"] = float((logits.detach() - ref_logits).abs().max()
                              / ref_logits.abs().max())
    out["grads"] = _grad_readings(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in keep.items()}, ref_grads)
    return out


def _mesh_rank(rank: int, world: int, addr: str, out_dir: str) -> None:
    """One gloo rank of `phase_mesh` (a) on the one card (a spawned
    process); writes ``out_dir/rank<r>.json``."""
    import traceback
    out_dir = pathlib.Path(out_dir)
    try:
        m = _imports()
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            "gloo", init_method=addr, world_size=world, rank=rank)
        cfg = m["lm_configs"].get_config(TRAIN_ARCH)
        args = _train_args(m, TRAIN_ARCH, TRAIN_RUN)
        res = mesh_pipeline_rank(m, rank, world, cfg, args.batch, args.seq,
                                 torch.device(DEVICE))
        torch.distributed.destroy_process_group()
        (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def check_pipeline_ranks(ranks: list, label: str) -> dict:
    """The pipelined run's verdicts over its ranks; fails the phase on
    any."""
    grads = {}
    for r in ranks:
        if not (r["logits_bitwise"] and r["loss_bitwise"]):
            _fail(f"{label} rank {r['rank']}: logits bit for bit "
                  f"{r['logits_bitwise']}, loss {r['loss']} against the "
                  f"unpipelined {r['ref_loss']} ({r['logits_rel']} of "
                  "max|logits|)")
        for n, g in r["grads"].items():
            if not g["finite"] or g["rel"] > MESH_GRAD_TOL:
                _fail(f"{label} rank {r['rank']}: gradient {n}: "
                      f"{g['rel']} of max|reference| (bound "
                      f"{MESH_GRAD_TOL})")
            grads[n] = g
    worst = max(grads.items(), key=lambda kv: kv[1]["rel"])
    return {"n_grads": len(grads),
            "grads_bitwise": sum(g["bitwise"] for g in grads.values()),
            "worst_grad": [worst[0], worst[1]["rel"]],
            "not_bitwise": sorted(n for n, g in grads.items()
                                  if not g["bitwise"])}


def mesh_pipeline(m) -> dict:
    """(a): granite at its published size, 2 stages of 16 layers on two
    gloo ranks sharing the card, 4 microbatches of TRAIN_RUN's batch."""
    import multiprocessing
    work = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    addr = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, MESH_STAGES, addr, str(work)))
             for r in range(MESH_STAGES)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            _fail(f"mesh ranks still running after {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall_s = time.perf_counter() - t0
    errors = [(work / f"rank{r}.err").read_text()
              for r in range(MESH_STAGES)
              if (work / f"rank{r}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        _fail("mesh ranks failed: exit codes "
              f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(MESH_STAGES)]
    shutil.rmtree(work, ignore_errors=True)
    verdict = check_pipeline_ranks(ranks, "mesh pipeline")
    out = {"stages": MESH_STAGES, "microbatches": MESH_MICRO,
           "step_ms": [r["step_ms"] for r in ranks],
           "peak_bytes": [r["peak_bytes"] for r in ranks],
           "staged_bytes": [r["staged_bytes"] for r in ranks],
           "whole_batch_logits_rel": ranks[0]["whole_batch_logits_rel"],
           "whole_batch_witness": ranks[0]["whole_batch_witness"],
           "loss": ranks[0]["loss"], "wall_s": wall_s, **verdict}
    w = out["whole_batch_witness"]
    first = next((i for i, e in enumerate(w["local"]) if e), None)
    print(f"chip_smoke: mesh pipeline {TRAIN_ARCH} ({MESH_STAGES} stages, "
          f"{MESH_MICRO} microbatches, gloo, one card): logits and loss "
          f"bit for bit the unpipelined run of the same microbatches; "
          f"{verdict['grads_bitwise']} of {verdict['n_grads']} gradient "
          f"leaves bit for bit, the worst {verdict['worst_grad']}; step "
          f"{out['step_ms']} ms, peak {out['peak_bytes']} B, staged "
          f"{out['staged_bytes']} B through the host; whole-batch forward "
          f"{out['whole_batch_logits_rel']:.3g} of max|logits| away "
          f"(recorded); {wall_s:.1f} s wall with the spawn")
    print(f"chip_smoke: mesh whole-batch witness (recorded): embedding bit "
          f"for bit {w['embedding_bitwise']}; the first layer whose whole-"
          f"batch apply differs on equal inputs {first}, the largest such "
          f"gap {max(w['local']):.3g}, tokens routed apart on equal inputs "
          f"{sum(w['local_routing'])}; chain gap by layer "
          f"{[float(f'{e:.3g}') for e in w['chain']]}, its tokens routed "
          f"apart {w['chain_routing']}; the one-ulp twin by layer "
          f"{[float(f'{e:.3g}') for e in w['twin']]}; logits gap chain "
          f"{w['logits_chain']:.3g}, twin {w['logits_twin']:.3g}; dropped "
          f"pairs a layer {w['dropped_pairs']}")
    return out


def mesh_dryrun_vs_step(m, cfg, batch_size: int, seq: int, device) -> dict:
    """(b): the dry run of the training step on a (1, 1) mesh (a fake
    one-rank group; DTensors on meta shards) against one real step on
    ``device``: per-device argument bytes against the bytes of the
    parameters, AdamW state and batch allocated, and the calibrated FLOP
    count against `FlopCounterMode` on the real step."""
    from torch.utils.flop_counter import FlopCounterMode
    D, M, tr = m["lm_dryrun"], m["lm_model"], m["lm_train"]
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    shape = ShapeConfig("train_pr25", seq, batch_size, "train")
    dist = torch.distributed
    D.fake_world(1)
    try:
        mesh = make_host_mesh(device_type="cpu")
        dry_args = D.build_cell(cfg, shape, mesh).argument_bytes
        t0 = time.perf_counter()
        dry = D.calibrate_costs(cfg, shape, mesh)
        dry_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    gen = torch.Generator(device=device).manual_seed(0)
    model = M.init_model(cfg, gen, device=device)
    model.requires_grad_(True)
    opt = m["lm_optim"].get_optimizer(cfg.optimizer, M.jax_leaves(model),
                                      lr=1e-4)
    batch = m["lm_pipeline"].make_batch(cfg, batch_size, seq, 0, 0,
                                        device=device)
    real = {"params": sum(p.numel() * p.element_size()
                          for p in model.parameters()),
            "opt_state": sum(g[k].numel() * g[k].element_size()
                             for g in opt.param_groups
                             for k in ("m", "v", "vr", "vc") if k in g),
            "batch": sum(v.numel() * v.element_size()
                         for v in batch.values())}
    step = m["lm_steps"].make_train_step(cfg)
    with FlopCounterMode(display=False) as fc:
        step(model, opt, batch)
    real_flops = fc.get_total_flops()
    del model, opt, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = {k: dry_args[k] for k in ("params", "opt_state", "batch")}
    if got != real:
        _fail(f"mesh dry run: argument bytes {got} against the allocated "
              f"{real}")
    if dry["flops"] != real_flops:
        _fail(f"mesh dry run: {dry['flops']} FLOPs against "
              f"FlopCounterMode's {real_flops} on the real step")
    return {"argument_bytes": got, "flops": dry["flops"],
            "real_flops": real_flops, "dry_run_s": dry_s,
            "bytes": dry["bytes"], "coll": dry["coll"]}


def phase_mesh(m, train, smi: str) -> dict:
    """(a) the GPipe pipeline at granite's published size on two ranks
    sharing the card; (b) the dry run on a (1, 1) mesh against the real
    training step; the model-FLOP share of `phase_train`'s granite
    step."""
    t0 = time.perf_counter()
    out = {"pipeline": mesh_pipeline(m)}
    cfg = m["lm_configs"].get_config(TRAIN_ARCH)
    args = _train_args(m, TRAIN_ARCH, TRAIN_RUN)
    dry = mesh_dryrun_vs_step(m, cfg, args.batch, args.seq,
                              torch.device(DEVICE))
    RL = m["lm_roofline"]
    from repro_torch.configs.base import ShapeConfig
    mf = RL.model_flops(cfg, ShapeConfig("train_pr25", args.seq, args.batch,
                                         "train"),
                        m["lm_model"].count_active_params(cfg))
    ms = train["granite"]["ms_per_step"]
    share = mf / (ms / 1e3 * RL.PEAK_FLOPS)
    dry.update(model_flops=mf, step_ms=ms, model_flop_share=share)
    out["dry_run"] = dry
    print(f"chip_smoke: mesh dry run (1, 1) of {TRAIN_ARCH}'s training "
          f"step ({args.batch} × {args.seq}, AdamW): argument bytes "
          f"{dry['argument_bytes']} equal the allocated; {dry['flops']:.6g} "
          f"FLOPs equal FlopCounterMode on the real step; model FLOPs "
          f"{mf:.6g}, the step {ms:.1f} ms (phase_train), "
          f"model_flops / (ms · {RL.PEAK_FLOPS:.0f}) = {share:.4f} on {smi}")
    out["seconds"] = time.perf_counter() - t0
    return out


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
    frames = check_stack_frames(m["build"])
    t_start = time.perf_counter()
    lm = phase_lm(m)
    train = phase_train(m)
    mesh = phase_mesh(m, train, smi)
    small = {"worst_err": phase_small(m), **phase_small_cp_als(m),
             "phi_worst_err": phase_small_phi(m),
             "cp_apr": phase_small_cp_apr(m),
             "chunk_worst_err": phase_small_chunks(m)}
    chicago = phase_chicago(m)
    chicago_apr = phase_chicago_apr(m, chicago)
    darpa = phase_darpa(m)
    darpa_apr = phase_darpa_apr(m, darpa)
    sharded = phase_dist(m, chicago, chicago_apr, darpa, darpa_apr)
    formats = phase_formats(m, chicago, darpa)
    del darpa["x"]     # the COO of phase_dist's ranks and phase_formats
    d_str = phase_darpa_streamed(m, darpa, darpa_apr)
    c_str = phase_chicago_streamed(m, chicago)
    buckets = phase_batched(m)
    ingested = phase_ingest(m, chicago, darpa)
    served = phase_serve(m, buckets, chicago)
    split = {"chicago": carry_split(
                 m, chicago["at"], chicago["plan"],
                 chicago["run"]["res"].factors, (1, 2, 3), "chicago",
                 chicago_apr["run"]["res"]),
             "darpa": carry_split(m, darpa["at"], darpa["plan"],
                                  darpa["run"]["res"].factors, (2,),
                                  "darpa")}
    runs = [chicago["run"], darpa["run"], darpa["onehot_run"],
            chicago_apr["run"], darpa_apr["run"], darpa_apr["onehot_run"],
            d_str["run"], d_str["apr_run"], c_str["incore_run"],
            c_str["run"], *buckets["runs"],
            *ingested["runs"], *served["runs"], *sharded["runs"],
            *formats["runs"], train["cpd"]]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in m["build"].KERNELS}
    launches["elements"] = {k: sum(r["elements"][k] for r in runs)
                            for k in m["build"].KERNELS}

    trav = m["heuristics"].Traversal
    cp, dp = chicago["plan"], darpa["plan"]
    c_fs = chicago["run"]["res"].factors
    d_fs = darpa["run"]["res"].factors
    rec = next(mp for mp in cp.modes if mp.traversal is trav.RECURSIVE)
    kernels = [time_recursive(m, chicago["at"], c_fs, rec, launches)]
    big = dp.modes[2]                      # the 23.8 M-row mode
    d_views = m["plan"].build_views(darpa["at"], dp)
    d_view = d_views[2]
    kernels += time_oriented(m, d_view, d_fs, big, launches)
    kernels.append(time_phi_recursive(m, chicago["at"],
                                      chicago_apr["run"]["res"], rec,
                                      launches))
    kernels[-1]["enron"] = phase_enron_k7(m)
    kernels += time_phi_oriented(m, d_view, darpa_apr["run"]["res"], big,
                                 launches)
    kernels.append(time_delinearize(m, darpa["at"], chicago["at"],
                                    d_str["chunk_m"], launches))
    kernels.append(time_pi_rows(m, d_views, darpa_apr["run"]["res"],
                                launches))
    del d_views, d_view
    kernels += time_chunks(m, d_str["streams"][2], d_str["plan"].streaming,
                           d_str["plan"].modes[2], d_str["run"]["res"],
                           d_str["apr_run"]["res"], launches)
    kernels.sort(key=lambda e: m["build"].KERNELS.index(e["name"]))
    for e in kernels:       # the bucketed path's launches on the tenant axis
        axis = [t for t in buckets["tenant_axis"]
                if t["kernel"] == e["name"]]
        if axis:
            e["tenant_axis"] = axis
    c_views = m["plan"].build_views(chicago["at"], cp)
    per_mode = {"chicago": mode_times(m, chicago["at"], cp, c_views, c_fs),
                "darpa": mode_times(m, darpa["at"], dp,
                                    m["plan"].build_views(darpa["at"], dp),
                                    d_fs)}
    if [e["name"] for e in kernels] != list(m["build"].KERNELS):
        _fail(f"kernels line lists {[e['name'] for e in kernels]}")

    def ratios(incore, chunked):
        return [a / b for a, b in zip(incore, chunked)]
    overlap = {
        "darpa_mttkrp": ratios(per_mode["darpa"], d_str["mttkrp_ms_per_mode"]),
        "darpa_phi_pre": ratios(darpa_apr["run"]["phi_ms_per_mode"],
                                d_str["apr_run"]["phi_ms_per_mode"]),
        "chicago_phi_otf": ratios(c_str["incore_run"]["phi_ms_per_mode"],
                                  c_str["run"]["phi_ms_per_mode"])}
    print(f"chip_smoke: streamed vs in core, ms per mode: darpa MTTKRP "
          f"{d_str['mttkrp_ms_per_mode']} vs {per_mode['darpa']}; darpa Φ "
          f"(pre) {d_str['apr_run']['phi_ms_per_mode']} vs "
          f"{darpa_apr['run']['phi_ms_per_mode']}; chicago Φ (otf) "
          f"{c_str['run']['phi_ms_per_mode']} vs "
          f"{c_str['incore_run']['phi_ms_per_mode']}; overlap efficiency "
          f"(in-core ms / streamed ms) {overlap}")
    for e in kernels:
        if e["launches"] == 0:
            _fail(f"kernel {e['name']} never launched on the main path")
    tuning = phase_tuning(m, chicago, darpa, chicago_apr, darpa_apr, d_str)
    elapsed = time.perf_counter() - t_start

    detail = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build_s, "stack_frames": frames, "small": small,
        "carry_split": split,
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
                     for mp in cp.modes],
           "cp_apr": _apr_detail(chicago_apr["run"]),
           "cp_apr_rerun_launches": chicago_apr["rerun_launches"]},
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
                     for mp in dp.modes],
           "cp_apr": _apr_detail(darpa_apr["run"]),
           "cp_apr_onehot": _apr_detail(darpa_apr["onehot_run"])},
        "darpa_streamed": {k: v for k, v in d_str.items()
                           if k not in ("plan", "streams", "run", "apr_run")}
        | {"fits": d_str["run"]["fits"],
           "cp_als_s": d_str["run"]["seconds"],
           "sweep_s": d_str["run"]["sweep_s"],
           "launches": d_str["run"]["launches"],
           "cp_apr": _apr_detail(d_str["apr_run"])},
        "chicago_streamed": {k: c_str[k] for k in ("chunk_m", "n_chunks",
                                                   "stream_build_s")}
        | {"cp_apr": _apr_detail(c_str["run"]),
           "cp_apr_incore": _apr_detail(c_str["incore_run"])},
        "overlap_efficiency": overlap, "tuning": tuning,
        "batched": buckets, "ingest": ingested, "serve": served,
        "dist": {k: v for k, v in sharded.items() if k != "runs"},
        "formats": {k: v for k, v in formats.items() if k != "runs"},
        "kernels": kernels, "checks": CHECKS, "lm": lm, "train": train,
        "mesh": mesh,
        "seconds_after_build": elapsed,
        "peak_memory_bytes": max(torch.cuda.max_memory_allocated(),
                                 lm["peak_bytes"],
                                 train["granite"]["peak_bytes"])}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"chip_smoke: per-mode MTTKRP ms {per_mode}; "
          f"{elapsed:.1f} s after the build; peak device memory "
          f"{detail['peak_memory_bytes'] / 1e9:.1f} GB")
    print(f"chip_smoke: {_checks_summary()}")
    print(json.dumps({"dist": detail["dist"]}))
    print(json.dumps({"formats": {
        t: {k: formats[t][k] for k in ("all_modes_ms", "speedup_over_coo",
                                       "per_mode_ms", "agreement",
                                       "build_s", "storage_bytes",
                                       "storage_over_coo")}
        for t in ("chicago", "darpa")} | {"seconds": formats["seconds"]}}))
    print(json.dumps({"lm": {
        "serve": {k: lm["serve"][k] for k in (
            "arch", "requests", "prompt", "tokens", "weight_bytes",
            "prefill_ms", "decode_ms_per_token", "tokens_per_s",
            "peak_bytes", "dispatch",
            "full_depth_alto_vs_reference_logits_rel")},
        "cpu_vs_card": lm["cpu_vs_card"],
        "archs": {a: {k: v for k, v in e.items() if k != "init_s"}
                  for a, e in lm["archs"].items()},
        "seconds": lm["seconds"]}}))
    print(json.dumps({"train": {
        "granite": {k: v for k, v in train["granite"].items()
                    if k != "history"},
        "repeat": {k: {"max_param_diff": v["max_param_diff"],
                       "params_differ": v["params_differ"]}
                   if isinstance(v, dict) else v
                   for k, v in train["repeat"].items()},
        "cpu_vs_card": {a: {k: v for k, v in e.items() if k != "grad"}
                        for a, e in train["cpu_vs_card"].items()},
        "resume": train["resume"], "archs": train["archs"],
        "cpd": {k: train["cpd"][k] for k in ("fits", "seconds",
                                             "launches")},
        "seconds": train["seconds"]}}))
    print(json.dumps({"mesh": {
        "pipeline": {k: v for k, v in mesh["pipeline"].items()
                     if k != "not_bitwise"},
        "dry_run": mesh["dry_run"], "seconds": mesh["seconds"]}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
