"""Multi-tenant decomposition service: COO submissions → bucketed CPD.

  PYTHONPATH=src python -m repro_torch.launch.serve_cpd --tenants 12 --rank 4
  PYTHONPATH=src python -m repro_torch.launch.serve_cpd --device cpu

The request path of many tenants' tensors decomposed at once on one card:

  submit(COO)          thread-safe admission into a shape class
    │                  (`core.shapeclass.classify`)
    ▼
  per-class queue      tenants wait until a bucket fills (or `process()`
    │                  flushes a partial one, filled with inactive slots)
    ▼
  pad → ingest → views `shapeclass.pad_to_class`, `alto.build_device` on
    │                  the service's device, `shapeclass.canonicalize_
    ▼                  tensor`, the view cache (`plan.build_views`)
  batched solve        `core.batched`: each kernel launched once a mode
    │                  for the whole bucket, on its tenant axis
    ▼
  per-tenant result    factors at the tenant's dims, fit / KKT history,
                       submit-to-result latency

The class plan comes from `plan.make_class_plan` with ``tune="auto"``:
the plan store is keyed on the canonical class meta
(`autotune.class_plan_key`), so a class tuned once, by any process on
this machine and card, dispatches with no timing run.

Degenerate tenants (an empty or a one-nonzero COO) are admitted,
bucketed and answered (an empty tensor: zero factors, fit 1.0).

Resilience: a background worker (`CpdService.serve` / `shutdown`) drains
the queues and survives any request's failure; each failure becomes a
structured `CpdResponse`, never a crash and never a poisoned mate:

* transient faults (`OSError`, `torch.OutOfMemoryError`:
  `faults.is_transient`) are retried with exponential backoff;
* a `faults.DispatchError` (a plan the kernels cannot dispatch) evicts
  the class's stored plan and retunes (the static plan) under ``tune``
  other than "off", once; an allocator failure of a streaming plan halves
  ``chunk_m`` (`health.degrade_plan`). Both keep the kernels. Nothing
  else degrades: a kernel that fails to build or launch, or a
  `DispatchError` the retune did not cure, is a failure, never a quiet
  run of the plain version. A rung taken shows in `CpdResponse.degraded`
  and ``stats()["degraded_dispatches"]`` / ``["plan_evictions"]``;
* a bucket that still fails is bisected: each member re-runs alone, and
  one that fails alone too is quarantined with a structured error while
  its mates are served;
* ``guard=True`` (default) runs the health guards (`core.health`): a
  tenant whose iterates go non-finite is rolled back to its last good
  state and quarantined inside its bucket;
* per-request deadlines (``deadline_s``) and the ``max_wait_s`` flush of
  a partial bucket bound the tail latency.

A poisoned CUDA context (an illegal address: a sticky error every later
call returns) is not a request's failure: the service raises
`faults.DeviceLost` from `process` and `wait`, and its worker stops.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import alto, batched, faults, shapeclass
from repro_torch.core import autotune as autotune_mod
from repro_torch.core import cpals as cpals_mod
from repro_torch.core import cpapr as cpapr_mod
from repro_torch.core import health as health_mod
from repro_torch.core import ingest as ingest_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import stream as stream_mod
from repro_torch.device import resolve_device
from repro_torch.sparse.tensor import SparseTensor


@dataclasses.dataclass
class CpdRequest:
    """One tenant's admitted submission."""
    request_id: int
    x: SparseTensor
    sc: shapeclass.ShapeClass
    seed: int
    submitted_at: float
    deadline_s: float | None = None


@dataclasses.dataclass
class DeltaRequest:
    """An incremental update against a previously served result."""
    request_id: int
    base_id: int                   # request id of the retained base result
    coords: np.ndarray
    values: np.ndarray
    policy: str
    submitted_at: float
    deadline_s: float | None = None


@dataclasses.dataclass
class CpdResponse:
    request_id: int
    sc: shapeclass.ShapeClass | None
    result: object                 # CpalsResult | CpaprResult | None
    latency_s: float               # submit → result wall clock
    bucket_size: int               # real tenants in the bucket served with
    # ``error`` is None on success; a quarantined or expired request gets
    # the reason (its ``result`` may still be the last good iterate, or
    # None when nothing was computed). ``degraded`` marks a result served
    # through a ladder rung (halved chunks, an evicted stored plan) or
    # rolled back; ``retries`` counts the transient-fault re-attempts made
    # for it.
    error: str | None = None
    degraded: bool = False
    retries: int = 0

    @property
    def ok(self) -> bool:
        return self.error is None


class CpdService:
    """Request queues over the shape-class batched layer, on ``device``
    (default ``cuda``; ``"cpu"`` runs the plain versions).

    ``submit`` is thread-safe and cheap (classify, enqueue); `process`
    drains every class queue bucket by bucket. ``capacity`` fixes each
    bucket's stacked width: partial buckets are filled with inactive
    slots, so every bucket of a class has one shape.

    Run it caller-driven (`process`) or as a runtime: `serve` starts a
    daemon worker that drains continuously, `wait` blocks until a
    request's response lands.
    """

    def __init__(self, rank: int, algorithm: str = "cp_als", *,
                 capacity: int = 8, n_partitions: int | None = None,
                 n_iters: int = 25, tol: float = 1e-4,
                 tune: str = "auto", backend: str | None = None,
                 retain_results: int = 128, guard: bool = True,
                 max_wait_s: float | None = None, max_retries: int = 2,
                 retry_base_s: float = 0.02, device=None):
        if algorithm not in ("cp_als", "cp_apr"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.device = resolve_device(device)
        self.rank = int(rank)
        self.algorithm = algorithm
        self.capacity = int(capacity)
        self.n_partitions = (shapeclass.DEFAULT_PARTITIONS
                             if n_partitions is None else int(n_partitions))
        self.n_iters = int(n_iters)
        self.tol = float(tol)
        self.tune = tune
        self.backend = backend
        self.guard = bool(guard)
        # A partial bucket whose oldest request waited this long flushes.
        self.max_wait_s = None if max_wait_s is None else float(max_wait_s)
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self._lock = threading.Lock()
        self._queues: dict[shapeclass.ShapeClass, collections.deque] = {}
        self._plans: dict[shapeclass.ShapeClass,
                          plan_mod.ExecutionPlan] = {}
        self._next_id = 0
        self._latencies: list[float] = []
        self._tenants_done = 0
        self._buckets_run = 0
        self._busy_s = 0.0
        # rid -> (x | None, AltoTensor | None, result, sc), LRU-bounded,
        # for `submit_delta`. The tensor slot starts None (the bucket ran
        # on the class-padded shape, which a delta must not inherit) and
        # is built at the tenant's dims on the first delta; a delta's
        # response retains its merged tensor, so chains never rebuild.
        self.retain_results = int(retain_results)
        self._retained: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._delta_queue: collections.deque = collections.deque()
        self._deltas_done = 0
        # Resilience counters (under self._lock; see stats()).
        self._retries = 0
        self._backoff_s = 0.0
        self._quarantined_tenants = 0
        self._degraded_dispatches = 0
        self._plan_evictions = 0
        self._deadline_expired = 0
        self._errors = 0
        # Completed responses for wait(): a bounded mailbox, popped on
        # delivery, notified under the service lock.
        self._responses: "collections.OrderedDict[int, CpdResponse]" = \
            collections.OrderedDict()
        self._resp_cond = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._worker_recoveries = 0
        self._fatal: faults.DeviceLost | None = None

    # -- admission --------------------------------------------------------

    def submit(self, x: SparseTensor, seed: int = 0, *,
               deadline_s: float | None = None) -> int:
        """Admit one COO submission; returns its request id. Classifying
        is metadata only, so admission never waits on a bucket in flight.
        A request still queued past ``deadline_s`` seconds is answered
        with a structured error instead of late."""
        sc = shapeclass.classify(x, self.rank,
                                 n_partitions=self.n_partitions)
        req = CpdRequest(request_id=-1, x=x, sc=sc, seed=int(seed),
                         submitted_at=time.perf_counter(),
                         deadline_s=deadline_s)
        with self._lock:
            req.request_id = self._next_id
            self._next_id += 1
            self._queues.setdefault(sc, collections.deque()).append(req)
        return req.request_id

    def submit_delta(self, base_id: int, coords, values,
                     policy: str = "sum", *,
                     deadline_s: float | None = None) -> int:
        """Admit a COO delta against a retained result (see
        ``retain_results``); returns the new request id. Deltas skip
        bucketing: `process` serves each alone, appended with
        `ingest.append_delta` and warm-started from the base's factors."""
        if policy not in ingest_mod.POLICIES:
            raise ValueError(f"policy {policy!r}: expected one of "
                             f"{ingest_mod.POLICIES}")
        coords = np.asarray(coords, dtype=np.int32)
        values = np.asarray(values)
        req = DeltaRequest(request_id=-1, base_id=int(base_id),
                           coords=coords, values=values, policy=policy,
                           submitted_at=time.perf_counter(),
                           deadline_s=deadline_s)
        with self._lock:
            if int(base_id) not in self._retained:
                raise KeyError(f"request {base_id} is not retained "
                               f"(never served, or aged out of the "
                               f"{self.retain_results}-entry LRU)")
            req.request_id = self._next_id
            self._next_id += 1
            self._delta_queue.append(req)
        return req.request_id

    def pending(self) -> int:
        with self._lock:
            return (sum(len(q) for q in self._queues.values())
                    + len(self._delta_queue))

    def shape_classes(self) -> list[shapeclass.ShapeClass]:
        with self._lock:
            return list(self._queues)

    # -- worker loop ------------------------------------------------------

    def _on_device(self):
        """The service's card as the current device (the worker's thread
        and `process`'s caller launch on it); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def serve(self, poll_s: float = 0.005) -> None:
        """Start the daemon worker that drains the queues (full buckets at
        once, partial ones past ``max_wait_s``); a live worker is left
        alone. An exception that escapes a request path is counted
        (``worker_recoveries``) and the loop goes on; `faults.DeviceLost`
        stops it."""
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._stop_evt = threading.Event()
            self._worker = threading.Thread(
                target=self._worker_loop, args=(float(poll_s),),
                name="cpd-serve-worker", daemon=True)
            self._worker.start()

    def _worker_loop(self, poll_s: float) -> None:
        stop = self._stop_evt
        try:
            while not stop.is_set():
                try:
                    served = self.process(flush=False)
                except faults.DeviceLost:
                    raise
                except Exception:
                    # Request paths turn failures into responses, so this
                    # is a runtime fault: count it, keep serving.
                    with self._lock:
                        self._worker_recoveries += 1
                    served = []
                if not served:
                    stop.wait(poll_s)
            # Final drain: shutdown(wait=True) leaves no admitted request
            # unanswered, partial buckets included.
            try:
                self.process(flush=True)
            except faults.DeviceLost:
                raise
            except Exception:
                with self._lock:
                    self._worker_recoveries += 1
        except faults.DeviceLost as exc:
            with self._resp_cond:
                self._fatal = exc
                self._resp_cond.notify_all()

    def shutdown(self, wait: bool = True, timeout: float = 60.0) -> None:
        """Stop the worker; ``wait=True`` joins it after it drained what
        is still queued."""
        with self._lock:
            worker = self._worker
        if worker is None:
            return
        self._stop_evt.set()
        if wait:
            worker.join(timeout)
        with self._lock:
            if self._worker is worker and not worker.is_alive():
                self._worker = None

    @property
    def serving(self) -> bool:
        with self._lock:
            return self._worker is not None and self._worker.is_alive()

    def wait(self, request_id: int,
             timeout: float | None = None) -> CpdResponse:
        """Block until ``request_id``'s response lands and return it.
        Raises TimeoutError past ``timeout`` seconds, and
        `faults.DeviceLost` once the worker found the context poisoned."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._resp_cond:
            while request_id not in self._responses:
                if self._fatal is not None:
                    raise faults.DeviceLost(str(self._fatal)) \
                        from self._fatal
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"request {request_id} not served "
                                       f"within {timeout}s")
                self._resp_cond.wait(remaining)
            return self._responses.pop(request_id)

    def _deliver(self, responses: Sequence[CpdResponse]) -> None:
        if not responses:
            return
        with self._resp_cond:
            for r in responses:
                self._responses[r.request_id] = r
            cap = max(64, 4 * self.retain_results)
            while len(self._responses) > cap:
                self._responses.popitem(last=False)
            self._resp_cond.notify_all()

    # -- class plan (store-backed, shared by every bucket of the class) ---

    def _class_plan(self, sc, at_canonical=None):
        with self._lock:
            plan = self._plans.get(sc)
        if plan is not None:
            return plan
        plan = plan_mod.make_class_plan(
            sc, backend=self.backend, device=self.device, tune=self.tune,
            tune_objective=self._objective(), at=at_canonical)
        with self._lock:
            return self._plans.setdefault(sc, plan)

    def _objective(self) -> str:
        return "phi" if self.algorithm == "cp_apr" else "mttkrp"

    # -- the resilience ladder --------------------------------------------

    def _check_device(self, exc: BaseException) -> None:
        """Raise `faults.DeviceLost` when ``exc`` left the service's
        CUDA context poisoned: nothing on it can be retried."""
        if isinstance(exc, faults.DeviceLost):
            raise exc
        lost = health_mod.device_lost(self.device)
        if lost is not None:
            raise faults.DeviceLost(
                f"{self.device} lost ({lost}) after: {exc}") from exc

    def _with_ladder(self, sc, run: Callable[[], object]):
        """``run()`` under the recovery ladder: ``(out, retries,
        degraded)``, or the last failure raised when out of rungs.

        Per failure, in order: (1) a transient fault
        (`faults.is_transient`) is retried with exponential backoff, up to
        ``max_retries``; (2) a `faults.DispatchError` under ``tune`` other
        than "off" evicts the class's stored plan and retunes
        (``tune="off"``), once; (3) `health.degrade_plan` swaps the class
        plan (halved ``chunk_m`` on a streaming plan's allocator failure).
        ``run`` reads the class plan anew each attempt, so a swap takes
        effect."""
        retries = 0
        degraded = False
        evicted = False
        while True:
            try:
                return run(), retries, degraded
            except Exception as exc:  # noqa: BLE001 — the ladder sorts them
                self._check_device(exc)
                if faults.is_transient(exc) and retries < self.max_retries:
                    retries += 1
                    delay = self.retry_base_s * (2 ** (retries - 1))
                    with self._lock:
                        self._retries += 1
                        self._backoff_s += delay
                    time.sleep(delay)
                    continue
                with self._lock:
                    plan = self._plans.get(sc) if sc is not None else None
                if plan is None:
                    raise
                if (isinstance(exc, faults.DispatchError) and not evicted
                        and self.tune != "off"):
                    self._evict_class_plan(sc, plan)
                    evicted = degraded = True
                    continue
                new_plan, _why = health_mod.degrade_plan(plan, exc)
                if new_plan is None:
                    raise
                with self._lock:
                    self._plans[sc] = new_plan
                    self._degraded_dispatches += 1
                degraded = True

    def _evict_class_plan(self, sc, failed_plan) -> None:
        """The stored (measured) plan failed at dispatch: drop its store
        entry, so no later process trusts it, and take the static plan."""
        key = autotune_mod.class_plan_key(sc, failed_plan.backend,
                                          device=self.device,
                                          objective=self._objective())
        autotune_mod.evict(key)
        fresh = plan_mod.make_class_plan(sc, backend=self.backend,
                                         device=self.device, tune="off")
        with self._lock:
            self._plans[sc] = fresh
            self._plan_evictions += 1

    def _error_response(self, req, sc, message: str,
                        result=None) -> CpdResponse:
        with self._lock:
            self._errors += 1
        return CpdResponse(request_id=req.request_id, sc=sc,
                           result=result,
                           latency_s=time.perf_counter() - req.submitted_at,
                           bucket_size=0, error=message)

    def _expired(self, req) -> bool:
        return (req.deadline_s is not None
                and time.perf_counter() - req.submitted_at > req.deadline_s)

    def _expired_response(self, req, sc) -> CpdResponse:
        with self._lock:
            self._deadline_expired += 1
        return self._error_response(
            req, sc, f"deadline expired: waited "
                     f"{time.perf_counter() - req.submitted_at:.3f}s of "
                     f"{req.deadline_s:.3f}s budget")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the heavy path ---------------------------------------------------

    def _canonical(self, x: SparseTensor, sc):
        """pad → device ingest → canonical meta. The canonical meta pins
        the fiber reuse, so the data-dependent count is skipped."""
        at = alto.build_device(shapeclass.pad_to_class(x, sc),
                               n_partitions=sc.n_partitions,
                               compute_reuse=False, device=self.device)
        return shapeclass.canonicalize_tensor(at, sc)

    def _run_bucket(self, sc, reqs: Sequence[CpdRequest]) -> list[CpdResponse]:
        t0 = time.perf_counter()
        # A class never seen may tune (a store miss under tune="auto"):
        # the tuner measures on the first member's canonical tensor.
        at0 = None
        with self._lock:
            plan = self._plans.get(sc)
        if plan is None:
            at0 = self._canonical(reqs[0].x, sc)
            plan = self._class_plan(sc, at_canonical=at0)
        ats, views, rdims, seeds = [], [], [], []
        for j, req in enumerate(reqs):
            at = at0 if j == 0 and at0 is not None else \
                self._canonical(req.x, sc)
            ats.append(at)
            views.append(plan_mod.build_views(at, plan))
            rdims.append(req.x.dims)
            seeds.append(req.seed)
        if self.algorithm == "cp_als":
            out = batched.batched_cp_als(
                ats, views, rdims, self.rank, plan=plan,
                n_iters=self.n_iters, tol=self.tol, seeds=seeds,
                capacity=self.capacity, guard=self.guard)
        else:
            out = batched.batched_cp_apr(
                ats, views, rdims, self.rank, plan=plan,
                params=cpapr_mod.CpaprParams(k_max=self.n_iters,
                                             tau=self.tol),
                seeds=seeds, capacity=self.capacity, guard=self.guard)
        self._sync()
        done = time.perf_counter()
        quarantined = out.quarantined or [False] * len(reqs)
        responses = []
        for req, result, quar in zip(reqs, out.results, quarantined):
            # A quarantined slot went non-finite mid-solve and was rolled
            # back: its result is the last good iterate, and only it is
            # affected (the bucket's slots never mix).
            err = ("quarantined: non-finite update detected; result is "
                   "the last good iterate") if quar else None
            responses.append(CpdResponse(
                request_id=req.request_id, sc=sc, result=result,
                latency_s=done - req.submitted_at, bucket_size=len(reqs),
                error=err, degraded=bool(quar)))
        n_quar = sum(bool(q) for q in quarantined)
        with self._lock:
            self._latencies.extend(r.latency_s for r in responses)
            self._tenants_done += len(responses)
            self._buckets_run += 1
            self._busy_s += done - t0
            self._quarantined_tenants += n_quar
            self._errors += n_quar
            for req, result in zip(reqs, out.results):
                self._retain_locked(req.request_id,
                                    (req.x, None, result, sc))
        return responses

    def _serve_bucket(self, sc,
                      reqs: Sequence[CpdRequest]) -> list[CpdResponse]:
        """Deadline triage → the bucket under the ladder → on failure,
        bisection to solo re-runs."""
        live, responses = [], []
        for req in reqs:
            if self._expired(req):
                responses.append(self._expired_response(req, sc))
            else:
                live.append(req)
        if not live:
            return responses
        try:
            served, retries, degraded = self._with_ladder(
                sc, lambda: self._run_bucket(sc, live))
            for r in served:
                r.retries += retries
                r.degraded = r.degraded or degraded
            responses.extend(served)
        except faults.DeviceLost:
            raise
        except Exception as exc:  # noqa: BLE001 — bisect, don't crash
            # Beyond the ladder: each member re-runs alone, so one
            # poisoned tenant cannot take its mates' answers down.
            for req in live:
                responses.append(self._serve_solo(sc, req, cause=exc))
        return responses

    def _serve_solo(self, sc, req: CpdRequest,
                    cause: BaseException) -> CpdResponse:
        """Bisection: one member of a failed bucket alone, under the
        ladder again (the failure may have been a mate's). One that fails
        alone too is quarantined with both failures in its error."""
        try:
            served, retries, degraded = self._with_ladder(
                sc, lambda: self._run_bucket(sc, [req]))
        except faults.DeviceLost:
            raise
        except Exception as solo_exc:  # noqa: BLE001 — quarantine
            with self._lock:
                self._quarantined_tenants += 1
            return self._error_response(
                req, sc, f"quarantined after repeated failures "
                         f"(bucket: {cause}; solo: {solo_exc})")
        resp = served[0]
        resp.retries += retries
        resp.degraded = resp.degraded or degraded
        return resp

    def _retain_locked(self, rid: int, entry: tuple) -> None:
        self._retained[rid] = entry
        while len(self._retained) > max(1, self.retain_results):
            self._retained.popitem(last=False)

    def _run_delta(self, req: DeltaRequest) -> CpdResponse:
        t0 = time.perf_counter()
        with self._lock:
            x, at, result, sc = self._retained[req.base_id]
        if at is None:
            # First delta on a bucket-served base: its tensor at its own
            # dims, built once.
            at = alto.build_device(x, n_partitions=self.n_partitions,
                                   compute_reuse=False, device=self.device)
            with self._lock:
                if req.base_id in self._retained:
                    self._retained[req.base_id] = (x, at, result, sc)
        new_at = ingest_mod.append_delta(at, req.coords, req.values,
                                         policy=req.policy)
        plan = (None if self.backend is None
                else plan_mod.plan_for(new_at, self.rank,
                                       backend=self.backend))
        if self.algorithm == "cp_als":
            res = cpals_mod.cp_als(new_at, self.rank, n_iters=self.n_iters,
                                   tol=self.tol, warm_start=result,
                                   guard=self.guard, plan=plan)
        else:
            res = cpapr_mod.cp_apr(
                new_at, self.rank,
                params=cpapr_mod.CpaprParams(k_max=self.n_iters,
                                             tau=self.tol),
                warm_start=result, guard=self.guard, plan=plan)
        self._sync()
        done = time.perf_counter()
        resp = CpdResponse(request_id=req.request_id, sc=sc, result=res,
                           latency_s=done - req.submitted_at,
                           bucket_size=1)
        if res.health is not None and res.health.rolled_back:
            resp.error = f"quarantined: {res.health.reason}"
            resp.degraded = True
            with self._lock:
                self._quarantined_tenants += 1
                self._errors += 1
        with self._lock:
            self._latencies.append(resp.latency_s)
            self._deltas_done += 1
            self._busy_s += done - t0
            self._retain_locked(req.request_id, (None, new_at, res, sc))
        return resp

    def _serve_delta(self, req: DeltaRequest) -> CpdResponse:
        """Deadline triage and transient retry. The merge never writes the
        retained base tensor, so a failure mid-delta leaves the base
        serviceable: the error invites a clean resubmit."""
        if self._expired(req):
            return self._expired_response(req, self._delta_sc(req))
        try:
            resp, retries, degraded = self._with_ladder(
                None, lambda: self._run_delta(req))
        except faults.DeviceLost:
            raise
        except KeyError as exc:
            return self._error_response(req, None,
                                        f"base result gone: {exc}")
        except Exception as exc:  # noqa: BLE001 — structured error
            return self._error_response(
                req, self._delta_sc(req),
                f"delta failed (base retained, resubmit is safe): {exc}")
        resp.retries += retries
        resp.degraded = resp.degraded or degraded
        return resp

    def _delta_sc(self, req: DeltaRequest):
        """The base's shape class, for a delta's error response (None once
        the base aged out)."""
        with self._lock:
            entry = self._retained.get(req.base_id)
        return entry[3] if entry is not None else None

    def process(self, flush: bool = True) -> list[CpdResponse]:
        """Drain the queues: deltas first, then full buckets, and partial
        ones if ``flush`` or once their oldest request waited
        ``max_wait_s``. Every admitted request gets exactly one response;
        failures come back as structured errors, `faults.DeviceLost`
        excepted."""
        responses: list[CpdResponse] = []
        with self._on_device():
            while True:
                with self._lock:
                    dreq = (self._delta_queue.popleft()
                            if self._delta_queue else None)
                if dreq is None:
                    break
                responses.append(self._serve_delta(dreq))
            while True:
                now = time.perf_counter()
                with self._lock:
                    batch_ = None
                    for sc, q in self._queues.items():
                        ready = len(q) >= self.capacity or (flush
                                                            and bool(q))
                        if (not ready and q and self.max_wait_s is not None
                                and now - q[0].submitted_at
                                >= self.max_wait_s):
                            ready = True          # deadline-aware flush
                        if ready:
                            n = min(len(q), self.capacity)
                            batch_ = (sc, [q.popleft() for _ in range(n)])
                            break
                    for sc in [sc for sc, q in self._queues.items()
                               if not q]:
                        del self._queues[sc]
                if batch_ is None:
                    break
                responses.extend(self._serve_bucket(*batch_))
        self._deliver(responses)
        return responses

    # -- observability ----------------------------------------------------

    def stats(self) -> dict:
        """Serving and resilience counters, under the JAX package's keys.
        ``ingest_traces`` counts the distinct shape keys the device build,
        view and merge ran (`alto.device_ingest_traces`), ``sweep_traces``
        the batched set-ups per algorithm (`batched.sweep_traces`): the
        port's counterparts of the JAX package's jit traces.
        ``tenants_per_s`` is tenants (and deltas) served per second of
        busy time. ``degraded_dispatches`` counts the class plans
        `health.degrade_plan` softened (halved ``chunk_m``), never a swap
        of the kernels for their plain versions."""
        integ = stream_mod.integrity_stats()
        with self._lock:
            lats = sorted(self._latencies)
            n = len(lats)
            done, buckets, busy = (self._tenants_done, self._buckets_run,
                                   self._busy_s)
            classes = len(self._plans)
            deltas = self._deltas_done
            resilience = {
                "retries": self._retries,
                "backoff_s": self._backoff_s,
                "quarantined_tenants": self._quarantined_tenants,
                "degraded_dispatches": self._degraded_dispatches,
                "plan_evictions": self._plan_evictions,
                "deadline_expired": self._deadline_expired,
                "errors": self._errors,
                "worker_alive": (self._worker is not None
                                 and self._worker.is_alive()),
                "worker_recoveries": self._worker_recoveries,
            }

        def pct(p):
            return lats[min(n - 1, int(p * n))] if n else 0.0

        return {
            "tenants_done": done,
            "deltas_done": deltas,
            "buckets_run": buckets,
            "shape_classes": classes,
            "tenants_per_s": (done / busy) if busy > 0 else 0.0,
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "ingest_traces": alto.device_ingest_traces(),
            "sweep_traces": batched.sweep_traces(),
            "checksum_failures": integ["checksum_failures"],
            "stream_rebuilds": integ["rebuilds"],
            **resilience,
        }


# ---------------------------------------------------------------------------
# CLI demo: synthetic tenants with deliberately scattered shapes
# ---------------------------------------------------------------------------

def main(argv=None):
    from repro_torch.sparse.synthetic import uniform_tensor

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=12)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--algorithm", default="cp_als",
                    choices=["cp_als", "cp_apr"])
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--worker", action="store_true",
                    help="serve through the background worker instead of "
                         "a caller-driven process()")
    ap.add_argument("--max-wait-s", type=float, default=0.05,
                    help="partial-bucket flush budget (worker mode)")
    ap.add_argument("--tune", default="auto",
                    choices=["off", "auto", "force", "search"],
                    help="plan selection: static, store-backed tuner, or "
                         "budgeted search")
    args = ap.parse_args(argv)

    svc = CpdService(args.rank, args.algorithm, capacity=args.capacity,
                     n_iters=args.iters, tune=args.tune, device=args.device,
                     max_wait_s=(args.max_wait_s if args.worker else None))
    rng = np.random.default_rng(args.seed)
    shapes = [(9, 7, 5), (12, 6, 8), (16, 8, 8), (30, 20, 10)]
    rids = []
    if args.worker:
        svc.serve()
    for t in range(args.tenants):
        dims = shapes[t % len(shapes)]
        nnz = int(rng.integers(60, 128))
        x = uniform_tensor(dims, nnz, seed=args.seed + t,
                           count_data=(args.algorithm == "cp_apr"))
        rids.append(svc.submit(x, seed=t))
    print(f"admitted {args.tenants} tenants on {svc.device}")
    t0 = time.perf_counter()
    if args.worker:
        responses = [svc.wait(rid, timeout=300.0) for rid in rids]
        svc.shutdown()
    else:
        responses = svc.process()
    dt = time.perf_counter() - t0
    s = svc.stats()
    print(f"served {len(responses)} tenants in {dt:.2f}s "
          f"({s['tenants_per_s']:.1f} tenants/s busy-rate), "
          f"{s['buckets_run']} buckets, {s['shape_classes']} classes")
    print(f"latency p50 {s['latency_p50_s']*1e3:.0f} ms, "
          f"p99 {s['latency_p99_s']*1e3:.0f} ms")
    print(f"ingest shape keys {s['ingest_traces']}, batched set-ups "
          f"{s['sweep_traces']}")
    print(f"resilience: retries {s['retries']}, quarantined "
          f"{s['quarantined_tenants']}, degraded {s['degraded_dispatches']}, "
          f"errors {s['errors']}")
    return responses


if __name__ == "__main__":
    main()
