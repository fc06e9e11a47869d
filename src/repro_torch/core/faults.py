"""Deterministic fault injection for the serving, streaming and ingest stack.

Every recoverable failure the runtime claims to survive has a named site
on the real hot path; a test (or an operator, through
``$REPRO_TORCH_FAULTS``) arms a site to fire a fixed number of times.
The sites, their fault classes and the arming API are the JAX package's.

* **Deterministic.** A site fires on its first ``times`` hits after
  ``after`` hits let through, then goes quiet: no randomness, no clocks.
* **Cheap when disarmed.** `fire` and `inject` read one module-global
  bool when nothing is armed.
* **Eager.** The port runs eagerly, so a site fires on every call that
  reaches it, ``ops.exec`` included (the JAX package's in-core sites fire
  at trace time only).
* **Scoped arming.** Tests use `injected`; operators use
  ``REPRO_TORCH_FAULTS="site[:times][,site...]"`` (read at import;
  `configure` re-reads). Unknown site names raise.

Injected exceptions are instances of what the real failure raises, so the
recovery code cannot special-case injection: I/O sites raise an `OSError`,
OOM sites a `torch.OutOfMemoryError` (what the CUDA caching allocator
raises), dispatch sites a `DispatchError`, corruption sites a
`ValueError`. NaN sites raise nothing: the caller poisons its own
state with what `fire` returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import torch

ENV = "REPRO_TORCH_FAULTS"

# site name -> fault class, the JAX package's table.
SITES: dict[str, str] = {
    "stream.memmap_load": "io",        # from_memmap: spilled stream read
    "stream.chunk_io": "io",           # ops._chunks: a chunk's copy starts
    "stream.respill": "interrupt",     # _respill: between tmps and replace
    "stream.checksum": "corrupt",      # from_memmap: stored checksum flips
    "ops.chunk_oom": "oom",            # chunked executors: per chunk
    "ops.exec": "dispatch",            # in-core kernel wrappers, every call
    "plan.dispatch": "dispatch",       # execute_mttkrp / execute_phi
    "autotune.store": "corrupt",       # load_store: plan-store JSON read
    "ingest.merge": "interrupt",       # _append: before the merge
    "cpals.nan": "nan",                # poison a CP-ALS sweep's factors
    "cpapr.nan": "nan",                # poison a CP-APR mode update
    "batched.nan": "nan",              # poison one tenant slot in a bucket
    "batched.sweep": "interrupt",      # batched drivers: before each sweep
    "views.build": "io",               # view / host-stream cache build
}


class DispatchError(RuntimeError):
    """A plan the kernels cannot dispatch, raised by the ``plan.dispatch``
    and ``ops.exec`` sites. The service answers it by evicting the class's
    stored plan and retuning, once; past that it is a failure like any
    other. (A stored tiling the kernels cannot take never gets this far:
    `autotune.deserialize_plan` reads it as a store miss.)"""


class DeviceLost(RuntimeError):
    """The CUDA context is poisoned (an illegal address or another sticky
    error): no retry, rung or bisection can serve a request on it."""


class InjectedFault(RuntimeError):
    """Base of the raised injections that are no `OSError`, `ValueError`
    or `torch.OutOfMemoryError` of their own."""


class InjectedIOError(OSError):
    """Transient I/O failure (torn page, vanished file, EIO)."""


class InjectedResourceExhausted(torch.OutOfMemoryError):
    """An allocator failure, of the type the CUDA allocator raises."""

    def __init__(self, site: str):
        super().__init__(f"CUDA out of memory: injected at {site}")


class InjectedInterrupt(InjectedFault):
    """A program killed mid-flight (respill, merge, sweep)."""


class InjectedDispatchError(InjectedFault, DispatchError):
    """A plan whose kernels cannot be dispatched."""


class InjectedCorruption(ValueError):
    """Corrupted serialized state (mangled JSON, flipped bits): a
    `ValueError`, so the real corruption handlers catch it."""


def _exception_for(site: str) -> BaseException:
    kind = SITES[site]
    if kind == "io":
        return InjectedIOError(f"injected I/O error at {site}")
    if kind == "oom":
        return InjectedResourceExhausted(site)
    if kind == "dispatch":
        return InjectedDispatchError(f"injected dispatch failure at {site}")
    if kind == "corrupt":
        return InjectedCorruption(f"injected corruption at {site}")
    return InjectedInterrupt(f"injected interrupt at {site}")


def is_injected(exc: BaseException) -> bool:
    return isinstance(exc, (InjectedFault, InjectedIOError,
                            InjectedResourceExhausted, InjectedCorruption))


def is_transient(exc: BaseException) -> bool:
    """Worth a blind retry? I/O errors and allocator exhaustion are: the
    next attempt reads a healthy page or finds memory freed. Wrong plans
    and poisoned values are not."""
    return isinstance(exc, (OSError, torch.OutOfMemoryError))


@dataclasses.dataclass
class _Arm:
    remaining: int
    data: dict
    skip: int = 0          # hits to let through before the first fire


_LOCK = threading.Lock()
_ARMED: dict[str, _Arm] = {}
_FIRED: dict[str, int] = {}
# Read unlocked by fire()/inject(); a stale read only delays a newly
# armed fault by one call on another thread (firing re-checks under the
# lock).
_ENABLED = False


def _refresh_enabled_locked() -> None:
    global _ENABLED
    _ENABLED = bool(_ARMED)


def arm(site: str, times: int = 1, data: dict | None = None,
        after: int = 0) -> None:
    """Arm ``site`` to fire on its next ``times`` hits, after letting
    ``after`` hits through. ``data`` rides along to the caller of `fire`
    (e.g. which tenant slot to poison, with what value)."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; known: "
                         f"{sorted(SITES)}")
    if times < 1:
        raise ValueError(f"times must be >= 1, got {times}")
    if after < 0:
        raise ValueError(f"after must be >= 0, got {after}")
    with _LOCK:
        _ARMED[site] = _Arm(remaining=int(times), data=dict(data or {}),
                            skip=int(after))
        _refresh_enabled_locked()


def disarm(site: str) -> None:
    with _LOCK:
        _ARMED.pop(site, None)
        _refresh_enabled_locked()


def reset() -> None:
    """Disarm everything and zero the fired counters."""
    with _LOCK:
        _ARMED.clear()
        _FIRED.clear()
        _refresh_enabled_locked()


def armed(site: str) -> bool:
    if not _ENABLED:
        return False
    with _LOCK:
        return site in _ARMED


def fired() -> dict[str, int]:
    """Times each site fired since `reset`."""
    with _LOCK:
        return dict(_FIRED)


def fire(site: str) -> dict | None:
    """Hot-path hook: the arm's ``data`` if ``site`` fires now, else
    None."""
    if not _ENABLED:
        return None
    with _LOCK:
        a = _ARMED.get(site)
        if a is None:
            return None
        if a.skip > 0:
            a.skip -= 1
            return None
        a.remaining -= 1
        if a.remaining <= 0:
            del _ARMED[site]
            _refresh_enabled_locked()
        _FIRED[site] = _FIRED.get(site, 0) + 1
        return dict(a.data)


def inject(site: str) -> None:
    """Hot-path hook for raising sites: raises the site's exception if it
    fires now."""
    if not _ENABLED:
        return
    if fire(site) is not None:
        raise _exception_for(site)


@contextlib.contextmanager
def injected(site: str, times: int = 1, data: dict | None = None,
             after: int = 0):
    """Arm ``site`` for the ``with`` block; disarmed on exit."""
    arm(site, times=times, data=data, after=after)
    try:
        yield
    finally:
        disarm(site)


def configure(spec: str | None) -> None:
    """Replace the armed set from a spec string: comma- or
    semicolon-separated ``site`` or ``site:times`` entries. Empty or None
    clears; unknown sites raise."""
    reset()
    if not spec:
        return
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, times = entry.partition(":")
        arm(site.strip(), times=int(times) if times else 1)


def configure_env() -> None:
    """(Re-)read ``$REPRO_TORCH_FAULTS``; called once at import."""
    configure(os.environ.get(ENV))


configure_env()
