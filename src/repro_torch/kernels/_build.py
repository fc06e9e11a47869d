"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with `ctypes`. The build
runs at first use, from the sources in this checkout only, into
``build/repro_torch/`` at the repository root; a library's file name
carries a digest of its sources and flags, so an edited source is rebuilt;
nvcc's output (the ptxas report) is kept beside it as ``<name>.log``.
All missing libraries are compiled at once, one ``nvcc`` process each.
There is no prebuilt binary and no fallback when ``nvcc`` fails.

Every C entry returns ``cudaGetLastError()``; `check` raises when it is
not 0. Launch counts: each kernel wrapper adds one to `LAUNCHES[name]`,
and the length of the stream it was launched on (nonzeros, or pieces for
the fix-up) to `ELEMENTS[name]`, where it launches its kernel; a counter
of `COUNTERS` counts the same way what is not a kernel (K7's window
passes: one a launch, ⌈T / window⌉ elements; K7's launches in a CTA
wider than the plan's: one each, its threads as elements; the pull
through a caller's order: one each, the Temp rows it left out as
elements, a bucket's padding pieces counted as pulled); each plain
version adds one to `PLAIN_ON_CUDA[name]` when it runs on a CUDA tensor,
so a caller can show that its main path went through the kernels and
never through a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signatures: library -> {function: argtypes}. All return int.
_ALTO = [_P, _P, _I, _I, _I, _I, _I]        # factor ptrs, runs table, ...
_PHI = [_P, _P, _F]                          # B, Π or null, eps
_TENANTS = [_I, _P]                          # tenant count, strides or null
SIGNATURES = {
    "mttkrp_oriented": {
        "alto_carry_runs": _ALTO + [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                                    _I, _P, _P, _P] + _TENANTS + [_P],
        "alto_carry_fixup": [_P, _P, _L, _I, _I, _I, _I, _P, _I, _L, _P],
        "alto_oriented_partials": _ALTO + [_P, _P, _P, _P, _L, _L, _I, _I,
                                           _I, _I, _P] + _TENANTS + [_P],
        "alto_segment_split": [_P, _P, _L, _L, _I, _I, _I, _I, _I, _P, _P,
                               _P, _I, _P],
        "alto_carry_chunk": _ALTO + [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                                     _P, _P, _P, _P, _P, _I, _P, _P, _P],
    },
    "mttkrp": {
        "alto_recursive_partials": _ALTO + [_P, _P, _P, _P, _L, _L, _L, _I,
                                            _I, _I, _I, _I, _I, _P]
        + _TENANTS + [_P],
    },
    "delinearize": {
        "alto_delinearize": [_I, _I, _P, _P, _L, _I, _I, _P, _P],
        "alto_pi_rows": [_I, _I, _P, _P, _L, _P, _I, _I, _I, _P]
        + _TENANTS + [_P],
    },
    "phi_oriented": {
        "alto_phi_carry_runs": _ALTO + [_P, _P, _P] + _PHI + [
            _P, _L, _L, _I, _I, _P, _P, _P] + _TENANTS + [_P],
        "alto_phi_oriented_partials": _ALTO + [_P, _P, _P] + _PHI + [
            _P, _L, _L, _I, _P] + _TENANTS + [_P],
        "alto_phi_carry_chunk": _ALTO + [_P, _P, _P] + _PHI + [
            _P, _L, _L, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    },
    "cpapr_phi": {
        "alto_phi_partials": _ALTO + [_P, _P, _P] + _PHI + [
            _P, _L, _L, _L, _I, _I, _I, _I, _P] + _TENANTS + [_P],
        "alto_phi_smem_limit": [_P],
        "alto_phi_partials_max_threads": [_I, _P],
    },
}

KERNELS = ("carry_runs", "carry_fixup", "segment_split",
           "oriented_partials", "recursive_partials", "delinearize",
           "phi_carry_runs", "phi_oriented_partials", "phi_partials",
           "carry_chunk", "phi_carry_chunk", "pi_rows")
COUNTERS = ("phi_partials_passes", "phi_partials_wide",
            "pull_pieces_skipped")
LAUNCHES = dict.fromkeys(KERNELS + COUNTERS, 0)
ELEMENTS = dict.fromkeys(KERNELS + COUNTERS, 0)
PLAIN_ON_CUDA = dict.fromkeys(KERNELS, 0)
BUILD_LOG: dict[str, str] = {}     # library -> nvcc output (ptxas -v),
                                   # from this build or the one cached
BUILD_SECONDS: dict[str, float] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def count_launch(name: str, elements: int) -> None:
    with _LOCK:
        LAUNCHES[name] += 1
        ELEMENTS[name] += int(elements)


def count_plain(name: str, tensor) -> None:
    if tensor.device.type == "cuda":
        with _LOCK:
            PLAIN_ON_CUDA[name] += 1


def reset_counts() -> None:
    with _LOCK:
        for k in KERNELS + COUNTERS:
            LAUNCHES[k] = 0
            ELEMENTS[k] = 0
        for k in KERNELS:
            PLAIN_ON_CUDA[k] = 0


def counts() -> dict[str, dict[str, int]]:
    with _LOCK:
        return {"launches": dict(LAUNCHES), "elements": dict(ELEMENTS),
                "plain_on_cuda": dict(PLAIN_ON_CUDA)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str) -> pathlib.Path:
    """The nvcc output kept beside a built library, so a library loaded
    from an earlier build still has its ptxas report."""
    return _target(name).with_suffix(".log")


def build_all() -> dict[str, float]:
    """Compile every missing library at once (one nvcc each) and load all.
    Returns the seconds each build took (0.0 for a library already
    built)."""
    with _LOCK:
        missing = [n for n in SIGNATURES
                   if n not in _LIBS and not _target(n).exists()]
        procs = {}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            for name in missing:
                tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                BUILD_LOG[name] = out
                BUILD_SECONDS[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{name}:\n{out}")
                else:
                    _log_path(name).write_text(out)
                    os.replace(tmp, _target(name))
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, sigs in SIGNATURES.items():
            if name in _LIBS:
                continue
            if name not in BUILD_LOG and _log_path(name).exists():
                BUILD_LOG[name] = _log_path(name).read_text()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
            BUILD_SECONDS.setdefault(name, 0.0)
        return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every library on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
