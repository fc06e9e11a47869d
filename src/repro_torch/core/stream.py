"""Host-resident ALTO streams for out-of-core (chunked) execution.

The in-core oriented path (`core.views`) keeps one device-resident
row-sorted copy of the stream per (tensor, mode). When the padded stream
does not fit the device byte budget (`core.plan`'s streaming decision)
the same copy lives HERE instead, in host memory — pinned when the
tensor is on the card, or memory-mapped from disk after a spill — and
the chunked executors in `kernels.ops` copy block-aligned chunks of it
through two device buffers.

Contracts that make chunking bitwise-exact against the in-core carry
kernels:

* **Same element order.** `host_stream` builds the stream with
  `alto.oriented_view_device` — the extract and stable sort of the
  in-core view — on the tensor's device, then copies it to the host, so
  element k of the host stream is element k of the in-core view.
* **Same padding rule.** The stream is padded once to a multiple of
  `STREAM_ALIGN` with `ops.pad_sorted_stream`'s rule (replicated final
  row and words, zero values; an empty stream pads zero rows and words).
  ``STREAM_ALIGN`` (1024, the largest ``block_m``) is a multiple of every
  legal ``block_m``, and replicated padding is self-similar under
  truncation, so the prefix of length ``padded_len(block_m)`` is element
  for element the stream the in-core kernel scans at that ``block_m``.
* **Pinned, or staged.** An in-memory stream of a card-resident tensor
  lives in pinned host tensors, which the copy engine reads directly. A
  spilled stream is a memory map and cannot be pinned; the executors
  stage it through a pinned buffer one chunk at a time, never pinning
  (and so copying) the whole map.

Words are int32, the port's type; the spill writes them as uint32, as
the JAX package does, so the ``.npy`` files and their CRC (over bytes)
are the same in both packages.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import threading
import zlib

import numpy as np
import torch

from repro_torch.core import alto, faults
from repro_torch.core.alto import AltoMeta, AltoTensor, OrientedView
from repro_torch.device import resolve_device

# One alignment for every host stream: a multiple of every legal oriented
# block_m (powers of two up to plan.MAX_BLOCK_M). Must equal
# plan.MAX_BLOCK_M.
STREAM_ALIGN = 1024


class StreamIntegrityError(RuntimeError):
    """A spilled stream's content checksum does not match its payload: a
    torn multi-file write (a crash between `_respill`'s replaces) or
    corruption on disk. Raised at load time, so a wrong stream never
    reaches an executor; `load_or_rebuild` recovers."""


_INTEGRITY_LOCK = threading.Lock()
_INTEGRITY = {"checksum_failures": 0, "rebuilds": 0}


def integrity_stats() -> dict[str, int]:
    with _INTEGRITY_LOCK:
        return dict(_INTEGRITY)


def integrity_stats_clear() -> None:
    with _INTEGRITY_LOCK:
        for k in _INTEGRITY:
            _INTEGRITY[k] = 0


def _integrity_bump(counter: str) -> None:
    with _INTEGRITY_LOCK:
        _INTEGRITY[counter] += 1


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def stream_checksum(rows, words, values) -> int:
    """crc32 over the padded payload bytes (rows ‖ words ‖ values), numpy
    arrays or CPU tensors: equal to the JAX package's for equal bytes."""
    c = 0
    for a in (rows, words, values):
        c = zlib.crc32(np.ascontiguousarray(_np(a)).reshape(-1)
                       .view(np.uint8), c)
    return c & 0xFFFFFFFF


@dataclasses.dataclass
class HostStream:
    """One (tensor, mode) row-sorted stream in host memory, pre-padded.

    ``length`` is the real (partition-padded) stream length Mp; the
    tensors extend to the next `STREAM_ALIGN` multiple with replicated
    rows and words and zero values. ``rows`` (La,) int32 ascending,
    ``words`` (La, W) int32, ``values`` (La,) float32, all on the CPU:
    pinned, plain, or views of a memory map (``directory`` is then the
    spill directory).
    """
    meta: AltoMeta
    mode: int
    length: int
    rows: torch.Tensor
    words: torch.Tensor
    values: torch.Tensor
    # Checksum of the padded payload: None for in-memory streams, set on
    # spilled ones (verified by `from_memmap`).
    checksum: int | None = None
    directory: pathlib.Path | None = None

    def padded_len(self, block_m: int) -> int:
        """Stream length after `ops.pad_sorted_stream` at ``block_m``."""
        if STREAM_ALIGN % block_m:
            raise ValueError(f"block_m {block_m} does not divide "
                             f"STREAM_ALIGN {STREAM_ALIGN}")
        return -(-self.length // block_m) * block_m

    def chunk(self, start: int, stop: int):
        """Zero-copy (rows, words, values) views of [start, stop)."""
        return (self.rows[start:stop], self.words[start:stop],
                self.values[start:stop])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.words, self.values))

    @property
    def pinned(self) -> bool:
        return self.directory is None and self.rows.is_pinned()


def pad_host_stream(rows: torch.Tensor, words: torch.Tensor,
                    values: torch.Tensor, mult: int):
    """`ops.pad_sorted_stream`'s rule, kept here for the host stream:
    replicated final row and words with zero values; an empty stream
    pads one full ``mult`` block of zero rows and words."""
    M = words.shape[0]
    pad = mult if M == 0 else (-M) % mult
    if pad == 0:
        return rows, words, values
    if M == 0:
        pad_rows = rows.new_zeros(pad)
        pad_words = words.new_zeros((pad, words.shape[1]))
    else:
        pad_rows = rows[-1:].expand(pad)
        pad_words = words[-1:].expand(pad, words.shape[1])
    return (torch.cat([rows, pad_rows]), torch.cat([words, pad_words]),
            torch.cat([values, values.new_zeros(pad)]))


def _to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """``t`` copied to (pinned, if ``pin``) host memory, contiguous."""
    if not pin:
        return t.to("cpu").contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def _from_view(meta: AltoMeta, mode: int, rows, words, values,
               pin: bool) -> HostStream:
    length = words.shape[0]
    rows, words, values = pad_host_stream(rows, words, values, STREAM_ALIGN)
    return HostStream(meta=meta, mode=mode, length=length,
                      rows=_to_host(rows, pin), words=_to_host(words, pin),
                      values=_to_host(values, pin))


def host_stream(at: AltoTensor, mode: int) -> HostStream:
    """The host-resident oriented stream of ``(at, mode)``: the in-core
    view's sort (`alto.oriented_view_device`) on the tensor's device,
    padded once to `STREAM_ALIGN`, then copied to the host — to pinned
    memory when the tensor is on the card."""
    v = alto.oriented_view_device(at, mode)
    return _from_view(at.meta, mode, v.rows, v.words, v.values,
                      pin=at.device.type == "cuda")


def ensure_host(view) -> HostStream:
    """Adapt an in-core `OrientedView` (or pass a `HostStream` through),
    so the chunked executors take either."""
    if isinstance(view, HostStream):
        return view
    if isinstance(view, OrientedView):
        return _from_view(view.meta, view.mode, view.rows, view.words,
                          view.values, pin=view.rows.device.type == "cuda")
    raise TypeError(f"expected HostStream or OrientedView, got "
                    f"{type(view).__name__}")


# ---------------------------------------------------------------------------
# Disk backing (optional): .npy files reopened as memory maps
# ---------------------------------------------------------------------------

def _respill(hs: HostStream, d: pathlib.Path) -> HostStream:
    """Write ``hs`` into ``d`` atomically and reopen it memory-mapped.

    Two phases: every array is fully written to a ``.tmp`` sibling, then
    all of them are moved into place with ``os.replace``. Readers holding
    maps of the old files keep the old inodes, and a crash in the write
    phase leaves the previous generation byte for byte on disk. A crash
    between the replaces can still tear across files; the checksum,
    written alongside and verified by `from_memmap`, turns that into a
    load-time `StreamIntegrityError`. The ``stream.respill`` fault site
    sits between the two phases.
    """
    d.mkdir(parents=True, exist_ok=True)
    checksum = stream_checksum(hs.rows, hs.words, hs.values)
    payload = {"rows": _np(hs.rows),
               "words": _np(hs.words).view(np.uint32),
               "values": _np(hs.values),
               "length": np.asarray([hs.length], np.int64),
               "checksum": np.asarray([checksum], np.int64)}
    tmps = {}
    for name, arr in payload.items():
        tmp = d / f".{name}.tmp.npy"
        np.save(tmp, arr)
        tmps[name] = tmp
    faults.inject("stream.respill")
    for name, tmp in tmps.items():
        os.replace(tmp, d / f"{name}.npy")
    return from_memmap(d, hs.meta, hs.mode)


def to_memmap(hs: HostStream, directory) -> HostStream:
    """Spill ``hs`` to ``directory`` (``rows/words/values/length/
    checksum.npy``, the JAX package's file set) and reopen it as memory
    maps: the OS pages chunks in as the executors slice them."""
    return _respill(hs, pathlib.Path(directory))


def from_memmap(directory, meta: AltoMeta, mode: int) -> HostStream:
    """Reopen a spilled stream — the port's or the JAX package's — as
    memory maps, verifying the stored checksum against the mapped
    payload first (`StreamIntegrityError` on a mismatch). A spill without
    ``checksum.npy`` loads unverified.

    The maps are copy-on-write (``mmap_mode="c"``): the file never
    changes, and the tensors over them are writable as torch requires.
    Fault sites: ``stream.memmap_load`` (the read fails) and
    ``stream.checksum`` (the stored checksum reads one bit flipped).
    """
    faults.inject("stream.memmap_load")
    d = pathlib.Path(directory)
    length = int(np.load(d / "length.npy")[0])
    arrays = [np.load(d / f"{n}.npy", mmap_mode="c")
              for n in ("rows", "words", "values")]
    arrays[1] = arrays[1].view(np.int32)
    hs = HostStream(meta=meta, mode=mode, length=length,
                    rows=torch.from_numpy(arrays[0]),
                    words=torch.from_numpy(arrays[1]),
                    values=torch.from_numpy(arrays[2]), directory=d)
    cpath = d / "checksum.npy"
    if cpath.exists():
        stored = int(np.load(cpath)[0])
        if faults.fire("stream.checksum") is not None:
            stored ^= 1                       # as a flipped bit on disk
        actual = stream_checksum(*arrays)
        if stored != actual:
            _integrity_bump("checksum_failures")
            raise StreamIntegrityError(
                f"spilled stream at {d} fails its checksum (stored "
                f"{stored:#010x}, payload {actual:#010x}): torn write or "
                f"corruption; rebuild it from the tensor "
                f"(stream.load_or_rebuild)")
        hs.checksum = stored
    return hs


def load_or_rebuild(directory, at: AltoTensor, mode: int) -> HostStream:
    """`from_memmap`, or — when the spill fails its checksum or cannot be
    read — a rebuild from the tensor (`host_stream`) spilled afresh into
    the same directory. Counted as ``rebuilds`` in `integrity_stats`."""
    try:
        return from_memmap(directory, at.meta, mode)
    except (StreamIntegrityError, OSError):
        _integrity_bump("rebuilds")
        return _respill(host_stream(at, mode), pathlib.Path(directory))


def put_chunk(hs: HostStream, start: int, stop: int, device=None):
    """One chunk of ``hs`` on ``device`` (default ``cuda``):
    ``(rows, words, values)`` of ``[start, stop)``. Fires the
    ``stream.chunk_io`` fault site once. On the CPU the chunk is the
    zero-copy slice itself; to the card a pinned stream copies without
    blocking the host. The in-core double buffer (`kernels.ops._chunks`)
    copies through its own buffers on a copy stream instead."""
    dev = resolve_device(device)
    faults.inject("stream.chunk_io")
    async_copy = dev.type == "cuda" and hs.pinned
    return tuple(t.to(dev, non_blocking=async_copy)
                 for t in hs.chunk(start, stop))


def append_stream(hs: HostStream, at_new: AltoTensor) -> HostStream:
    """The stream of ``hs.mode`` rebuilt from the merged tensor
    ``at_new``. An in-memory stream returns a fresh one; a spilled stream
    is re-spilled atomically into its own directory, so executors still
    slicing the previous generation keep reading the old inodes."""
    merged = host_stream(at_new, hs.mode)
    if hs.directory is not None:
        return _respill(merged, hs.directory)
    return merged
