"""ALTO adaptive linearized encoding (paper §3.1, Figs. 4–6).

Maps N-dimensional coordinates onto one compact linearized index of
``sum_n ceil(log2 I_n)`` bits (Eq. 1). Bit positions are assigned
most-significant-first by repeatedly splitting the mode with the largest
remaining extent; ties break toward the longer original mode. The index
is kept as ``n_words`` little-endian 32-bit words (1/2/4 words, the
paper's 32/64/128-bit configurations).

Linearize (bit gather) and delinearize (bit scatter) are run-compressed:
consecutive index bits that come from consecutive bits of one mode and
land in one word move with a single shift and mask (`BitRun`).

Two placements, bit-identical:

* host (numpy): `linearize_np`, `delinearize_np`, `sort_key_np`,
  `count_distinct_np` — the parity reference for `alto.build`;
* torch (any device): `linearize`, `delinearize`, `sort_by_key`,
  `count_distinct`, `extract_mode` — used by `alto.build_device`.

Torch layout: words are an ``(M, n_words)`` ``int32`` tensor holding the
bit pattern of each unsigned 32-bit word (torch has no shifts on
``uint32``). All bit work widens to ``int64`` first; `unsigned` gives a
word's unsigned value.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

WORD_BITS = 32
_U32 = 0xFFFFFFFF


def _bits_for(extent: int) -> int:
    """ceil(log2 extent); modes of length 1 contribute zero bits."""
    return (int(extent) - 1).bit_length() if extent > 1 else 0


@dataclasses.dataclass(frozen=True)
class BitRun:
    """A contiguous run of bits moved between a mode coordinate and a word.

    word:       which 32-bit word of the linearized index.
    mode:       which tensor mode.
    src_shift:  bit offset of the run inside the mode coordinate.
    dst_shift:  bit offset of the run inside the word.
    length:     run length in bits.
    """
    word: int
    mode: int
    src_shift: int
    dst_shift: int
    length: int

    @property
    def mask(self) -> int:
        return (1 << self.length) - 1


@dataclasses.dataclass(frozen=True)
class AltoEncoding:
    """Static encoding metadata for a tensor shape (host-side, hashable)."""

    dims: tuple[int, ...]
    mode_bits: tuple[int, ...]         # bits per mode
    bit_mode: tuple[int, ...]          # bit b (0 = LSB) -> owning mode
    bit_pos: tuple[int, ...]           # bit b -> bit position inside mode
    runs: tuple[BitRun, ...]           # run-compressed gather/scatter plan

    @property
    def total_bits(self) -> int:
        return len(self.bit_mode)

    @property
    def n_words(self) -> int:
        # Round up to 1/2/4 words like the paper rounds to native word sizes.
        needed = max(1, -(-self.total_bits // WORD_BITS))
        for w in (1, 2, 4):
            if needed <= w:
                return w
        raise ValueError(
            f"ALTO index needs {self.total_bits} bits > 128; "
            f"unsupported shape {self.dims}")

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def mode_masks(self) -> np.ndarray:
        """(N, n_words) u32 masks: which index bits belong to each mode."""
        masks = np.zeros((self.ndim, self.n_words), dtype=np.uint64)
        for b, m in enumerate(self.bit_mode):
            masks[m, b // WORD_BITS] |= np.uint64(1) << np.uint64(
                b % WORD_BITS)
        return masks.astype(np.uint32)

    # ---- storage accounting (paper Eqs. 1-2) ----
    def storage_bits_alto(self, word_bits: int = WORD_BITS) -> int:
        """Index bits per nonzero in ALTO (Eq. 1), word-rounded (Eq. 2)."""
        return max(1, -(-self.total_bits // word_bits)) * word_bits

    def runtime_index_bits(self) -> int:
        """Bits per nonzero of the in-memory multi-word representation."""
        return self.n_words * WORD_BITS

    def storage_bits_coo(self, word_bits: int = WORD_BITS) -> int:
        """Index bits per nonzero in COO on word-addressed hardware (Eq. 2)."""
        return sum(max(1, -(-_bits_for(I) // word_bits)) * word_bits
                   for I in self.dims)


def make_encoding(dims: Sequence[int]) -> AltoEncoding:
    """Build the adaptive bit assignment for a tensor shape."""
    dims = tuple(int(d) for d in dims)
    if not dims or any(d < 1 for d in dims):
        raise ValueError(f"invalid dims {dims}")
    mode_bits = tuple(_bits_for(I) for I in dims)
    total = sum(mode_bits)

    remaining = list(mode_bits)

    def extent(n):
        # extent of mode n after assigning k of its (high) bits
        k = mode_bits[n] - remaining[n]
        return -(-dims[n] // (1 << k))

    order: list[int] = []  # mode owning each bit, MSB first
    for _ in range(total):
        # Largest remaining extent first; ties -> longer original mode;
        # final tie -> lower mode id (deterministic).
        n = max((m for m in range(len(dims)) if remaining[m] > 0),
                key=lambda m: (extent(m), dims[m], -m))
        order.append(n)
        remaining[n] -= 1

    bit_mode = [0] * total
    bit_pos = [0] * total
    taken = [0] * len(dims)  # high bits already assigned per mode
    for i, n in enumerate(order):
        b = total - 1 - i           # global bit position (MSB first)
        bit_mode[b] = n
        bit_pos[b] = mode_bits[n] - 1 - taken[n]
        taken[n] += 1

    # Run-compress: scan LSB->MSB, merge while same mode & word and both
    # source and destination positions advance by one.
    runs: list[BitRun] = []
    b = 0
    while b < total:
        m = bit_mode[b]
        w = b // WORD_BITS
        start_b, start_p = b, bit_pos[b]
        length = 1
        while (b + 1 < total and bit_mode[b + 1] == m
               and (b + 1) // WORD_BITS == w
               and bit_pos[b + 1] == bit_pos[b] + 1):
            b += 1
            length += 1
        runs.append(BitRun(word=w, mode=m, src_shift=start_p,
                           dst_shift=start_b % WORD_BITS, length=length))
        b += 1

    return AltoEncoding(dims=dims, mode_bits=mode_bits,
                        bit_mode=tuple(bit_mode), bit_pos=tuple(bit_pos),
                        runs=tuple(runs))


# ---------------------------------------------------------------------------
# Host side (numpy): the parity reference of format generation.
# ---------------------------------------------------------------------------

def linearize_np(enc: AltoEncoding, coords: np.ndarray) -> np.ndarray:
    """Bit-level gather: (M, N) int coords -> (M, n_words) u32 index."""
    coords = np.asarray(coords)
    out = np.zeros((coords.shape[0], enc.n_words), dtype=np.uint32)
    c = coords.astype(np.uint32)
    for r in enc.runs:
        chunk = (c[:, r.mode] >> np.uint32(r.src_shift)) & np.uint32(r.mask)
        out[:, r.word] |= chunk << np.uint32(r.dst_shift)
    return out


def delinearize_np(enc: AltoEncoding, words: np.ndarray) -> np.ndarray:
    """Bit-level scatter: (M, n_words) u32 index -> (M, N) int32 coords."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.zeros((words.shape[0], enc.ndim), dtype=np.uint32)
    for r in enc.runs:
        chunk = (words[:, r.word] >> np.uint32(r.dst_shift)) & np.uint32(
            r.mask)
        out[:, r.mode] |= chunk << np.uint32(r.src_shift)
    return out.astype(np.int32)


def extract_mode_np(enc: AltoEncoding, words: np.ndarray,
                    mode: int) -> np.ndarray:
    """One mode's coordinate from (..., n_words) u32 words -> int32."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.zeros(words.shape[:-1], dtype=np.uint32)
    for r in enc.runs:
        if r.mode == mode:
            chunk = (words[..., r.word] >> np.uint32(r.dst_shift)) \
                & np.uint32(r.mask)
            out |= chunk << np.uint32(r.src_shift)
    return out.astype(np.int32)


def sort_key_np(words: np.ndarray) -> np.ndarray:
    """Stable argsort of multi-word linearized indices (LSW first).

    ALTO sorts ONE packed key (paper Fig. 13): one word is its own key,
    two words pack into u64, four words take a lexsort."""
    W = words.shape[1]
    if W == 1:
        return np.argsort(words[:, 0], kind="stable")
    if W == 2:
        return np.argsort(_pack_u64_np(words), kind="stable")
    # np.lexsort: last key is primary -> most significant word last.
    return np.lexsort(tuple(words[:, w] for w in range(W)))


def _pack_u64_np(words: np.ndarray) -> np.ndarray:
    """(M, W<=2) u32 -> (M,) u64 packed key."""
    key = words[:, 0].astype(np.uint64)
    if words.shape[1] > 1:
        key |= words[:, 1].astype(np.uint64) << np.uint64(32)
    return key


def count_distinct_np(words: np.ndarray) -> int:
    """Distinct rows of an (M, W) u32 word array (packed sort + diff)."""
    M, W = words.shape
    if M == 0:
        return 0
    if W <= 2:
        key = np.sort(_pack_u64_np(words))
        return 1 + int(np.count_nonzero(key[1:] != key[:-1]))
    lo = _pack_u64_np(words[:, :2])
    hi = _pack_u64_np(words[:, 2:])
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    return 1 + int(np.count_nonzero(
        (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])))


# ---------------------------------------------------------------------------
# Torch side: int32 word storage, int64 bit work.
# ---------------------------------------------------------------------------

def unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 word bit patterns -> their unsigned values as int64."""
    return words.to(torch.int64) & _U32


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def words_from_np(words: np.ndarray) -> torch.Tensor:
    """(M, W) u32 numpy words -> the port's int32 word tensor (CPU)."""
    return torch.from_numpy(np.array(words, np.uint32).view(np.int32))


def words_to_np(words: torch.Tensor) -> np.ndarray:
    """The port's int32 word tensor -> (M, W) u32 numpy words."""
    return words.detach().cpu().numpy().view(np.uint32)


def linearize(enc: AltoEncoding, coords: torch.Tensor) -> torch.Tensor:
    """(M, N) int coords -> (M, n_words) int32 words (bit gather)."""
    c = coords.to(torch.int64)
    out = [torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
           for _ in range(enc.n_words)]
    for r in enc.runs:
        chunk = (c[..., r.mode] >> r.src_shift) & r.mask
        out[r.word] = out[r.word] | (chunk << r.dst_shift)
    return to_words(torch.stack(out, dim=-1))


def delinearize(enc: AltoEncoding, words: torch.Tensor) -> torch.Tensor:
    """(..., n_words) int32 words -> (..., N) int32 coords (bit scatter)."""
    u = unsigned(words)
    out = [torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
           for _ in range(enc.ndim)]
    for r in enc.runs:
        chunk = (u[..., r.word] >> r.dst_shift) & r.mask
        out[r.mode] = out[r.mode] | (chunk << r.src_shift)
    return torch.stack(out, dim=-1).to(torch.int32)


def extract_mode(enc: AltoEncoding, words: torch.Tensor,
                 mode: int) -> torch.Tensor:
    """ONE mode's coordinate out of (..., n_words) words -> (...,) int32.

    Only the target mode's bit runs are touched — no full delinearize."""
    u = unsigned(words)
    out = torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
    for r in enc.runs:
        if r.mode == mode:
            out = out | (((u[..., r.word] >> r.dst_shift) & r.mask)
                         << r.src_shift)
    return out.to(torch.int32)


def _pack_key(words: torch.Tensor) -> torch.Tensor:
    """(M, W<=2) words -> (M,) int64 key whose signed order is the
    unsigned multi-word order: the high word's bit 31 (bit 63 of the
    packed key) is flipped, so unsigned u64 order becomes signed order."""
    if words.shape[1] == 1:
        return unsigned(words[:, 0])
    hi = unsigned(words[:, 1]) - 2 ** 31       # flip bit 63 of the key
    return hi * 2 ** 32 + unsigned(words[:, 0])


def sort_by_key(words: torch.Tensor, *operands: torch.Tensor):
    """Stable ascending sort by the multi-word ALTO key.

    ``words`` is (M, W) int32; ``operands`` are (M, ...) tensors carried
    through the same permutation. Returns ``(sorted_words,
    *sorted_operands)``. One or two words sort once on the packed int64
    key; four words take two stable passes, low half first, so ties in
    the high half keep the low-half order (``sort_key_np``'s lexsort).
    Every path is stable: duplicate keys keep their input order.
    """
    if words.shape[1] <= 2:
        _, order = torch.sort(_pack_key(words), stable=True)
    else:
        _, order = torch.sort(_pack_key(words[:, :2]), stable=True)
        _, o2 = torch.sort(_pack_key(words[order, 2:]), stable=True)
        order = order[o2]
    return (words[order], *(op[order] for op in operands))


def count_distinct(words: torch.Tensor) -> int:
    """Distinct rows of an (M, W) int32 word tensor (sort + adjacent diff)."""
    if words.shape[0] == 0:
        return 0
    if words.shape[1] <= 2:
        key = torch.sort(_pack_key(words)).values
        return 1 + int((key[1:] != key[:-1]).sum())
    srt = sort_by_key(words)[0]
    return 1 + int((srt[1:] != srt[:-1]).any(dim=-1).sum())
