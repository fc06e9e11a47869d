"""Plain mirrors of the port's run-sum kernels, step by step in float32,
with models of their stores: the CPU tests hold them against the plain
versions, which the card holds the kernels against (`chip_smoke.py`).

* `runs_pass_mirror`: the runs pass that K1, K2 and K8
  (``mttkrp_carry_runs_kernel``, ``csrc/alto_scan.cuh``) and K5, K6 and
  K9 (``phi_carry_runs_kernel``, ``csrc/phi_scan.cuh``) share, in either
  layout of the run sums, rank tile by rank tile.
* `split_mirror`: the split of ``ops.segment_merge``
  (``segment_split_kernel``, ``csrc/segment_split.cuh``).
"""
import torch


def runs_pass_mirror(terms, rows, block_m, n_rows, partials: bool,
                     r_block=None):
    """What the runs pass stores, slice by slice and, in tiles of
    ``r_block`` columns (default the whole rank), tile by tile: each run
    sums its terms in stream order from 0.0.

    ``partials`` (K2, K6): slot j of the slice gets its j-th run, zeros
    the unused slots; returns the slots (NaN where never stored) and the
    count of stores of each slot entry. Else (K1, K5): inner runs to
    ``out`` (NaN-filled before), zeros to the rows the stream skips, the
    first and last runs to the carries; returns ``(out, carry_row,
    carry_val, stores)`` with the count of stores of each entry of out."""
    M, R = terms.shape
    rb = r_block or R
    nb = M // block_m
    slots = torch.full((nb, block_m, R), float("nan"))
    slot_stores = torch.zeros((nb, block_m, R), dtype=torch.int64)
    out = torch.full((n_rows, R), float("nan"))
    stores = torch.zeros((n_rows, R), dtype=torch.int64)
    crow = torch.full((nb, 2), -7, dtype=torch.int32)
    cval = torch.full((nb, 2, R), float("nan"))
    for c0 in range(0, R, rb):
        cols = slice(c0, c0 + rb)

        def zero(r0, r1):
            out[r0:r1, cols] = 0.0
            stores[r0:r1, cols] += 1

        def slot(b, j, acc):
            slots[b, j, cols] = acc
            slot_stores[b, j, cols] += 1
        for b in range(nb):
            s = b * block_m
            cur = int(rows[s])
            if not partials:
                zero(0 if b == 0 else int(rows[s - 1]) + 1, cur)
            acc = torch.zeros(rb)
            j = 0
            for i in range(s, s + block_m):
                if int(rows[i]) != cur:
                    if partials:
                        slot(b, j, acc)
                    elif j == 0:
                        crow[b, 0], cval[b, 0, cols] = cur, acc
                    else:
                        out[cur, cols] = acc
                        stores[cur, cols] += 1
                    acc = torch.zeros(rb)
                    j += 1
                    if not partials:
                        zero(cur + 1, int(rows[i]))
                    cur = int(rows[i])
                acc = acc + terms[i, cols]
            if partials:
                slot(b, j, acc)
                for k in range(j + 1, block_m):
                    slot(b, k, torch.zeros(rb))
                continue
            if j == 0:
                crow[b] = torch.tensor([cur, -1])
                cval[b, 0, cols], cval[b, 1, cols] = acc, 0.0
            else:
                crow[b, 1], cval[b, 1, cols] = cur, acc
            if b == nb - 1:
                zero(cur + 1, n_rows)
    if partials:
        return slots, slot_stores
    return out, crow, cval, stores


def split_mirror(partials, rows, out_dim, lanes):
    """What ``segment_split_kernel`` does with the slots ``partials``
    ``(n_blocks, block_m, R)`` of the padded stream ``rows``: a warp per
    slice reads the rows 32 at a time; a lane whose row differs from the
    one before (or that holds the slice's first position) starts a run,
    its slot j the starts before it; the starts go round-robin to the
    ``32 // lanes`` sub-warps, and a sub-warp stores the zeros of the gap
    below its start's row, then moves slot j to the carries (the slice's
    first run, or its last: the run of the slice's last row) or to out.
    The slice with one run gets row -1 and zeros in carry slot 1; the last
    slice zeros the rows above its last row.

    Returns ``(out, carry_row, carry_val, stores, reads)``: out NaN where
    never stored, the count of stores of each row of out and of reads of
    each slot."""
    nb, bm, R = partials.shape
    n_sub = 32 // lanes
    r = [int(v) for v in rows]
    out = torch.full((out_dim, R), float("nan"))
    stores = torch.zeros(out_dim, dtype=torch.int64)
    reads = torch.zeros((nb, bm), dtype=torch.int64)
    crow = torch.full((nb, 2), -7, dtype=torch.int32)
    cval = torch.full((nb, 2, R), float("nan"))

    def zero(r0, r1):
        out[r0:r1] = 0.0
        stores[r0:r1] += 1
    for b in range(nb):
        s, e = b * bm, (b + 1) * bm
        last = r[e - 1]
        if r[s] == last:
            crow[b, 1], cval[b, 1] = -1, 0.0
        prev = -1 if b == 0 else r[s - 1]
        j0 = 0
        for w0 in range(s, e, 32):
            lane_row = [r[i] if i < e else last for i in range(w0, w0 + 32)]
            starts = [w0 + k < e and (w0 + k == s or lane_row[k] != (
                prev if k == 0 else lane_row[k - 1])) for k in range(32)]
            rank = [sum(starts[:k]) for k in range(32)]
            prev = lane_row[31]
            for q in range(n_sub):
                for k in range(32):
                    if not (starts[k] and rank[k] % n_sub == q):
                        continue
                    pos, j = w0 + k, j0 + rank[k]
                    row = r[pos]
                    zero(0 if pos == 0 else r[pos - 1] + 1, row)
                    reads[b, j] += 1
                    if j == 0:
                        crow[b, 0], cval[b, 0] = row, partials[b, j]
                    elif row == last:
                        crow[b, 1], cval[b, 1] = row, partials[b, j]
                    else:
                        out[row] = partials[b, j]
                        stores[row] += 1
            j0 += sum(starts)
        if b == nb - 1:
            zero(last + 1, out_dim)
    return out, crow, cval, stores, reads
