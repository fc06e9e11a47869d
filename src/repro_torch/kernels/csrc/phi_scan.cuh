// The CP-APR Φ traversals: the runs pass of K5 and K6 (K9 runs it on one
// chunk) and K7 (one CTA per ALTO partition, Temp in shared memory).
//
// Replace, in src/repro/kernels/:
//   K5  mttkrp_oriented.py phi_oriented_carry_pallas (:437) — the
//       sequential carry scan over the fused Φ update, full rank;
//   K6  mttkrp_oriented.py phi_oriented_partials_pallas (:204) — per-block
//       Φ run sums through a one-hot (block_m x block_m) matmul;
//   K9  mttkrp_oriented.py phi_oriented_carry_chunk_pallas (:637) — K5
//       over one chunk (its runs pass is phi_carry_runs_kernel below);
//   K7  cpapr_phi.py phi_partials_pallas (:57) — one partition's Φ into
//       its Temp through a one-hot (chunk x temp_rows) matmul in VMEM.
//
// What bounds them on an H100: bytes (the stream, Π or the factors, B and
// the output, each once) if the loads keep enough requests in flight; the
// thread-per-column form they replace had every thread load whole rows
// and divide by itself, R times the work, one nonzero in flight.
//
// Lane map. A sub-warp of W lanes owns one slice (K5, K6) or one nonzero
// at a time (K7), and lane l owns rank columns c·W + l for c < COLS: about four
// columns per lane (phi_dispatch: W = 4, COLS = 4 at R = 16; W = 16 at
// R = 40; a whole warp with up to 32 columns per lane for the largest
// ranks). Per nonzero each lane loads its own Π entries (ALTO-PRE) or
// gathers its own factor entries (ALTO-OTF), and its B entries: each row
// read once, in W-lane coalesced pieces.
//
// Rounding contract, the term `_phi` (src/repro/core/cpapr.py:78) forms:
// krp_r is the product of the other modes' entries in increasing mode
// order (__fmul_rn) or the Π entry; prod_r = __fmul_rn(B[row, r], krp_r);
// the denominator is a serial chain of __shfl_sync reads in k order from
// 0.0, dot = __fadd_rn(dot, prod_k), then fmaxf(dot, eps); the term is
// __fmul_rn(__fdiv_rn(v, denom), krp_r), the order of
// `(vals / denom)[:, None] * krp`. Explicit intrinsics keep nvcc from
// contracting into FMAs. So every kernel here forms the terms of
// core.mttkrp.phi_contributions, and the sums below add them in stream
// order from 0.0 with __fadd_rn: K5 equals K6 + segment_merge, and K5,
// K6 and K7 equal their plain versions on the CPU, bit for bit.
//
// Latency: the chains of U nonzeros of one sub-warp are interleaved (their
// loads issued first), so only the run sums are serial; with narrow
// sub-warps a warp carries several slices at once.
//
// Decode: the ALTO words are decoded through per-byte tables
// (alto_coord_table: four lookups and ORs per word and mode) in place of
// the loop over the encoding's BitRuns.
//
// K7 (phi_partials_smem_kernel): one CTA per partition. The Temp window
// (h, R) and the B rows of the same window live in shared memory. The
// partition is walked in tiles: the sub-warps compute the terms of a tile
// of nonzeros in parallel into a shared staging tile; then sub-warp q adds
// the tile's terms of the Temp rows with row % n_subwarps == q, in tile
// order, its lanes on the columns (a ballot per 32 slots finds them). Each
// Temp entry thus receives its terms in stream order from 0.0, as
// before. Where Temp exceeds what a CTA may hold, the CTA walks its
// partition once per row window of `window` rows (the wrapper's choice
// from the card's shared memory) and adds only that window's rows: the
// same order per entry, so any window height gives the same bits. Every
// Temp row is written once, at the end of its window. The Temp is as tall
// as the tallest partition's row interval; a partition walks only the
// windows its own rows reach (found first by a walk that only decodes)
// and stores zeros in the rest, so its walks follow its own interval and
// not the tallest.
//
// K7's CTA (common.k7_launch): the plan's threads with a tile of
// tile_nnz(R) nonzeros and the tallest window that fits, where that
// leaves an SM 16 warps or more (Chicago's mode 0: 25 KB, 8 CTAs of 4
// warps). A window that fills the CTA's 227 KB leaves one CTA an SM, 4
// warps: too few factor-row gathers in flight for rows that come from
// L2. There the same kernel runs in a wider CTA (blockDim.x is any whole
// number of warps) until the SM holds 16 warps, with a staging tile
// scaled with its warps and the window that leaves: on Enron's modes
// 512 threads, a 512-nonzero tile and 1,544-row windows, 1.7 times as
// fast as 128 threads (H100, 700 W; 1,024 threads ran 0.2 % slower in
// all, 256 threads 1.4 times as fast as 128). Sub-warp q
// still owns the rows with row % n_subwarps == q and adds a tile's terms
// in slot order, so each Temp entry still adds its terms in stream order
// from 0.0: the bits depend on neither the threads, nor the tile, nor
// the window.
#pragma once

#include "alto_scan.cuh"

namespace {

// Lanes of the sub-warp holding this thread.
template <int W>
__device__ __forceinline__ unsigned subwarp_mask() {
  return (0xffffffffu >> (32 - W)) << ((threadIdx.x & 31) / W * W);
}

// The lane's krp entries and B entries of nonzero i (B row `brow`);
// factor m read at its tenant offset foff[m].
template <int W, int COLS>
__device__ __forceinline__ void phi_lane_load(
    const AltoArgs& a, const float* pi, const uint32_t* words, int64_t i,
    const float* brow, const int64_t (&foff)[ALTO_MAX_MODES], int lane,
    float (&krp)[COLS], float (&bv)[COLS]) {
  const int R = a.rank;
  if (pi != nullptr) {
    const float* p = pi + i * R;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = c * W + lane;
      krp[c] = col < R ? __ldg(p + col) : 0.0f;
    }
  } else {
    const uint32_t* w = words + i * a.nwords;
    bool first = true;
#pragma unroll
    for (int c = 0; c < COLS; ++c) krp[c] = 0.0f;
#pragma unroll
    for (int m = 0; m < ALTO_MAX_MODES; ++m) {
      if (m >= a.ndim || m == a.mode) continue;
      const float* f = a.factors[m] + foff[m] +
                       static_cast<int64_t>(alto_coord_table(a, w, m)) * R;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = c * W + lane;
        const float x = col < R ? __ldg(f + col) : 0.0f;
        krp[c] = first ? x : __fmul_rn(krp[c], x);
      }
      first = false;
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = c * W + lane;
    bv[c] = col < R ? brow[col] : 0.0f;
  }
}

// The U interleaved denominators: dot[u] = sum over k in order of
// prod[u][k], read from lane k % W, register k / W.
template <int W, int COLS, int U>
__device__ __forceinline__ void phi_denominators(unsigned mask, int R,
                                                 const float (&prod)[U][COLS],
                                                 float (&dot)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) dot[u] = 0.0f;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (c * W + j >= R) break;
#pragma unroll
      for (int u = 0; u < U; ++u)
        dot[u] = __fadd_rn(dot[u], __shfl_sync(mask, prod[u][c], j, W));
    }
  }
}

// The terms of U nonzeros i0 .. i0+U-1 of one sub-warp (those with
// live[u]), with B rows brow[u]; term[u][c] for column c·W + lane.
template <int W, int COLS, int U>
__device__ __forceinline__ void phi_subwarp_terms(
    const AltoArgs& a, const float* pi, float eps,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    const int64_t (&idx)[U], const bool (&live)[U],
    const float* const (&brow)[U], const int64_t (&foff)[ALTO_MAX_MODES],
    int lane, unsigned mask, float (&term)[U][COLS]) {
  float krp[U][COLS], prod[U][COLS], v[U], dot[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float bv[COLS];
    if (live[u]) {
      phi_lane_load<W, COLS>(a, pi, words, idx[u], brow[u], foff, lane,
                             krp[u], bv);
      v[u] = __ldg(values + idx[u]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) krp[u][c] = bv[c] = 0.0f;
      v[u] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) prod[u][c] = __fmul_rn(bv[c], krp[u][c]);
  }
  phi_denominators<W, COLS, U>(mask, a.rank, prod, dot);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float q = __fdiv_rn(v[u], fmaxf(dot[u], eps));
#pragma unroll
    for (int c = 0; c < COLS; ++c) term[u][c] = __fmul_rn(q, krp[u][c]);
  }
}

// The lane's columns c·W + lane of a row: dst[col] = x[c].
template <int W, int COLS>
__device__ __forceinline__ void phi_store(float* dst, int R, int lane,
                                          const float (&x)[COLS]) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = c * W + lane;
    if (col < R) dst[col] = x[c];
  }
}

// Rows [r0, r1) of out (row stride R) get zeros in the lane's columns.
template <int W, int COLS>
__device__ __forceinline__ void phi_zero_rows(float* out, int64_t r0,
                                              int64_t r1, int R, int lane) {
  float zero[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) zero[c] = 0.0f;
  for (int64_t r = r0; r < r1; ++r) phi_store<W, COLS>(out + r * R, R, lane,
                                                       zero);
}

// The Φ runs pass, one sub-warp per block_m slice; each run sums its terms
// in stream order from 0.0. Two layouts of the run sums:
//  * carry (partials == nullptr; K5, and K9 on one chunk): K1's runs-pass
//    contract (mttkrp_carry_runs_kernel, alto_scan.cuh): inner runs to
//    out, the first and last runs to the carries buffer (n_blocks, 2, R),
//    row -1 in slot 1 when one run covers the slice. With zero_gaps (K5)
//    it also stores zeros to the rows the stream skips, as K1's does
//    (between two rows: the later's slice, which reads rows[s - 1]; below
//    the first row: slice 0; above the last, up to n_rows: the last
//    slice), so with the fix-up storing the carried rows every row of out
//    is written once. K9 adds into a running out its executor zeroes.
//  * partials (K6): slot j of the slice's block_m slots in partials
//    (n_blocks, block_m, R) gets the slice's j-th run, the unused slots
//    zeros: the JAX partials layout that ops.segment_merge reads.
// The two add the same terms in the same order: K5 ≡ K6 + segment_merge.
// Tenant blockIdx.z of a bucket (Tenants, alto_scan.cuh) walks its own
// stream, B, Π or factors into its own out, carries and slots.
template <int W, int COLS, int U>
__global__ void phi_carry_runs_kernel(
    const __grid_constant__ AltoArgs a, const __grid_constant__ Tenants tn,
    const float* __restrict__ B, const float* __restrict__ pi, float eps,
    const int* __restrict__ rows, const uint32_t* __restrict__ words,
    const float* __restrict__ values, int64_t block_m, int64_t n_blocks,
    int n_rows, bool zero_gaps, float* __restrict__ out,
    int* __restrict__ carry_row, float* __restrict__ carry_val,
    float* __restrict__ partials) {
  const int lane = threadIdx.x % W;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x / W) +
                    threadIdx.x / W;
  if (b >= n_blocks) return;           // the whole sub-warp leaves
  const unsigned mask = subwarp_mask<W>();
  const int R = a.rank;
  const int64_t t = blockIdx.z;        // the tenant
  const int64_t Mt = n_blocks * block_m;
  int64_t foff[ALTO_MAX_MODES];
  tenant_factor_offsets(tn, t, foff);
  rows += t * Mt;
  words += t * Mt * a.nwords;
  values += t * Mt;
  B += t * tn.rows;
  if (pi != nullptr) pi += t * Mt * R;
  if (partials != nullptr) {
    partials += t * Mt * R;
  } else {
    out += t * tn.rows;
    carry_row += t * 2 * n_blocks;
    carry_val += t * 2 * n_blocks * R;
  }
  const int64_t s = b * block_m;
  const int64_t e = s + block_m;
  float* const slots = partials == nullptr ? nullptr : partials + s * R;
  int cur = __ldg(rows + s);
  if (zero_gaps)
    phi_zero_rows<W, COLS>(out, b == 0 ? 0 : __ldg(rows + s - 1) + 1, cur, R,
                           lane);
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  int64_t j = 0;                       // runs closed so far
  for (int64_t i0 = s; i0 < e; i0 += U) {
    int64_t idx[U];
    bool live[U];
    int row[U];
    const float* brow[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      idx[u] = i0 + u;
      live[u] = idx[u] < e;
      row[u] = live[u] ? __ldg(rows + idx[u]) : cur;
      brow[u] = B + static_cast<int64_t>(row[u]) * R;
    }
    float term[U][COLS];
    phi_subwarp_terms<W, COLS, U>(a, pi, eps, words, values, idx, live,
                                  brow, foff, lane, mask, term);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) break;
      if (row[u] != cur) {
        float* dst;
        if (slots != nullptr) {
          dst = slots + j * R;
        } else if (j == 0) {
          if (lane == 0) carry_row[2 * b] = cur;
          dst = carry_val + (2 * b) * R;
        } else {
          dst = out + static_cast<int64_t>(cur) * R;
        }
        phi_store<W, COLS>(dst, R, lane, acc);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
        ++j;
        if (zero_gaps)
          phi_zero_rows<W, COLS>(out, cur + 1, row[u], R, lane);
        cur = row[u];
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = __fadd_rn(acc[c], term[u][c]);
    }
  }
  if (slots != nullptr) {
    phi_store<W, COLS>(slots + j * R, R, lane, acc);
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
    for (++j; j < block_m; ++j) phi_store<W, COLS>(slots + j * R, R, lane,
                                                   acc);
    return;
  }
  const bool first = j == 0;
  if (lane == 0) {
    if (first) {
      carry_row[2 * b] = cur;
      carry_row[2 * b + 1] = -1;
    } else {
      carry_row[2 * b + 1] = cur;
    }
  }
  phi_store<W, COLS>(carry_val + (first ? 2 * b : 2 * b + 1) * R, R, lane,
                     acc);
  if (first) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
    phi_store<W, COLS>(carry_val + (2 * b + 1) * R, R, lane, acc);
  }
  if (zero_gaps && b == n_blocks - 1)
    phi_zero_rows<W, COLS>(out, cur + 1, n_rows, R, lane);
}

// K7: one CTA per partition l, Temp_l (temp_rows, R) built in shared
// memory window by window and written once. Shared memory: the Temp
// window and the window's B rows (window x R each), the staging tile
// (tile x R terms) and its local rows (tile ints). Tenant blockIdx.z of
// a bucket (Tenants, alto_scan.cuh) walks its own partitions (gridDim.x
// of `chunk` nonzeros a tenant) with its own B (tn.rows), Π or factors
// into its own Temp; inside a tenant every CTA does the solo launch's
// work. A solo launch is one tenant with zero strides.
template <int W, int COLS, int U>
__global__ void phi_partials_smem_kernel(
    const __grid_constant__ AltoArgs a, const __grid_constant__ Tenants tn,
    const float* __restrict__ B,
    const float* __restrict__ pi, float eps,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    const int* __restrict__ part_start, int64_t chunk, int64_t temp_rows,
    int out_rows, int window, int tile, float* __restrict__ temp) {
  extern __shared__ float smem[];
  const int R = a.rank;
  float* s_temp = smem;
  float* s_b = s_temp + window * R;
  float* s_term = s_b + window * R;
  int* s_row = reinterpret_cast<int*>(s_term + tile * R);
  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % W;
  const int sub = tid / W;
  const int nsub = nthreads / W;
  const unsigned mask = subwarp_mask<W>();
  const int wl = tid & 31;                 // lane in the warp
  const int warp_sub = (tid - wl) / W;     // the warp's first sub-warp
  const int64_t z = blockIdx.z;            // the tenant
  const int64_t L = gridDim.x;
  const int64_t Mt = L * chunk;
  int64_t foff[ALTO_MAX_MODES];
  tenant_factor_offsets(tn, z, foff);
  B += z * tn.rows;
  if (pi != nullptr) pi += z * Mt * R;
  words += z * Mt * a.nwords;
  values += z * Mt;
  part_start += z * L * a.ndim;
  temp += z * L * temp_rows * R;
  const int start = __ldg(part_start + l * a.ndim + a.mode);
  const int64_t s = l * chunk;
  // Temp rows [0, reach) are those this partition's rows reach: temp_rows
  // is the tallest partition's. With several windows, a walk that only
  // decodes finds reach first; a window at or past it holds no term and is
  // stored as zeros without a walk.
  int64_t reach = temp_rows;
  if (window < temp_rows) {
    int top = 0;                           // highest local row + 1
    for (int64_t j = tid; j < chunk; j += nthreads) {
      const int64_t lr =
          alto_coord_table(a, words + (s + j) * a.nwords, a.mode) - start;
      top = lr >= top ? static_cast<int>(lr) + 1 : top;
    }
    // The CTA's largest, an int a warp through the staging tile (its
    // terms, then its rows; the launcher checks they hold one a warp).
    int* s_top = reinterpret_cast<int*>(s_term);
    top = __reduce_max_sync(0xffffffffu, top);
    if (wl == 0) s_top[tid / 32] = top;
    __syncthreads();
    reach = 0;
    for (int k = 0; k < nthreads / 32; ++k)
      reach = s_top[k] > reach ? s_top[k] : reach;
    __syncthreads();
  }
  for (int64_t w0 = 0; w0 < temp_rows; w0 += window) {
    const int h = static_cast<int>(
        temp_rows - w0 < window ? temp_rows - w0 : window);
    float* tl = temp + (l * temp_rows + w0) * R;
    if (w0 >= reach) {
      for (int k = tid; k < h * R; k += nthreads) tl[k] = 0.0f;
      continue;
    }
    const int64_t base = start + w0;
    for (int k = tid; k < h * R; k += nthreads) {
      s_temp[k] = 0.0f;
      const int64_t g = base + k / R;
      s_b[k] = g < out_rows ? __ldg(B + g * R + k % R) : 0.0f;
    }
    __syncthreads();
    for (int64_t t0 = 0; t0 < chunk; t0 += tile) {
      const int n = static_cast<int>(chunk - t0 < tile ? chunk - t0 : tile);
      for (int j0 = sub * U; j0 < n; j0 += nsub * U) {
        int64_t idx[U];
        bool live[U];
        int local[U];
        const float* brow[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          idx[u] = s + t0 + j0 + u;
          local[u] = -1;
          if (j0 + u < n) {
            const int64_t lr =
                alto_coord_table(a, words + idx[u] * a.nwords, a.mode) - base;
            if (lr >= 0 && lr < h) local[u] = static_cast<int>(lr);
          }
          live[u] = local[u] >= 0;
          brow[u] = s_b + (live[u] ? local[u] : 0) * R;
        }
        float term[U][COLS];
        phi_subwarp_terms<W, COLS, U>(a, pi, eps, words, values, idx, live,
                                      brow, foff, lane, mask, term);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u >= n) break;
          if (lane == 0) s_row[j0 + u] = local[u];
          if (!live[u]) continue;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int col = c * W + lane;
            if (col < R) s_term[(j0 + u) * R + col] = term[u][c];
          }
        }
      }
      __syncthreads();
      // Sum phase: sub-warp q owns the Temp rows with row % nsub == q, its
      // lanes their columns. A warp reads 32 slot rows at a time; a ballot
      // per sub-warp marks the slots of its rows, which it adds in slot
      // (stream) order.
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int lr_l = j0 + wl < n ? s_row[j0 + wl] : -1;
        const int q_l = lr_l >= 0 ? lr_l % nsub : -1;
        unsigned mine = 0;
#pragma unroll
        for (int q = 0; q < 32 / W; ++q) {
          const unsigned m = __ballot_sync(0xffffffffu, q_l == warp_sub + q);
          if (sub == warp_sub + q) mine = m;
        }
        while (mine != 0) {
          const int j = j0 + __ffs(mine) - 1;
          mine &= mine - 1;
          float* row = s_temp + s_row[j] * R;
          const float* t = s_term + j * R;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int col = c * W + lane;
            if (col < R) row[col] = __fadd_rn(row[col], t[col]);
          }
        }
      }
      __syncthreads();
    }
    for (int k = tid; k < h * R; k += nthreads) tl[k] = s_temp[k];
    __syncthreads();
  }
}

// Threads of a Φ CTA: `threads` rounded up to whole warps.
inline int phi_cta_threads(int threads) {
  const int t = threads < 32 ? 32 : threads;
  return (t + 31) / 32 * 32;
}

// Nonzeros each sub-warp keeps in flight.
template <int COLS>
constexpr int phi_unroll() {
  return COLS <= 2 ? 4 : (COLS <= 8 ? 2 : 1);
}

// Runs L<W, COLS>::run(args) for the lane map of rank R: a sub-warp of W
// lanes per nonzero (slice), COLS columns per lane, column c·W + lane.
// About four columns per lane: on an H100 (700 W) at R = 16, W = 4 ran K5
// on a DARPA-mode-2-shaped stream (PRE) in 2.54 ms against 3.51 ms with a
// lane per column (W = 16), and K7 on Chicago's mode 0 (OTF) in 1.03
// against 2.06 ms (tools/torch_phi_lane_maps.py): more slices share a
// warp's instructions, shuffles and loads. Returns cudaErrorInvalidValue
// for R outside 1..1024.
template <template <int, int> class L, class Args>
int phi_dispatch(int R, const Args& args) {
  if (R < 1 || R > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 1) return L<1, 1>::run(args);
  if (R <= 2) return L<1, 2>::run(args);
  if (R <= 4) return L<1, 4>::run(args);
  if (R <= 8) return L<2, 4>::run(args);
  if (R <= 16) return L<4, 4>::run(args);
  if (R <= 32) return L<8, 4>::run(args);
  if (R <= 64) return L<16, 4>::run(args);
  if (R <= 128) return L<32, 4>::run(args);
  if (R <= 256) return L<32, 8>::run(args);
  if (R <= 512) return L<32, 16>::run(args);
  return L<32, 32>::run(args);
}

struct PhiArgs {           // the operands of both Φ launches
  AltoArgs a;
  Tenants tn;              // the tenant axis (tenants_make)
  const float* B;
  const float* pi;         // Π rows (ALTO-PRE) or nullptr (ALTO-OTF)
  float eps;
  const uint32_t* words;
  const float* values;
  int threads;             // CTA threads, whole warps
  cudaStream_t stream;
  int out_rows;             // rows of B and out
  // the runs pass (K5, K6, K9)
  const int* rows;
  int64_t block_m, n_blocks;
  bool zero_gaps;
  float* out;
  int* carry_row;
  float* carry_val;
  float* partials;         // K6's slots, or nullptr
  // K7
  const int* part_start;
  int64_t n_parts, chunk, temp_rows;
  int window, tile;
  float* temp;
};

// The operands every Φ launch shares.
inline PhiArgs phi_args(const AltoArgs& a, const void* B, const void* pi,
                        float eps, const void* words, const void* values,
                        int threads, void* stream) {
  PhiArgs p{};
  p.a = a;
  p.B = static_cast<const float*>(B);
  p.pi = static_cast<const float*>(pi);
  p.eps = eps;
  p.words = static_cast<const uint32_t*>(words);
  p.values = static_cast<const float*>(values);
  p.threads = phi_cta_threads(threads);
  p.stream = static_cast<cudaStream_t>(stream);
  return p;
}

}  // namespace
