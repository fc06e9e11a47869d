// The stream traversals of the MTTKRP kernels:
//   mttkrp_carry_runs_kernel     K1 (MTTKRP) runs pass; K8 on one chunk;
//                                K2 (MTTKRP) with a pointer to the slots
//   mttkrp_partials_smem_kernel  K3 (MTTKRP), one CTA per ALTO partition
// (The Φ routes, K5, K6, K7 and K9, have their sub-warp traversals in
// phi_scan.cuh; the carry route's fix-up is carry_fixup.cuh and
// segment_merge's split segment_split.cuh.)
//
// K1's runs pass replaces the sequential scan of mttkrp_oriented_carry_pallas
// (src/repro/kernels/mttkrp_oriented.py:358; body :333, _carry_step :254).
// Its lane map follows K5's (phi_scan.cuh): a sub-warp of W lanes owns one
// block_m slice and each lane about four rank columns of the rank tile
// (blockIdx.y), contiguous (lane l on l·COLS + c). Per nonzero the
// sub-warp decodes the words once through the byte tables
// (alto_coord_table) and each lane gathers its own factor entries, so a
// factor row is read once, a float4 a lane; K1_UNROLL nonzeros are
// interleaved, their loads issued first; the run sums stay in registers.
// What bounds it on an H100: bytes — the stream (row, words, value), the
// gathered factor rows and out, each once — if enough loads are in
// flight; the thread-per-column walk it replaces decoded every nonzero
// once per rank column with one nonzero in flight.
//
// K2 replaces mttkrp_oriented_partials_pallas (src/repro/kernels/
// mttkrp_oriented.py:132), which sums each block's runs through a one-hot
// (block_m x block_m) matmul. It is K1's runs pass in its slot layout
// (the flag SLOTS) over the (n_blocks, block_m, R) slots: a finished run
// goes to the slice's next slot instead of out or the carries, the unused
// slots get zeros, and no gap zeros are stored — as K6 is K5's pass
// (phi_carry_runs_kernel).
// Every slot is written, so the wrapper allocates the slots unzeroed. It
// moves the M·R·4 bytes of slots on top of K1's traffic, and ops.
// segment_merge reads the used ones back (segment_split.cuh).
//
// K3 (mttkrp_partials_smem_kernel) replaces mttkrp_partials_pallas
// (src/repro/kernels/mttkrp.py:75), which scatters a partition into its
// Temp through a one-hot (chunk x temp_rows) matmul. It is K7's form
// (phi_partials_smem_kernel, phi_scan.cuh) over the MTTKRP term: one CTA
// per partition and rank tile, the Temp window in shared memory; the
// sub-warps form the terms of a staging tile of nonzeros in parallel with
// K1's lanes and loads, then each Temp row adds its tile terms in stream
// order. Every Temp entry is stored once, at the end of its window. A
// bucket's tenants are its grid's z axis, as K1's.
//
// Summation order, shared by all: a run or a Temp entry sums its terms in
// stream order, from 0.0, with __fadd_rn; a term is the other modes'
// factor entries multiplied in increasing mode order, then by the value,
// all __fmul_rn (mttkrp_subwarp_terms). K1 and K2 run the same loop, so
// K1 ≡ K2 + segment_merge bit for bit, and K3 equals its plain version.
#pragma once

#include "alto_decode.cuh"

namespace {

// K1's lanes: lane l of a sub-warp holds columns l·COLS + c of the rank
// tile, contiguous, so its four columns move as one float4 where the rows
// are 4-float aligned (`vec4`); on an H100 this ran faster than K5's
// layout (columns c·W + l). Two nonzeros in flight per sub-warp
// (K1_UNROLL): at rank 16 (700 W) K1's runs pass took 2.08 ms on DARPA
// mode 2 against 2.30 ms with four and 3.47 ms with one
// (tools/torch_mttkrp_lane_maps.py).
constexpr int K1_UNROLL = 2;

// The tenant axis (blockIdx.z) of the runs passes, the fix-up, the split
// and the recursive kernels (K3, K7): one launch over `count` tenants of
// one shape class, whose operands are stacked, each tenant's contiguous.
// A block finds its tenant from blockIdx.z and its operands from the
// strides: the factors' from factor[m], out's and B's from rows (I_n·R
// elements), the stream's, the carries' and the slots' from n_blocks and
// block_m, the recursive kernels' stream, part_start, Π and Temp from the
// partitions (gridDim.x), chunk and temp_rows (`Tenants`,
// alto_decode.cuh). Inside a tenant the tiling, the lanes and the order of
// every sum are the solo launch's, so a bucket's launch gives each tenant
// the bits of its solo launch.

// This block's tenant offsets of the factors (elements), for the term
// helpers below.
__device__ __forceinline__ void tenant_factor_offsets(
    const Tenants& tn, int64_t t, int64_t (&foff)[ALTO_MAX_MODES]) {
#pragma unroll
  for (int m = 0; m < ALTO_MAX_MODES; ++m) foff[m] = t * tn.factor[m];
}

// x[c] = p[lane·COLS + c] for the columns inside the tile's rb, else 0.
template <int COLS>
__device__ __forceinline__ void load_cols(const float* p, int rb, int lane,
                                          bool vec4, float (&x)[COLS]) {
  if constexpr (COLS == 4) {
    if (vec4 && lane * 4 + 4 <= rb) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + lane);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = lane * COLS + c;
    x[c] = col < rb ? __ldg(p + col) : 0.0f;
  }
}

// p[lane·COLS + c] = x[c] for the columns inside the tile's rb.
template <int COLS>
__device__ __forceinline__ void store_cols(float* p, int rb, int lane,
                                           bool vec4,
                                           const float (&x)[COLS]) {
  if constexpr (COLS == 4) {
    if (vec4 && lane * 4 + 4 <= rb) {
      reinterpret_cast<float4*>(p)[lane] = make_float4(x[0], x[1], x[2],
                                                       x[3]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = lane * COLS + c;
    if (col < rb) p[col] = x[c];
  }
}

// Rows [r0, r1) of out (row stride R) get zeros in this rank tile's
// columns: the rows the stream skips, which K1 owns because its wrapper
// does not zero out, or K2's unused slots.
template <int COLS>
__device__ __forceinline__ void zero_rows(float* out, int64_t r0, int64_t r1,
                                          int R, int rb, int lane,
                                          bool vec4) {
  float zero[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) zero[c] = 0.0f;
  for (int64_t r = r0; r < r1; ++r)
    store_cols<COLS>(out + r * R, rb, lane, vec4, zero);
}

// The MTTKRP terms of U nonzeros idx[u] of one sub-warp (those with
// live[u]): term[u][c] for column col0 + lane·COLS + c, factor m read at
// its tenant offset foff[m]. The words are
// decoded through the byte tables; each lane gathers its own factor
// entries, so a factor row is read once, a float4 a lane.
// Rounding: the other modes' entries multiplied in increasing mode
// order, then scaled by the value, all __fmul_rn (core.mttkrp.
// contributions, the plain versions' terms).
template <int COLS, int U>
__device__ __forceinline__ void mttkrp_subwarp_terms(
    const AltoArgs& a, const uint32_t* __restrict__ words,
    const float* __restrict__ values, const int64_t (&idx)[U],
    const bool (&live)[U], const int64_t (&foff)[ALTO_MAX_MODES], int col0,
    int rb, int lane, bool vec4, float (&term)[U][COLS]) {
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) term[u][c] = 0.0f;
    v[u] = 0.0f;
    if (!live[u]) continue;
    const uint32_t* w = words + idx[u] * a.nwords;
    bool first = true;
#pragma unroll
    for (int m = 0; m < ALTO_MAX_MODES; ++m) {
      if (m >= a.ndim || m == a.mode) continue;
      float x[COLS];
      load_cols<COLS>(
          a.factors[m] + foff[m] +
              static_cast<int64_t>(alto_coord_table(a, w, m)) * a.rank +
              col0,
          rb, lane, vec4, x);
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        term[u][c] = first ? x[c] : __fmul_rn(term[u][c], x[c]);
      first = false;
    }
    v[u] = __ldg(values + idx[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int c = 0; c < COLS; ++c) term[u][c] = __fmul_rn(v[u], term[u][c]);
}

// K1's runs pass (and K8's, over one chunk; K2's into slots): a
// sub-warp of W lanes per block_m slice, lane l on columns col0 + l·COLS +
// c of the rank tile blockIdx.y, U nonzeros in flight. Each column sums
// its run in stream order from 0.0 with __fadd_rn. Two layouts of the run
// sums:
//  * carry (K1, K8): every run that begins and ends
//    inside the slice goes straight to out (that row has no other
//    nonzeros); the slice's first and last runs go, with their rows, to
//    the carries buffer (n_blocks, 2, R), row -1 in slot 1 when one run
//    covers the slice. With zero_gaps (K1) the pass also stores zeros to
//    the rows the stream skips: rows strictly between two consecutive
//    distinct rows (by the slice holding the later one; slice b reads
//    rows[s - 1]), rows below the first row (slice 0) and above the last
//    (the last slice). With the fix-up storing the pieces' rows, every row
//    of out is written exactly once and the wrapper allocates out without
//    zeroing it. K8 (zero_gaps false) adds into a running out that its
//    executor zeroes once.
//  * SLOTS (K2): slot j of the slice's block_m slots in partials
//    (n_blocks, block_m, R) gets the slice's j-th run, the unused slots
//    zeros: the JAX partials layout that ops.segment_merge reads.
// The layout is a template flag, so K1's instantiations carry none of the
// slot layout's registers. Tenant blockIdx.z of a bucket (Tenants) walks
// its own stream into its own out, carries and slots.
template <int W, int COLS, int U, bool SLOTS>
__global__ void mttkrp_carry_runs_kernel(
    const __grid_constant__ AltoArgs a, const __grid_constant__ Tenants tn,
    const int* __restrict__ rows, const uint32_t* __restrict__ words,
    const float* __restrict__ values, int64_t block_m, int64_t n_blocks,
    int r_block, int n_rows, bool zero_gaps, bool vec4,
    float* __restrict__ out, int* __restrict__ carry_row,
    float* __restrict__ carry_val, float* __restrict__ partials) {
  const int lane = threadIdx.x % W;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x / W) +
                    threadIdx.x / W;
  if (b >= n_blocks) return;           // the whole sub-warp leaves
  const int R = a.rank;
  const int64_t t = blockIdx.z;        // the tenant
  const int64_t Mt = n_blocks * block_m;
  int64_t foff[ALTO_MAX_MODES];
  tenant_factor_offsets(tn, t, foff);
  rows += t * Mt;
  words += t * Mt * a.nwords;
  values += t * Mt;
  if (SLOTS) {
    partials += t * Mt * R;
  } else {
    out += t * tn.rows;
    carry_row += t * 2 * n_blocks;
    carry_val += t * 2 * n_blocks * R;
  }
  const int col0 = blockIdx.y * r_block;
  float* const out0 = out + col0;      // this rank tile's columns
  const bool writes_rows = lane == 0 && blockIdx.y == 0;
  const int64_t s = b * block_m;
  const int64_t e = s + block_m;
  float* const slots = SLOTS ? partials + s * R + col0 : nullptr;
  int cur = __ldg(rows + s);
  if (zero_gaps)
    zero_rows<COLS>(out0, b == 0 ? 0 : __ldg(rows + s - 1) + 1, cur, R,
                    r_block, lane, vec4);
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  bool first = true;                   // carry: no run closed yet
  int64_t j = 0;                       // SLOTS: runs closed so far
  for (int64_t i0 = s; i0 < e; i0 += U) {
    int64_t idx[U];
    bool live[U];
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      idx[u] = i0 + u;
      live[u] = idx[u] < e;
      row[u] = live[u] ? __ldg(rows + idx[u]) : cur;
    }
    float term[U][COLS];
    mttkrp_subwarp_terms<COLS, U>(a, words, values, idx, live, foff, col0,
                                  r_block, lane, vec4, term);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) break;
      if (row[u] != cur) {
        float* dst;
        if constexpr (SLOTS) {
          dst = slots + j * R;
          ++j;
        } else if (first) {
          if (writes_rows) carry_row[2 * b] = cur;
          dst = carry_val + (2 * b) * R + col0;
          first = false;
        } else {
          dst = out0 + static_cast<int64_t>(cur) * R;
        }
        store_cols<COLS>(dst, r_block, lane, vec4, acc);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
        if (zero_gaps)
          zero_rows<COLS>(out0, cur + 1, row[u], R, r_block, lane, vec4);
        cur = row[u];
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = __fadd_rn(acc[c], term[u][c]);
    }
  }
  if constexpr (SLOTS) {
    store_cols<COLS>(slots + j * R, r_block, lane, vec4, acc);
    zero_rows<COLS>(slots, j + 1, block_m, R, r_block, lane, vec4);
  } else {
    if (writes_rows) {
      if (first) {
        carry_row[2 * b] = cur;
        carry_row[2 * b + 1] = -1;
      } else {
        carry_row[2 * b + 1] = cur;
      }
    }
    store_cols<COLS>(carry_val + (first ? 2 * b : 2 * b + 1) * R + col0,
                     r_block, lane, vec4, acc);
    if (first) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
      store_cols<COLS>(carry_val + (2 * b + 1) * R + col0, r_block, lane,
                       vec4, acc);
    }
    if (zero_gaps && b == n_blocks - 1)
      zero_rows<COLS>(out0, cur + 1, n_rows, R, r_block, lane, vec4);
  }
}

// Shared memory of one recursive-traversal CTA (K3, K7): the Temp window
// (window x cols floats), with B_rows the window's B rows too (K7), the
// staging tile's terms (tile x cols floats) and its local rows (tile
// ints). kernels/common.py `smem_bytes` is the same rule.
inline size_t partials_smem_bytes(int cols, int window, int tile,
                                  bool b_rows) {
  return (static_cast<size_t>((b_rows ? 2 : 1) * window + tile) * cols +
          tile) * 4;
}

// row[c] += t[c] (__fadd_rn) for the lane's columns lane·COLS + c inside
// rb, both in shared memory; a float4 where `vec4`.
template <int COLS>
__device__ __forceinline__ void smem_add_cols(float* row, const float* t,
                                              int rb, int lane, bool vec4) {
  if constexpr (COLS == 4) {
    if (vec4 && lane * 4 + 4 <= rb) {
      float4* r4 = reinterpret_cast<float4*>(row) + lane;
      const float4 x = reinterpret_cast<const float4*>(t)[lane];
      float4 y = *r4;
      y.x = __fadd_rn(y.x, x.x);
      y.y = __fadd_rn(y.y, x.y);
      y.z = __fadd_rn(y.z, x.z);
      y.w = __fadd_rn(y.w, x.w);
      *r4 = y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = lane * COLS + c;
    if (col < rb) row[col] = __fadd_rn(row[col], t[col]);
  }
}

// K3: one CTA per partition l (blockIdx.x) and rank tile blockIdx.y of
// r_block columns; Temp_l (temp_rows, R) built in shared memory, `window`
// rows at a time, and every entry stored once, at the end of its window.
//
// A window walks the partition in tiles of `tile` nonzeros. Term phase:
// sub-warp q of W lanes forms the terms of nonzeros q·U .. q·U+U-1 of the
// tile (then the next nsub·U), K1's lanes and loads (mttkrp_subwarp_terms),
// into the staging tile in shared memory, with the nonzero's row in the
// window (-1 outside it: no loads). Sum phase: sub-warp q owns the window
// rows with row % nsub == q, its lanes their columns; a warp reads 32
// slot rows at a time and a ballot per sub-warp marks the slots of its
// rows, which it adds in slot (stream) order. So each Temp entry receives
// its terms in stream order from 0.0 whatever the window height, the tile
// size or the lane map: the bits of recursive_partials_plain.
//
// With BUCKET, tenant blockIdx.z of a bucket (Tenants) walks its own
// partitions: its words, values and part_start at gridDim.x partitions
// of `chunk` nonzeros a tenant, its factors at tn.factor, its Temp at
// gridDim.x · temp_rows rows. Inside a tenant the CTA's work is the solo
// launch's. A solo launch runs the instantiation without BUCKET, whose
// tenant offsets are constant zeros.
template <int W, int COLS, int U, bool BUCKET>
__global__ void mttkrp_partials_smem_kernel(
    const __grid_constant__ AltoArgs a, const __grid_constant__ Tenants tn,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    const int* __restrict__ part_start, int64_t chunk, int64_t temp_rows,
    int r_block, int window, int tile, bool vec4,
    float* __restrict__ temp) {
  extern __shared__ __align__(16) float k3_smem[];
  const int R = a.rank;
  const int rb = r_block;
  const int col0 = blockIdx.y * rb;
  float* s_temp = k3_smem;
  float* s_term = s_temp + window * rb;
  int* s_row = reinterpret_cast<int*>(s_term + tile * rb);
  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % W;
  const int sub = tid / W;
  const int nsub = nthreads / W;
  const int wl = tid & 31;                 // lane in the warp
  const int warp_sub = (tid - wl) / W;     // the warp's first sub-warp
  const int64_t z = BUCKET ? blockIdx.z : 0;   // the tenant
  const int64_t L = gridDim.x;
  int64_t foff[ALTO_MAX_MODES];
  tenant_factor_offsets(tn, z, foff);
  words += z * L * chunk * a.nwords;
  values += z * L * chunk;
  part_start += z * L * a.ndim;
  temp += z * L * temp_rows * R;
  const int start = __ldg(part_start + l * a.ndim + a.mode);
  const int64_t s = l * chunk;
  for (int64_t w0 = 0; w0 < temp_rows; w0 += window) {
    const int h = static_cast<int>(
        temp_rows - w0 < window ? temp_rows - w0 : window);
    const int64_t base = start + w0;
    for (int k = tid; k < h * rb; k += nthreads) s_temp[k] = 0.0f;
    __syncthreads();
    for (int64_t t0 = 0; t0 < chunk; t0 += tile) {
      const int n = static_cast<int>(chunk - t0 < tile ? chunk - t0 : tile);
      for (int j0 = sub * U; j0 < n; j0 += nsub * U) {
        int64_t idx[U];
        bool live[U];
        int local[U];
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
        }
        float term[U][COLS];
        mttkrp_subwarp_terms<COLS, U>(a, words, values, idx, live, foff,
                                      col0, rb, lane, vec4, term);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u >= n) break;
          if (lane == 0) s_row[j0 + u] = local[u];
          if (live[u])
            store_cols<COLS>(s_term + (j0 + u) * rb, rb, lane, vec4,
                             term[u]);
        }
      }
      __syncthreads();
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
          smem_add_cols<COLS>(s_temp + s_row[j] * rb, s_term + j * rb, rb,
                              lane, vec4);
        }
      }
      __syncthreads();
    }
    float* tl = temp + (l * temp_rows + w0) * R + col0;
    if (vec4) {
      const int q = rb / 4;
      for (int k = tid; k < h * q; k += nthreads)
        reinterpret_cast<float4*>(tl + static_cast<int64_t>(k / q) * R)[k % q] =
            reinterpret_cast<const float4*>(s_temp)[k];
    } else {
      for (int k = tid; k < h * rb; k += nthreads)
        tl[static_cast<int64_t>(k / rb) * R + k % rb] = s_temp[k];
    }
    __syncthreads();
  }
}

// Runs L<W, COLS>::run(args) for K1's lane map (lanes, cols): a sub-warp
// of `lanes` lanes, `cols` contiguous columns a lane (kernels/
// mttkrp_oriented.py `LANE_MAPS`, shared by K1, K8 and K3). Only these
// maps are built; any other is refused.
template <template <int, int> class L, class Args>
int k1_lane_dispatch(int lanes, int cols, const Args& args) {
  if (lanes == 2 && cols == 4) return L<2, 4>::run(args);
  if (lanes == 4 && cols == 4) return L<4, 4>::run(args);
  if (lanes == 8 && cols == 4) return L<8, 4>::run(args);
  if (lanes == 32 && cols == 4) return L<32, 4>::run(args);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
