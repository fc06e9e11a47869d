// The stream traversals of the MTTKRP kernels and of K6:
//   mttkrp_carry_runs_kernel  K1 (MTTKRP) runs pass; K8 on one chunk
//   oriented_partials_kernel  K2 (MTTKRP) and K6 (Φ), generic in the term
//   recursive_partials_kernel K3 (MTTKRP), generic in the term
// (The Φ carry and recursive routes, K5, K9 and K7, have their own
// sub-warp traversals in phi_scan.cuh; the carry route's fix-up is
// carry_fixup.cuh.)
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
// K2, K6 and K3 keep a thread per rank column of one slice (a block_m
// slice, or one ALTO partition) walking it in stream order, generic in a
// Term functor `float operator()(a, words, values, i, row, r)`
// (`MttkrpTerm` below, `PhiTerm` in phi_update.cuh): threadIdx.x is the
// column inside the rank tile, threadIdx.y the slice inside the CTA,
// blockIdx.y the rank tile. One nonzero in flight per thread keeps them
// latency bound; K3 also keeps its Temp in device memory.
//
// Summation order, shared by all: a run or a Temp row sums its terms in
// stream order, from 0.0, with __fadd_rn; a term rounds as MttkrpTerm
// (or PhiTerm). So K1 ≡ K2 + segment_merge bit for bit.
#pragma once

#include "alto_decode.cuh"

namespace {

struct MttkrpTerm {
  __device__ __forceinline__ float operator()(const AltoArgs& a,
                                              const uint32_t* words,
                                              const float* values, int64_t i,
                                              int /*row*/, int r) const {
    return alto_contrib(a, words, values, i, r);
  }
};

// K1's lanes: lane l of a sub-warp holds columns l·COLS + c of the rank
// tile, contiguous, so its four columns move as one float4 where the rows
// are 4-float aligned (`vec4`); on an H100 this ran faster than K5's
// layout (columns c·W + l). Two nonzeros in flight per sub-warp
// (K1_UNROLL): at rank 16 (700 W) K1's runs pass took 2.08 ms on DARPA
// mode 2 against 2.30 ms with four and 3.47 ms with one
// (tools/torch_mttkrp_lane_maps.py).
constexpr int K1_UNROLL = 2;

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

// Rows [r0, r1) of out get zeros in this rank tile's columns: the rows
// the stream skips, which K1 owns because its wrapper does not zero out.
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
// live[u]): term[u][c] for column col0 + lane·COLS + c. The words are
// decoded through the byte tables; each lane gathers its own factor
// entries, so a factor row is read once, a float4 a lane.
// Rounding is MttkrpTerm's: the other modes' entries multiplied in
// increasing mode order, then scaled by the value, all __fmul_rn.
template <int COLS, int U>
__device__ __forceinline__ void mttkrp_subwarp_terms(
    const AltoArgs& a, const uint32_t* __restrict__ words,
    const float* __restrict__ values, const int64_t (&idx)[U],
    const bool (&live)[U], int col0, int rb, int lane, bool vec4,
    float (&term)[U][COLS]) {
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
          a.factors[m] +
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

// K1's runs pass (and K8's, over one chunk): a sub-warp of W lanes per
// block_m slice, lane l on columns col0 + l·COLS + c of the rank tile
// blockIdx.y, U nonzeros in flight. Every run that begins and ends inside
// the slice goes straight to out (that row has no other nonzeros); the
// slice's first and last runs go, with their rows, to the carries buffer
// (n_blocks, 2, R), row -1 in slot 1 when one run covers the slice. Each
// column sums its run in stream order from 0.0 with __fadd_rn.
//
// With zero_gaps (K1) the pass also stores zeros to the rows the stream
// skips: rows strictly between two consecutive distinct rows (by the
// slice holding the later one; slice b reads rows[s - 1]), rows below the
// first row (slice 0) and above the last (the last slice). With the fix-up
// storing the pieces' rows, every row of out is written exactly once and
// the wrapper allocates out without zeroing it. K8 (zero_gaps false) adds
// into a running out that its executor zeroes once.
template <int W, int COLS, int U>
__global__ void mttkrp_carry_runs_kernel(
    const __grid_constant__ AltoArgs a, const int* __restrict__ rows,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    int64_t block_m, int64_t n_blocks, int r_block, int n_rows,
    bool zero_gaps, bool vec4, float* __restrict__ out,
    int* __restrict__ carry_row, float* __restrict__ carry_val) {
  const int lane = threadIdx.x % W;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x / W) +
                    threadIdx.x / W;
  if (b >= n_blocks) return;           // the whole sub-warp leaves
  const int R = a.rank;
  const int col0 = blockIdx.y * r_block;
  float* const out0 = out + col0;      // this rank tile's columns
  const bool writes_rows = lane == 0 && blockIdx.y == 0;
  const int64_t s = b * block_m;
  const int64_t e = s + block_m;
  int cur = __ldg(rows + s);
  if (zero_gaps)
    zero_rows<COLS>(out0, b == 0 ? 0 : __ldg(rows + s - 1) + 1, cur, R,
                    r_block, lane, vec4);
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  bool first = true;
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
    mttkrp_subwarp_terms<COLS, U>(a, words, values, idx, live, col0,
                                  r_block, lane, vec4, term);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) break;
      if (row[u] != cur) {
        float* dst;
        if (first) {
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

// Slot j of slice b = the sum of the slice's j-th run, zeros in unused
// slots: the JAX partials layout.
template <class Term>
__global__ void oriented_partials_kernel(
    const __grid_constant__ AltoArgs a, const Term term,
    const int* __restrict__ rows, const uint32_t* __restrict__ words,
    const float* __restrict__ values, int64_t block_m, int64_t n_blocks,
    int r_block, float* __restrict__ partials) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (b >= n_blocks) return;
  const int R = a.rank;
  const int r = blockIdx.y * r_block + threadIdx.x;
  float* pb = partials + b * block_m * R + r;
  const int64_t s = b * block_m;
  const int64_t e = s + block_m;
  int cur = __ldg(rows + s);
  float acc = 0.0f;
  int64_t j = 0;
  for (int64_t i = s; i < e; ++i) {
    const int row = __ldg(rows + i);
    if (row != cur) {
      pb[j * R] = acc;
      ++j;
      cur = row;
      acc = 0.0f;
    }
    acc = __fadd_rn(acc, term(a, words, values, i, row, r));
  }
  pb[j * R] = acc;
  for (++j; j < block_m; ++j) pb[j * R] = 0.0f;
}

// Partition l of the ALTO-ordered stream adds each nonzero's term at
// Temp_l[row - part_start[l, mode]] of the (L, temp_rows, R) buffer, which
// the wrapper zeroes. No two threads touch one address: no atomics.
template <class Term>
__global__ void recursive_partials_kernel(
    const __grid_constant__ AltoArgs a, const Term term,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    const int* __restrict__ part_start, int64_t n_parts, int64_t chunk,
    int64_t temp_rows, int r_block, float* __restrict__ temp) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (l >= n_parts) return;
  const int R = a.rank;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const int start = __ldg(part_start + l * a.ndim + a.mode);
  float* tl = temp + l * temp_rows * R + r;
  const int64_t s = l * chunk;
  for (int64_t i = s; i < s + chunk; ++i) {
    const int row = alto_coord(a, words + i * a.nwords, a.mode);
    float* p = tl + static_cast<int64_t>(row - start) * R;
    *p = __fadd_rn(*p, term(a, words, values, i, row, r));
  }
}

inline dim3 grid_for(int64_t n, int slices_per_cta, int rank, int r_block) {
  return dim3(static_cast<unsigned>((n + slices_per_cta - 1) /
                                    slices_per_cta),
              static_cast<unsigned>(rank / r_block));
}

inline bool bad_tiling(int rank, int r_block, int slices_per_cta) {
  return r_block < 1 || rank % r_block != 0 || slices_per_cta < 1 ||
         r_block * slices_per_cta > 1024;
}

template <class Term>
int launch_oriented_partials(const AltoArgs& a, const Term& term,
                             const void* rows, const void* words,
                             const void* values, long long block_m,
                             long long n_blocks, int r_block,
                             int slices_per_cta, void* partials,
                             void* stream) {
  if (bad_tiling(a.rank, r_block, slices_per_cta) || block_m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  oriented_partials_kernel<Term>
      <<<grid_for(n_blocks, slices_per_cta, a.rank, r_block),
         dim3(r_block, slices_per_cta), 0,
         static_cast<cudaStream_t>(stream)>>>(
          a, term, static_cast<const int*>(rows),
          static_cast<const uint32_t*>(words),
          static_cast<const float*>(values), block_m, n_blocks, r_block,
          static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

template <class Term>
int launch_recursive_partials(const AltoArgs& a, const Term& term,
                              const void* words, const void* values,
                              const void* part_start, long long n_parts,
                              long long chunk, long long temp_rows,
                              int r_block, int slices_per_cta, void* temp,
                              void* stream) {
  if (bad_tiling(a.rank, r_block, slices_per_cta) || chunk < 0 ||
      temp_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_parts == 0) return 0;
  recursive_partials_kernel<Term>
      <<<grid_for(n_parts, slices_per_cta, a.rank, r_block),
         dim3(r_block, slices_per_cta), 0,
         static_cast<cudaStream_t>(stream)>>>(
          a, term, static_cast<const uint32_t*>(words),
          static_cast<const float*>(values),
          static_cast<const int*>(part_start), n_parts, chunk, temp_rows,
          r_block, static_cast<float*>(temp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
