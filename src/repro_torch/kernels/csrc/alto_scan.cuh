// The stream traversals of the MTTKRP kernels and of K6, each generic in
// the per-nonzero term it sums:
//   carry_runs_kernel         K1 (MTTKRP) first pass; K8 on one chunk
//   oriented_partials_kernel  K2 (MTTKRP) and K6 (Φ)
//   recursive_partials_kernel K3 (MTTKRP)
// (The Φ carry and recursive routes, K5, K9 and K7, have their own
// sub-warp traversals in phi_scan.cuh.)
// A Term is a functor `float operator()(a, words, values, i, row, r)`: the
// contribution of nonzero i to rank column r of output row `row`
// (`MttkrpTerm` below, `PhiTerm` in phi_update.cuh). One template for both
// drivers keeps the MTTKRP and Φ kernels on one summation order: a run or
// a Temp row sums its terms in stream order, from 0.0, with __fadd_rn.
//
// Thread map: a thread owns one rank column r of one slice (a block_m
// slice of the row-sorted stream, or one ALTO partition) and walks the
// slice in stream order. threadIdx.x is the column inside the rank tile,
// threadIdx.y the slice inside the CTA, blockIdx.y the rank tile.
//
// What bounds them on an H100: a thread's walk of its slice is one
// dependent chain per nonzero (decode, gather, add), so with one nonzero
// in flight per thread they are latency bound, far above the bytes they
// move; K3 also keeps its Temp in device memory. Their redesigns (a
// sub-warp per slice as in phi_scan.cuh; Temp in shared memory) are later
// work.
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

// First pass of the carry route. Every run that begins and ends inside the
// slice goes straight to out (that row has no other nonzeros); the slice's
// first and last runs go, with their rows, to the carries buffer
// (n_blocks, 2, R), row -1 in slot 1 when one run covers the slice.
template <class Term>
__global__ void carry_runs_kernel(const __grid_constant__ AltoArgs a,
                                  const Term term,
                                  const int* __restrict__ rows,
                                  const uint32_t* __restrict__ words,
                                  const float* __restrict__ values,
                                  int64_t block_m, int64_t n_blocks,
                                  int r_block, float* __restrict__ out,
                                  int* __restrict__ carry_row,
                                  float* __restrict__ carry_val) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (b >= n_blocks) return;
  const int R = a.rank;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const bool writes_rows = threadIdx.x == 0 && blockIdx.y == 0;
  const int64_t s = b * block_m;
  const int64_t e = s + block_m;
  int cur = __ldg(rows + s);
  float acc = 0.0f;
  bool first = true;
  for (int64_t i = s; i < e; ++i) {
    const int row = __ldg(rows + i);
    if (row != cur) {
      if (first) {
        if (writes_rows) carry_row[2 * b] = cur;
        carry_val[(2 * b) * R + r] = acc;
        first = false;
      } else {
        out[static_cast<int64_t>(cur) * R + r] = acc;
      }
      cur = row;
      acc = 0.0f;
    }
    acc = __fadd_rn(acc, term(a, words, values, i, row, r));
  }
  if (first) {  // one run covers the slice: it is the first piece only
    if (writes_rows) {
      carry_row[2 * b] = cur;
      carry_row[2 * b + 1] = -1;
    }
    carry_val[(2 * b) * R + r] = acc;
    carry_val[(2 * b + 1) * R + r] = 0.0f;
  } else {
    if (writes_rows) carry_row[2 * b + 1] = cur;
    carry_val[(2 * b + 1) * R + r] = acc;
  }
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
int launch_carry_runs(const AltoArgs& a, const Term& term, const void* rows,
                      const void* words, const void* values,
                      long long block_m, long long n_blocks, int r_block,
                      int slices_per_cta, void* out, void* carry_row,
                      void* carry_val, void* stream) {
  if (bad_tiling(a.rank, r_block, slices_per_cta) || block_m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  carry_runs_kernel<Term>
      <<<grid_for(n_blocks, slices_per_cta, a.rank, r_block),
         dim3(r_block, slices_per_cta), 0,
         static_cast<cudaStream_t>(stream)>>>(
          a, term, static_cast<const int*>(rows),
          static_cast<const uint32_t*>(words),
          static_cast<const float*>(values), block_m, n_blocks, r_block,
          static_cast<float*>(out), static_cast<int*>(carry_row),
          static_cast<float*>(carry_val));
  return static_cast<int>(cudaGetLastError());
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
