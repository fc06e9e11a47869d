// Output-oriented MTTKRP on Hopper: the carry kernel (K1), its fix-up pass,
// and the per-block partials kernel (K2).
//
// Replaces, in src/repro/kernels/mttkrp_oriented.py:
//   K1  mttkrp_oriented_carry_pallas (:358; body _mttkrp_carry_kernel :333,
//       _carry_step :254) — a sequential grid whose carry scratch hands the
//       open run of one block to the next;
//   K2  mttkrp_oriented_partials_pallas (:132; body :108) — per-block run
//       sums as a one-hot (block_m x block_m) matmul on the MXU;
// and the boundary merge ops.segment_merge (src/repro/kernels/ops.py:171).
//
// Design. The input is the row-sorted stream of one mode (rows, words,
// values), padded to a multiple of block_m. A thread owns one rank column
// of one block_m slice and walks the slice in stream order, summing each
// run of equal rows (no one-hot: the GPU has no use for it). Blocks of
// threads run in parallel and in no order, so nothing is carried from one
// slice to the next inside the kernel:
//   * K1 stores every run that begins and ends inside its slice straight
//     to out (that row has no other nonzeros), and the slice's first and
//     last runs, with their rows, to a carries buffer (n_blocks, 2, R).
//   * carry_fixup then adds the carried pieces of each row in block order:
//     the thread that owns a chain head walks forward while the row
//     repeats. Deterministic, no float atomics.
//   * K2 writes slot j of block b = the sum of the block's j-th run (zeros
//     in unused slots), the JAX partials layout; the port's segment_merge
//     stores the inner runs and sends the first/last runs through the same
//     carry_fixup. So K1 and K2+segment_merge add the same pieces in the
//     same order and agree bit for bit.
//
// What bounds it on an H100: bytes. Each nonzero reads its row (4 B), its
// words (4·W B), its value (4 B) and, per rank column, one factor entry of
// each other mode (gathers, mostly from L2 when the factors fit in 50 MB);
// the output is written once. K2 also writes the (M, R) partials that the
// merge reads back — the round trip the carry design removes. A thread
// walks its slice serially, so a slice's dependent loads are latency
// bound; the design answers with many slices in flight (block_m chosen so
// the card holds several waves) rather than with shared-memory staging,
// which is later work.
#include "alto_decode.cuh"

namespace {

__global__ void carry_runs_kernel(const __grid_constant__ AltoArgs a,
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
    acc = __fadd_rn(acc, alto_contrib(a, words, values, i, r));
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

// Pieces are numbered p = 2·b + slot (slot 0: first run, slot 1: last run,
// row -1 when absent). A row's pieces are consecutive present pieces.
__global__ void carry_fixup_kernel(const int* __restrict__ carry_row,
                                   const float* __restrict__ carry_val,
                                   int64_t n_pieces, int R, int r_block,
                                   float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (p >= n_pieces) return;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const int row = carry_row[p];
  if (row < 0) return;
  const int64_t b = p >> 1;
  if ((p & 1) == 0 && b > 0) {
    int prev = carry_row[2 * b - 1];     // previous block's last run ...
    if (prev < 0) prev = carry_row[2 * b - 2];  // ... or its only run
    if (prev == row) return;             // not the head of its chain
  }
  float acc = carry_val[p * R + r];
  int64_t q = p;
  for (;;) {
    const int64_t qb = q >> 1;
    // A first run followed by a last run in the same block: the next
    // piece holds another row.
    if ((q & 1) == 0 && carry_row[2 * qb + 1] >= 0) break;
    const int64_t nq = 2 * (qb + 1);
    if (nq >= n_pieces || carry_row[nq] != row) break;
    acc = __fadd_rn(acc, carry_val[nq * R + r]);
    q = nq;
  }
  out[static_cast<int64_t>(row) * R + r] = acc;
}

__global__ void oriented_partials_kernel(
    const __grid_constant__ AltoArgs a, const int* __restrict__ rows,
    const uint32_t* __restrict__ words, const float* __restrict__ values,
    int64_t block_m, int64_t n_blocks, int r_block,
    float* __restrict__ partials) {
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
    acc = __fadd_rn(acc, alto_contrib(a, words, values, i, r));
  }
  pb[j * R] = acc;
  for (++j; j < block_m; ++j) pb[j * R] = 0.0f;
}

dim3 grid_for(int64_t n, int slices_per_cta, int rank, int r_block) {
  return dim3(static_cast<unsigned>((n + slices_per_cta - 1) /
                                    slices_per_cta),
              static_cast<unsigned>(rank / r_block));
}

bool bad_tiling(int rank, int r_block, int slices_per_cta) {
  return r_block < 1 || rank % r_block != 0 || slices_per_cta < 1 ||
         r_block * slices_per_cta > 1024;
}

}  // namespace

extern "C" {

// K1, first pass. out must hold zeros; inner runs are stored into it.
int alto_carry_runs(const int64_t* factor_ptrs, const int* runs, int n_runs,
                    int ndim, int nwords, int mode, int rank,
                    const void* rows, const void* words, const void* values,
                    long long block_m, long long n_blocks, int r_block,
                    int slices_per_cta, void* out, void* carry_row,
                    void* carry_val, void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      bad_tiling(rank, r_block, slices_per_cta) || block_m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  carry_runs_kernel<<<grid_for(n_blocks, slices_per_cta, rank, r_block),
                      dim3(r_block, slices_per_cta), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(rows), static_cast<const uint32_t*>(words),
      static_cast<const float*>(values), block_m, n_blocks, r_block,
      static_cast<float*>(out), static_cast<int*>(carry_row),
      static_cast<float*>(carry_val));
  return static_cast<int>(cudaGetLastError());
}

// K1, second pass (also the deterministic half of segment_merge).
int alto_carry_fixup(const void* carry_row, const void* carry_val,
                     long long n_pieces, int rank, int r_block,
                     int slices_per_cta, void* out, void* stream) {
  if (bad_tiling(rank, r_block, slices_per_cta))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces == 0) return 0;
  carry_fixup_kernel<<<grid_for(n_pieces, slices_per_cta, rank, r_block),
                       dim3(r_block, slices_per_cta), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(carry_row),
      static_cast<const float*>(carry_val), n_pieces, rank, r_block,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K2. partials is (n_blocks, block_m, rank); every slot is written.
int alto_oriented_partials(const int64_t* factor_ptrs, const int* runs,
                           int n_runs, int ndim, int nwords, int mode,
                           int rank, const void* rows, const void* words,
                           const void* values, long long block_m,
                           long long n_blocks, int r_block,
                           int slices_per_cta, void* partials,
                           void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      bad_tiling(rank, r_block, slices_per_cta) || block_m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  oriented_partials_kernel<<<grid_for(n_blocks, slices_per_cta, rank,
                                      r_block),
                             dim3(r_block, slices_per_cta), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(rows), static_cast<const uint32_t*>(words),
      static_cast<const float*>(values), block_m, n_blocks, r_block,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
