// The out-of-core chunk contract of the carry route, shared by K8
// (MTTKRP, mttkrp_oriented.cu) and K9 (Φ, phi_oriented.cu).
//
// Replaces the carry_in / final / carry_out hooks of _carry_step
// (src/repro/kernels/mttkrp_oriented.py:254), which the chunk kernels
// mttkrp_oriented_carry_chunk_pallas (:541) and
// phi_oriented_carry_chunk_pallas (:637) thread through a sequential grid.
//
// A chunk is a block_m-multiple slice of the padded row-sorted stream; the
// chunked executor (kernels/ops.py) hands the chunks over in stream order
// with a running out (I_n, R) and the open run of the stream so far, as
// (carry_row (1,) int32, carry_val (1, R) float32), row -1 for none.
// launch_carry_chunk (K8) runs two kernels on one stream; K9
// (phi_oriented.cu) runs the same two with K5's runs pass
// (phi_carry_runs_kernel, phi_scan.cuh) in the first place:
//   1. carry_runs_kernel<Term> (alto_scan.cuh) over the chunk's blocks:
//      inner runs are stored straight into the running out (their rows
//      appear in no other chunk, so a store equals an add to zero); each
//      block's first and last runs go to the pieces buffer (n_blocks, 2).
//   2. carry_fixup_chunk_kernel: carry_fixup_kernel's chain walk
//      (mttkrp_oriented.cu) with the chunk contract:
//      (a) the chain whose row equals carry_row at the chunk's first piece
//          starts its sum from carry_val, not from the piece;
//      (b) a carry-in whose row does not continue here is stored to
//          out[carry_row]: its run closed on the chunk boundary;
//      (c) in a non-final chunk the chain holding the chunk's last piece
//          goes to (cout_row, cout_val), not to out;
//      (d) the final chunk stores that chain too, and leaves an empty
//          carry (-1, zeros).
// Every chain is a left fold with __fadd_rn in block order: in core, a
// row's pieces p0, p1, ... sum as ((p0 + p1) + p2) ...; chunked, the fold
// reaching a chunk's end travels as carry_val and continues with the next
// chunk's pieces. So a chunked run is bit for bit the in-core K1/K5 run at
// equal block_m.
//
// What bounds it: the runs pass is K1/K5 over the chunk (bytes: the chunk
// stream, the gathered factor rows or Π, out); the fix-up reads 2·R+2
// words per block. cin and cout must be distinct buffers.
#pragma once

#include "alto_scan.cuh"

namespace {

__global__ void carry_fixup_chunk_kernel(
    const int* __restrict__ carry_row, const float* __restrict__ carry_val,
    int64_t n_pieces, int R, int r_block, const int* __restrict__ cin_row,
    const float* __restrict__ cin_val, int final_chunk,
    float* __restrict__ out, int* __restrict__ cout_row,
    float* __restrict__ cout_val) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (p >= n_pieces) return;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const bool writes_rows = threadIdx.x == 0 && blockIdx.y == 0;
  const int row = carry_row[p];
  const int crow = cin_row[0];
  if (p == 0) {
    if (crow >= 0 && crow != row)                           // (b)
      out[static_cast<int64_t>(crow) * R + r] = cin_val[r];
    if (final_chunk) {                                      // (d)
      if (writes_rows) cout_row[0] = -1;
      cout_val[r] = 0.0f;
    }
  }
  if (row < 0) return;
  const int64_t b = p / 2;
  if (p == 2 * b && b > 0) {
    int prev = carry_row[p - 1];          // previous block's last run ...
    if (prev < 0) prev = carry_row[p - 2];  // ... or its only one
    if (prev == row) return;              // not the head of its chain
  }
  float acc = carry_val[p * R + r];
  if (p == 0 && crow == row) acc = __fadd_rn(cin_val[r], acc);   // (a)
  int64_t q = p;
  for (;;) {
    const int64_t qb = q / 2;
    // A first run followed by a last run in the same block: the next
    // piece holds another row.
    if (q == 2 * qb && carry_row[q + 1] >= 0) break;
    const int64_t nq = 2 * (qb + 1);
    if (nq >= n_pieces || carry_row[nq] != row) break;
    acc = __fadd_rn(acc, carry_val[nq * R + r]);
    q = nq;
  }
  const bool holds_last =
      q == n_pieces - 1 || (q == n_pieces - 2 && carry_row[q + 1] < 0);
  if (holds_last && !final_chunk) {                          // (c)
    if (writes_rows) cout_row[0] = row;
    cout_val[r] = acc;
  } else {
    out[static_cast<int64_t>(row) * R + r] = acc;
  }
}

// The chunk fix-up over the pieces (n_blocks, 2) of a chunk's runs pass.
inline int launch_carry_fixup_chunk(int R, int r_block, int slices_per_cta,
                                    long long n_blocks,
                                    const void* pieces_row,
                                    const void* pieces_val,
                                    const void* cin_row, const void* cin_val,
                                    int final_chunk, void* out,
                                    void* cout_row, void* cout_val,
                                    void* stream) {
  if (n_blocks < 1 || bad_tiling(R, r_block, slices_per_cta))
    return static_cast<int>(cudaErrorInvalidValue);
  carry_fixup_chunk_kernel<<<grid_for(2 * n_blocks, slices_per_cta, R,
                                      r_block),
                             dim3(r_block, slices_per_cta), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pieces_row),
      static_cast<const float*>(pieces_val), 2 * n_blocks, R, r_block,
      static_cast<const int*>(cin_row), static_cast<const float*>(cin_val),
      final_chunk, static_cast<float*>(out), static_cast<int*>(cout_row),
      static_cast<float*>(cout_val));
  return static_cast<int>(cudaGetLastError());
}

// K8: K1's runs pass over the chunk, then the chunk fix-up.
template <class Term>
int launch_carry_chunk(const AltoArgs& a, const Term& term, const void* rows,
                       const void* words, const void* values,
                       long long block_m, long long n_blocks, int r_block,
                       int slices_per_cta, void* out, void* pieces_row,
                       void* pieces_val, const void* cin_row,
                       const void* cin_val, int final_chunk, void* cout_row,
                       void* cout_val, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int status = launch_carry_runs(a, term, rows, words, values, block_m,
                                       n_blocks, r_block, slices_per_cta,
                                       out, pieces_row, pieces_val, stream);
  if (status != 0) return status;
  return launch_carry_fixup_chunk(a.rank, r_block, slices_per_cta, n_blocks,
                                  pieces_row, pieces_val, cin_row, cin_val,
                                  final_chunk, out, cout_row, cout_val,
                                  stream);
}

}  // namespace
