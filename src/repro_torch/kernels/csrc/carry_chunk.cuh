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
// with a running out (I_n, R), zeroed once per call, and the open run of
// the stream so far, as (carry_row (1,) int32, carry_val (1, R) float32),
// row -1 for none. A chunk runs two kernels on one stream:
//   1. a runs pass over the chunk's blocks: K1's (mttkrp_carry_runs_kernel,
//      alto_scan.cuh, without zeroing gap rows: a chunk cannot see the
//      previous chunk's last row, and out holds zeros) for K8, K5's
//      (phi_carry_runs_kernel, phi_scan.cuh) for K9. Inner runs are stored
//      straight into the running out (their rows appear in no other
//      chunk, so a store equals an add to zero); each block's first and
//      last runs go to the pieces buffer (n_blocks, 2).
//   2. the fix-up walk (carry_fixup.cuh) with the chunk contract:
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
#include "carry_fixup.cuh"

namespace {

// The chunk fix-up over the pieces (n_blocks, 2) of a chunk's runs pass,
// rank tile r_block, CTAs of `threads`.
inline int launch_carry_fixup_chunk(int R, int r_block, int threads,
                                    long long n_blocks,
                                    const void* pieces_row,
                                    const void* pieces_val,
                                    const void* cin_row, const void* cin_val,
                                    int final_chunk, void* out,
                                    void* cout_row, void* cout_val,
                                    cudaStream_t stream) {
  if (n_blocks < 1 || cin_row == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FixupArgs f{};
  f.tenants = 1;
  f.row = static_cast<const int*>(pieces_row);
  f.val = static_cast<const float*>(pieces_val);
  f.n = 2 * n_blocks;
  f.slots = 2;
  f.R = R;
  f.rb = r_block;
  f.out = static_cast<float*>(out);
  f.ck.cin_row = static_cast<const int*>(cin_row);
  f.ck.cin_val = static_cast<const float*>(cin_val);
  f.ck.final_chunk = final_chunk;
  f.ck.cout_row = static_cast<int*>(cout_row);
  f.ck.cout_val = static_cast<float*>(cout_val);
  return launch_carry_fixup(f, threads, stream);
}

}  // namespace
