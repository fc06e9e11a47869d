// Output-oriented MTTKRP on Hopper: the carry kernel (K1), its fix-up pass,
// the per-block partials kernel (K2), and the out-of-core chunk kernel (K8).
//
// Replaces, in src/repro/kernels/mttkrp_oriented.py:
//   K1  mttkrp_oriented_carry_pallas (:358; body _mttkrp_carry_kernel :333,
//       _carry_step :254) — a sequential grid whose carry scratch hands the
//       open run of one block to the next;
//   K2  mttkrp_oriented_partials_pallas (:132; body :108) — per-block run
//       sums as a one-hot (block_m x block_m) matmul on the MXU;
//   K8  mttkrp_oriented_carry_chunk_pallas (:541; body
//       _mttkrp_carry_chunk_kernel :511) — K1 over one chunk of a
//       host-resident stream, the running out and the open run carried in
//       and out (carry_chunk.cuh: K1's runs pass + a chunk fix-up);
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
// The traversal loops live in alto_scan.cuh, shared with the Φ kernels
// (phi_oriented.cu); carry_fixup also finishes the Φ carry route and,
// with one slot per piece, the deterministic pull reduction
// (ops.pull_reduction: the Temp rows sorted by global row).
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
#include "alto_scan.cuh"
#include "carry_chunk.cuh"

namespace {

// Pieces are numbered p = slots·b + slot. With two slots (K1's carries,
// segment_merge) slot 0 holds a block's first run and slot 1 its last run,
// row -1 when absent. With one slot (the pull reduction) every piece is
// present and the pieces are sorted by row. Either way a row's pieces are
// consecutive present pieces.
__global__ void carry_fixup_kernel(const int* __restrict__ carry_row,
                                   const float* __restrict__ carry_val,
                                   int64_t n_pieces, int slots, int R,
                                   int r_block, float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (p >= n_pieces) return;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const int row = carry_row[p];
  if (row < 0) return;
  const int64_t b = p / slots;
  if (p == slots * b && b > 0) {
    int prev = carry_row[p - 1];         // previous block's last run ...
    if (prev < 0 && slots == 2) prev = carry_row[p - 2];  // ... or its only
    if (prev == row) return;             // not the head of its chain
  }
  float acc = carry_val[p * R + r];
  int64_t q = p;
  for (;;) {
    const int64_t qb = q / slots;
    // A first run followed by a last run in the same block: the next
    // piece holds another row.
    if (slots == 2 && q == 2 * qb && carry_row[q + 1] >= 0) break;
    const int64_t nq = slots * (qb + 1);
    if (nq >= n_pieces || carry_row[nq] != row) break;
    acc = __fadd_rn(acc, carry_val[nq * R + r]);
    q = nq;
  }
  out[static_cast<int64_t>(row) * R + r] = acc;
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
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_carry_runs(a, MttkrpTerm{}, rows, words, values, block_m,
                           n_blocks, r_block, slices_per_cta, out,
                           carry_row, carry_val, stream);
}

// K1, second pass (also the deterministic half of segment_merge and of
// the pull reduction).
int alto_carry_fixup(const void* carry_row, const void* carry_val,
                     long long n_pieces, int slots, int rank, int r_block,
                     int slices_per_cta, void* out, void* stream) {
  if (bad_tiling(rank, r_block, slices_per_cta) || slots < 1 || slots > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces == 0) return 0;
  carry_fixup_kernel<<<grid_for(n_pieces, slices_per_cta, rank, r_block),
                       dim3(r_block, slices_per_cta), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(carry_row),
      static_cast<const float*>(carry_val), n_pieces, slots, rank, r_block,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K8: one chunk of the carry route. out is the running output (zeros at
// rows no earlier chunk has reached); pieces_row (n_blocks, 2) and
// pieces_val (n_blocks, 2, rank) are scratch; (cin_row, cin_val) is the
// open run handed in, (cout_row, cout_val) the one handed on (-1 and zeros
// after the final chunk). cin and cout must not alias.
int alto_carry_chunk(const int64_t* factor_ptrs, const int* runs, int n_runs,
                     int ndim, int nwords, int mode, int rank,
                     const void* rows, const void* words, const void* values,
                     long long block_m, long long n_blocks, int r_block,
                     int slices_per_cta, void* out, void* pieces_row,
                     void* pieces_val, const void* cin_row,
                     const void* cin_val, int final_chunk, void* cout_row,
                     void* cout_val, void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_carry_chunk(a, MttkrpTerm{}, rows, words, values, block_m,
                            n_blocks, r_block, slices_per_cta, out,
                            pieces_row, pieces_val, cin_row, cin_val,
                            final_chunk, cout_row, cout_val, stream);
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
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_oriented_partials(a, MttkrpTerm{}, rows, words, values,
                                  block_m, n_blocks, r_block, slices_per_cta,
                                  partials, stream);
}

}  // extern "C"
