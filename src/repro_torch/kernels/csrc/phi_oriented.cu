// Output-oriented CP-APR Φ on Hopper: the carry kernel (K5), the
// per-block partials kernel (K6) and the out-of-core chunk kernel (K9).
//
// Replaces, in src/repro/kernels/mttkrp_oriented.py:
//   K5  phi_oriented_carry_pallas (:437; body _phi_carry_kernel :407) — the
//       sequential carry scan over the fused Φ update, full rank;
//   K6  phi_oriented_partials_pallas (:204; body _phi_oriented_kernel
//       :174) — per-block Φ run sums through a one-hot matmul;
//   K9  phi_oriented_carry_chunk_pallas (:637; body _phi_carry_chunk_kernel
//       :602) — K5 over one chunk with K8's chunk contract
//       (carry_chunk.cuh); under ALTO-PRE pi holds the chunk's Π rows.
//
// Design. K1's and K2's traversals (alto_scan.cuh) with the Φ term of
// phi_update.cuh in place of the MTTKRP term: one thread per rank column
// of one block_m slice, runs summed in stream order from 0.0. The Φ term
// needs the whole rank, so there are no rank tiles: a CTA holds R threads
// per slice. K5's carries go through K1's carry_fixup (mttkrp_oriented.cu),
// K6's partials through ops.segment_merge, which stores the inner runs and
// sends the boundary runs through the same fix-up; so K5 equals
// K6 + segment_merge bit for bit. B is gathered by the view's rows. Under
// ALTO-PRE the Π rows (in the view's order, padded with zero rows) replace
// the factor gathers and the words are not decoded.
//
// What bounds it on an H100: bytes — the stream (row, words, value), Π
// (PRE, M·R·4) or the other factors, B, and the output, each once. Every
// thread reads the whole B row and krp row of each nonzero (broadcasts
// within the slice's threads) to form the denominator itself, R times the
// MTTKRP's gathers, served from L1; a shuffle-shared denominator and
// shared-memory staging are later work.
#include "alto_scan.cuh"
#include "carry_chunk.cuh"
#include "phi_update.cuh"

extern "C" {

// K5, first pass. out must hold zeros; carries finish in alto_carry_fixup.
// pi is null under ALTO-OTF.
int alto_phi_carry_runs(const int64_t* factor_ptrs, const int* runs,
                        int n_runs, int ndim, int nwords, int mode, int rank,
                        const void* rows, const void* words,
                        const void* values, const void* B, const void* pi,
                        float eps, long long block_m, long long n_blocks,
                        int slices_per_cta, void* out, void* carry_row,
                        void* carry_val, void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const PhiTerm term{static_cast<const float*>(B),
                     static_cast<const float*>(pi), eps};
  return launch_carry_runs(a, term, rows, words, values, block_m, n_blocks,
                           rank, slices_per_cta, out, carry_row, carry_val,
                           stream);
}

// K9: one chunk of the Φ carry route, with alto_carry_chunk's contract
// (mttkrp_oriented.cu). pi (the chunk's Π rows) is null under ALTO-OTF.
int alto_phi_carry_chunk(const int64_t* factor_ptrs, const int* runs,
                         int n_runs, int ndim, int nwords, int mode, int rank,
                         const void* rows, const void* words,
                         const void* values, const void* B, const void* pi,
                         float eps, long long block_m, long long n_blocks,
                         int slices_per_cta, void* out, void* pieces_row,
                         void* pieces_val, const void* cin_row,
                         const void* cin_val, int final_chunk,
                         void* cout_row, void* cout_val, void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const PhiTerm term{static_cast<const float*>(B),
                     static_cast<const float*>(pi), eps};
  return launch_carry_chunk(a, term, rows, words, values, block_m, n_blocks,
                            rank, slices_per_cta, out, pieces_row,
                            pieces_val, cin_row, cin_val, final_chunk,
                            cout_row, cout_val, stream);
}

// K6. partials is (n_blocks, block_m, rank); every slot is written.
int alto_phi_oriented_partials(const int64_t* factor_ptrs, const int* runs,
                               int n_runs, int ndim, int nwords, int mode,
                               int rank, const void* rows, const void* words,
                               const void* values, const void* B,
                               const void* pi, float eps, long long block_m,
                               long long n_blocks, int slices_per_cta,
                               void* partials, void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const PhiTerm term{static_cast<const float*>(B),
                     static_cast<const float*>(pi), eps};
  return launch_oriented_partials(a, term, rows, words, values, block_m,
                                  n_blocks, rank, slices_per_cta, partials,
                                  stream);
}

}  // extern "C"
