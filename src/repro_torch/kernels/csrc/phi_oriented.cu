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
// What bounds them on an H100: bytes — the stream (row, value; the words
// under ALTO-OTF), Π (PRE, M·R·4) or the other factors, B at the stream's
// rows, and the output (K6: its (n_blocks, block_m, R) slots), each once.
// The Φ term needs the whole rank of a nonzero for its denominator, so
// there are no rank tiles.
//
// K5, K6 and K9 share one runs pass (phi_carry_runs_kernel, phi_scan.cuh):
// a sub-warp per block_m slice, its lanes on the rank columns (four each
// at R = 16). Each lane loads its own Π (or factor) and B entries, so a
// nonzero's rows are read once; the denominator is a serial chain of
// shuffles in k order, a sub-warp keeps several nonzeros in flight and a
// warp several slices. For K5 and K9 it keeps K1's contract
// (mttkrp_carry_runs_kernel, alto_scan.cuh): inner runs to out, the
// slice's first and last runs to the carries buffer, which the fix-up walk
// (carry_fixup.cuh; K5 through alto_carry_fixup, K9 through the chunk
// fix-up of carry_chunk.cuh) merges in block order. K5's pass also stores
// zeros to the rows the stream skips, as K1's does, so every row of its
// out is written once and the wrapper allocates out without a memset. For
// K6 it stores the slice's j-th run sum to slot j and zeros to the unused
// slots, the layout ops.segment_merge reads; the one-thread-per-column
// form it replaces formed every nonzero's denominator once per column.
// The same terms added in the same order: K5 equals K6 + segment_merge
// bit for bit.
#include "carry_chunk.cuh"
#include "phi_scan.cuh"

namespace {

template <int W, int COLS>
struct PhiCarryRunsLaunch {
  static int run(const PhiArgs& p) {
    if (p.n_blocks == 0) return 0;
    const int64_t per_cta = p.threads / W;
    const dim3 grid(
        static_cast<unsigned>((p.n_blocks + per_cta - 1) / per_cta), 1,
        static_cast<unsigned>(p.tn.count));
    phi_carry_runs_kernel<W, COLS, phi_unroll<COLS>()>
        <<<grid, p.threads, 0, p.stream>>>(
            p.a, p.tn, p.B, p.pi, p.eps, p.rows, p.words, p.values,
            p.block_m, p.n_blocks, p.out_rows, p.zero_gaps, p.out, p.carry_row,
            p.carry_val, p.partials);
    return static_cast<int>(cudaGetLastError());
  }
};

int launch_phi_carry_runs(const AltoArgs& a, const Tenants& tn,
                          const void* B, const void* pi,
                          float eps, const void* rows, const void* words,
                          const void* values, long long block_m,
                          long long n_blocks, int threads, int n_rows,
                          bool zero_gaps, void* out, void* carry_row,
                          void* carry_val, void* partials, void* stream) {
  if (block_m < 1 || n_blocks < 0 || a.dtab == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  PhiArgs p = phi_args(a, B, pi, eps, words, values, threads, stream);
  p.tn = tn;
  p.rows = static_cast<const int*>(rows);
  p.block_m = block_m;
  p.n_blocks = n_blocks;
  p.out_rows = n_rows;
  p.zero_gaps = zero_gaps;
  p.out = static_cast<float*>(out);
  p.carry_row = static_cast<int*>(carry_row);
  p.carry_val = static_cast<float*>(carry_val);
  p.partials = static_cast<float*>(partials);
  return phi_dispatch<PhiCarryRunsLaunch>(a.rank, p);
}

}  // namespace

extern "C" {

// K5, first pass: inner runs and the zeros of the skipped rows into out
// (n_rows rows; written once with the fix-up, no memset), the slices'
// first and last runs into the carries, finished by alto_carry_fixup. pi
// is null under ALTO-OTF; dtab: the byte decode tables. threads: CTA size
// (rounded to whole warps). n_tenants stacked tenants: tenant_strides
// holds the elements between two tenants' factor m (ndim entries), then
// between two tenants' B and out; null for one (Tenants, alto_decode.cuh).
int alto_phi_carry_runs(const int64_t* factor_ptrs, const int* runs,
                        int n_runs, int ndim, int nwords, int mode, int rank,
                        const void* rows, const void* words,
                        const void* values, const void* B, const void* pi,
                        float eps, const void* dtab, long long block_m,
                        long long n_blocks, int threads, int n_rows,
                        void* out, void* carry_row, void* carry_val,
                        int n_tenants, const int64_t* tenant_strides,
                        void* stream) {
  AltoArgs a;
  Tenants tn;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      !tenants_make(&tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dtab = static_cast<const uint32_t*>(dtab);
  return launch_phi_carry_runs(a, tn, B, pi, eps, rows, words, values, block_m,
                               n_blocks, threads, n_rows, true, out,
                               carry_row, carry_val, nullptr, stream);
}

// K9: one chunk of the Φ carry route, with alto_carry_chunk's contract
// (mttkrp_oriented.cu): K5's runs pass over the whole rank (no zeroed
// gaps: out is the executor's running output), then the chunk fix-up in
// rank tiles of fixup_rb. pi (the chunk's Π rows) is null under ALTO-OTF.
int alto_phi_carry_chunk(const int64_t* factor_ptrs, const int* runs,
                         int n_runs, int ndim, int nwords, int mode, int rank,
                         const void* rows, const void* words,
                         const void* values, const void* B, const void* pi,
                         float eps, const void* dtab, long long block_m,
                         long long n_blocks, int threads, int fixup_rb,
                         void* out, void* pieces_row, void* pieces_val,
                         const void* cin_row, const void* cin_val,
                         int final_chunk, void* cout_row, void* cout_val,
                         void* stream) {
  AltoArgs a;
  Tenants tn;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) || n_blocks < 1 ||
      !tenants_make(&tn, 1, nullptr, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dtab = static_cast<const uint32_t*>(dtab);
  const int status = launch_phi_carry_runs(a, tn, B, pi, eps, rows, words,
                                           values, block_m, n_blocks,
                                           threads, 0, false, out,
                                           pieces_row, pieces_val, nullptr,
                                           stream);
  if (status != 0) return status;
  return launch_carry_fixup_chunk(rank, fixup_rb, phi_cta_threads(threads),
                                  n_blocks, pieces_row, pieces_val, cin_row,
                                  cin_val, final_chunk, out, cout_row,
                                  cout_val, static_cast<cudaStream_t>(stream));
}

// K6: the runs pass into partials (n_blocks, block_m, rank); every slot is
// written. pi is null under ALTO-OTF; dtab: the byte decode tables;
// threads: CTA size (rounded to whole warps); n_tenants and
// tenant_strides: as alto_phi_carry_runs.
int alto_phi_oriented_partials(const int64_t* factor_ptrs, const int* runs,
                               int n_runs, int ndim, int nwords, int mode,
                               int rank, const void* rows, const void* words,
                               const void* values, const void* B,
                               const void* pi, float eps, const void* dtab,
                               long long block_m, long long n_blocks,
                               int threads, void* partials, int n_tenants,
                               const int64_t* tenant_strides, void* stream) {
  AltoArgs a;
  Tenants tn;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      !tenants_make(&tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dtab = static_cast<const uint32_t*>(dtab);
  return launch_phi_carry_runs(a, tn, B, pi, eps, rows, words, values, block_m,
                               n_blocks, threads, 0, false, nullptr, nullptr,
                               nullptr, partials, stream);
}

}  // extern "C"
