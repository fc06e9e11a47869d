// Recursive-traversal CP-APR Φ on Hopper (K7): per-partition Temp buffers.
//
// Replaces phi_partials_pallas (src/repro/kernels/cpapr_phi.py:57; body
// _phi_partial_kernel :25), which forms the fused Φ update of one ALTO
// partition in VMEM and scatters it into the partition's Temp through a
// one-hot (chunk x temp_rows) matmul.
//
// Design. K3's traversal (alto_scan.cuh) with the Φ term of
// phi_update.cuh: one thread per rank column of one ALTO partition, each
// nonzero added at Temp[row - part_start] in ALTO order. The target row is
// decoded from the words and selects the B row as well; under ALTO-PRE the
// Π rows (in ALTO order) replace the factor gathers. No rank tiles: the
// denominator needs the whole rank. The pull into (I_n, R) is
// ops.pull_reduction, a fixed-order sum over the partitions covering
// each row (sort + carry_fixup), so the route is bit-repeatable.
//
// What bounds it on an H100: bytes — words, values and part_start, B, Π or
// the other factors, each once, and the (L, T, R) Temp written. The Temp
// read-modify-write per nonzero stays in the thread's own column (L1/L2);
// Temp in shared memory is later work.
#include "alto_scan.cuh"
#include "phi_update.cuh"

extern "C" {

// temp is (n_parts, temp_rows, rank) and must hold zeros. pi is null under
// ALTO-OTF.
int alto_phi_partials(const int64_t* factor_ptrs, const int* runs,
                      int n_runs, int ndim, int nwords, int mode, int rank,
                      const void* words, const void* values,
                      const void* part_start, const void* B, const void* pi,
                      float eps, long long n_parts, long long chunk,
                      long long temp_rows, int slices_per_cta, void* temp,
                      void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const PhiTerm term{static_cast<const float*>(B),
                     static_cast<const float*>(pi), eps};
  return launch_recursive_partials(a, term, words, values, part_start,
                                   n_parts, chunk, temp_rows, rank,
                                   slices_per_cta, temp, stream);
}

}  // extern "C"
