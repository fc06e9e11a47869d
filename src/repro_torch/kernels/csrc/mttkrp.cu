// Recursive-traversal MTTKRP on Hopper (K3): per-partition Temp buffers.
//
// Replaces mttkrp_partials_pallas (src/repro/kernels/mttkrp.py:75; body
// _mttkrp_partial_kernel :47), which scatters each ALTO partition into its
// dense Temp through a one-hot (chunk x temp_rows) matmul on the MXU
// because the TPU has no atomics.
//
// Design. One thread owns one rank column of one balanced ALTO partition
// and walks the partition's chunk in ALTO order, adding each nonzero's
// contribution at Temp[row - part_start] of the (L, temp_rows, R) partials
// buffer (zeroed by the wrapper). No two threads touch one address, so
// there are no atomics and the sums are deterministic. The pull reduction
// into (I_n, R) stays outside, as it was outside the Pallas kernel. The
// loop is `recursive_partials_kernel` of alto_scan.cuh, shared with the Φ
// kernel K7 (cpapr_phi.cu).
//
// What bounds it on an H100: bytes. The stream (words + value) is read
// once, the other modes' factor entries are gathered per nonzero, and the
// Temp buffer makes a round trip (zeroed, read-modified-written here, read
// by the pull reduction). The read-modify-write of Temp is a dependent
// access per nonzero; the design keeps it in one thread's own column so it
// stays in L1/L2. Keeping Temp in shared memory where T·r_block·4 bytes fit
// is later work.
#include "alto_scan.cuh"

extern "C" {

// temp is (n_parts, temp_rows, rank) and must hold zeros.
int alto_recursive_partials(const int64_t* factor_ptrs, const int* runs,
                            int n_runs, int ndim, int nwords, int mode,
                            int rank, const void* words, const void* values,
                            const void* part_start, long long n_parts,
                            long long chunk, long long temp_rows,
                            int r_block, int slices_per_cta, void* temp,
                            void* stream) {
  AltoArgs a;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_recursive_partials(a, MttkrpTerm{}, words, values,
                                   part_start, n_parts, chunk, temp_rows,
                                   r_block, slices_per_cta, temp, stream);
}

}  // extern "C"
