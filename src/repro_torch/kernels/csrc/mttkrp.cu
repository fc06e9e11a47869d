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
// into (I_n, R) stays outside, as it was outside the Pallas kernel.
//
// What bounds it on an H100: bytes. The stream (words + value) is read
// once, the other modes' factor entries are gathered per nonzero, and the
// Temp buffer makes a round trip (zeroed, read-modified-written here, read
// by the pull reduction). The read-modify-write of Temp is a dependent
// access per nonzero; the design keeps it in one thread's own column so it
// stays in L1/L2. Keeping Temp in shared memory where T·r_block·4 bytes fit
// is later work.
#include "alto_decode.cuh"

namespace {

__global__ void recursive_partials_kernel(
    const __grid_constant__ AltoArgs a, const uint32_t* __restrict__ words,
    const float* __restrict__ values, const int* __restrict__ part_start,
    int64_t n_parts, int64_t chunk, int64_t temp_rows, int r_block,
    float* __restrict__ temp) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (l >= n_parts) return;
  const int R = a.rank;
  const int r = blockIdx.y * r_block + threadIdx.x;
  const int start = __ldg(part_start + l * a.ndim + a.mode);
  float* tl = temp + l * temp_rows * R + r;
  const int64_t s = l * chunk;
  for (int64_t i = s; i < s + chunk; ++i) {
    const int t = alto_coord(a, words + i * a.nwords, a.mode) - start;
    float* p = tl + static_cast<int64_t>(t) * R;
    *p = __fadd_rn(*p, alto_contrib(a, words, values, i, r));
  }
}

}  // namespace

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
                      rank) ||
      r_block < 1 || rank % r_block != 0 || slices_per_cta < 1 ||
      r_block * slices_per_cta > 1024 || chunk < 0 || temp_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_parts == 0) return 0;
  const dim3 grid(
      static_cast<unsigned>((n_parts + slices_per_cta - 1) / slices_per_cta),
      static_cast<unsigned>(rank / r_block));
  recursive_partials_kernel<<<grid, dim3(r_block, slices_per_cta), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(words),
      static_cast<const float*>(values),
      static_cast<const int*>(part_start), n_parts, chunk, temp_rows,
      r_block, static_cast<float*>(temp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
