// ALTO delinearization on Hopper (K4): (M, W) index words -> (M, N) int32
// coordinates.
//
// Replaces delinearize_pallas (src/repro/kernels/delinearize.py:37; body
// _delinearize_kernel :26), a static shift/mask/or chain over VMEM tiles.
//
// Design. One thread per nonzero decodes every mode with `alto_coord`
// (alto_decode.cuh), the decode the MTTKRP and Φ kernels inline. A CTA
// covers one block_m slice; the wrapper pads the stream to a multiple of
// block_m (ops.delinearize) as the Pallas grid needed, so there is no
// ragged edge.
//
// What bounds it on an H100: bytes — M·W·4 read, M·N·4 written, a few
// integer operations per word. The thread's N stores are strided by N;
// staging a tile through shared memory for coalesced stores is later work.
#include "alto_decode.cuh"

namespace {

__global__ void delinearize_kernel(const __grid_constant__ AltoArgs a,
                                   const uint32_t* __restrict__ words,
                                   int* __restrict__ coords) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const uint32_t* w = words + i * a.nwords;
  int* c = coords + i * a.ndim;
  for (int m = 0; m < a.ndim; ++m) c[m] = alto_coord(a, w, m);
}

}  // namespace

extern "C" {

// coords is (n_blocks · block_m, ndim); every entry is written.
int alto_delinearize(const int* runs, int n_runs, int ndim, int nwords,
                     const void* words, long long block_m,
                     long long n_blocks, void* coords, void* stream) {
  const int64_t no_factors[ALTO_MAX_MODES] = {};
  AltoArgs a;
  if (!alto_make_args(&a, no_factors, runs, n_runs, ndim, nwords, 0, 1) ||
      block_m < 1 || block_m > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  delinearize_kernel<<<static_cast<unsigned>(n_blocks),
                       static_cast<unsigned>(block_m), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(words), static_cast<int*>(coords));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
