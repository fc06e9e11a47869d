// ALTO delinearization on Hopper (K4): (M, W) index words -> (M, N) int32
// coordinates.
//
// Replaces delinearize_pallas (src/repro/kernels/delinearize.py:37; body
// _delinearize_kernel :26), a static shift/mask/or chain over VMEM tiles.
//
// What bounds it on an H100: bytes — M·W·4 read, M·N·4 written, a few
// integer operations per word.
//
// Design. A persistent grid (as many CTAs as the card holds at once) walks
// the stream in tiles of `tile` nonzeros; a ragged last tile is
// bounds-checked, so any M is taken and the caller pads nothing. Within a
// tile each thread decodes several nonzeros, its words loaded as one
// vector (uint2 at W = 2, uint4 at W = 4), and
// stages their N coordinates in shared memory; the tile's (tile, N) block
// is contiguous in the output and leaves as 16-byte stores. Decode routes,
// both through the byte tables of alto_coord_table (N·W·4 KB: 16 KB for
// Chicago, 24 KB for DARPA):
//   ROUTE_SMEM  the tables copied once per CTA into shared memory, above
//               48 KB as opted-in dynamic shared memory;
//   ROUTE_L1    the tables read through L1 with __ldg, for tables a CTA
//               cannot hold.
// The wrapper (kernels/delinearize.py) picks ROUTE_SMEM where the tables
// and the staging tile fit one CTA's shared memory, else ROUTE_L1, and
// may name a route outright; both give the same coordinates. (The BitRun
// loop of alto_coord on the words in registers, timed as a third route on
// an H100, ran several times slower than the tables: dropped.)
#include "alto_decode.cuh"

namespace {

enum { ROUTE_SMEM = 0, ROUTE_L1 = 1 };
constexpr int DELIN_THREADS = 256;

// The NW words of a nonzero (NW = n_words: 1, 2 or 4), loaded as one
// vector.
template <int NW>
struct Words {
  uint32_t x[NW];
  __device__ __forceinline__ void load(const uint32_t* words, int64_t i) {
    if constexpr (NW == 1) {
      x[0] = __ldg(words + i);
    } else if constexpr (NW == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(words) + i);
      x[0] = v.x;
      x[1] = v.y;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(words) + i);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    }
  }
};

// Coordinate of mode m: the OR of the four byte lookups of each word.
template <int ROUTE, int NW>
__device__ __forceinline__ int decode(const uint32_t* tab, const Words<NW>& w,
                                      int m) {
  const uint32_t* t = tab + m * NW * 1024;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k, t += 1024) {
    const uint32_t x = w.x[k];
    if constexpr (ROUTE == ROUTE_SMEM) {
      c |= t[x & 255u] | t[256 + ((x >> 8) & 255u)] |
           t[512 + ((x >> 16) & 255u)] | t[768 + (x >> 24)];
    } else {
      c |= __ldg(t + (x & 255u)) | __ldg(t + 256 + ((x >> 8) & 255u)) |
           __ldg(t + 512 + ((x >> 16) & 255u)) | __ldg(t + 768 + (x >> 24));
    }
  }
  return static_cast<int>(c);
}

template <int ROUTE, int NW>
__global__ void delinearize_tiles_kernel(const uint32_t* __restrict__ dtab,
                                         int N,
                                         const uint32_t* __restrict__ words,
                                         int64_t M, int tile,
                                         int* __restrict__ coords) {
  extern __shared__ uint4 delin_smem[];
  const int table_words =
      ROUTE == ROUTE_SMEM ? N * NW * 1024 : 0;   // a multiple of 4
  int* s_out = reinterpret_cast<int*>(delin_smem) + table_words;
  if constexpr (ROUTE == ROUTE_SMEM) {
    const uint4* src = reinterpret_cast<const uint4*>(dtab);
    for (int k = threadIdx.x; k < table_words / 4; k += blockDim.x)
      delin_smem[k] = __ldg(src + k);
    __syncthreads();
  }
  const uint32_t* tab = ROUTE == ROUTE_SMEM
                            ? reinterpret_cast<const uint32_t*>(delin_smem)
                            : dtab;
  const int64_t n_tiles = (M + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    const int n = static_cast<int>(M - base < tile ? M - base : tile);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      Words<NW> w;
      w.load(words, base + j);
      for (int m = 0; m < N; ++m)
        s_out[j * N + m] = decode<ROUTE, NW>(tab, w, m);
    }
    __syncthreads();
    // The tile's coordinates are one contiguous block of n·N ints, 16-byte
    // aligned (tile is a multiple of 4, coords 16-byte aligned).
    int* dst = coords + base * N;
    const int total = n * N;
    for (int k = threadIdx.x; k < total / 4; k += blockDim.x)
      reinterpret_cast<int4*>(dst)[k] =
          reinterpret_cast<const int4*>(s_out)[k];
    for (int k = total / 4 * 4 + threadIdx.x; k < total; k += blockDim.x)
      dst[k] = s_out[k];
    __syncthreads();
  }
}

// Shared memory of one CTA, bytes.
inline size_t delin_smem_bytes(int route, int ndim, int nwords, int tile) {
  const size_t tables =
      route == ROUTE_SMEM ? static_cast<size_t>(ndim) * nwords * 4096 : 0;
  return tables + static_cast<size_t>(tile) * ndim * 4;
}

// A persistent grid: as many CTAs as the card holds at once, or one per
// tile when there are fewer tiles.
template <int ROUTE, int NW>
int launch_delinearize(const uint32_t* dtab, int ndim, const uint32_t* words,
                       int64_t M, int tile, int* coords,
                       cudaStream_t stream) {
  auto kernel = delinearize_tiles_kernel<ROUTE, NW>;
  const size_t smem = delin_smem_bytes(ROUTE, ndim, NW, tile);
  cudaError_t st = cudaSuccess;
  if (smem > 48 * 1024)
    st = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (st == cudaSuccess) st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       DELIN_THREADS, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t n_tiles = (M + tile - 1) / tile;
  const int64_t grid = n_tiles < static_cast<int64_t>(sms) * per_sm
                           ? n_tiles
                           : static_cast<int64_t>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(grid), DELIN_THREADS, smem, stream>>>(
      dtab, ndim, words, M, tile, coords);
  return static_cast<int>(cudaGetLastError());
}

template <int ROUTE>
int launch_route(const uint32_t* dtab, int ndim, int nwords,
                 const uint32_t* words, int64_t M, int tile, int* coords,
                 cudaStream_t stream) {
  switch (nwords) {
    case 1:
      return launch_delinearize<ROUTE, 1>(dtab, ndim, words, M, tile, coords,
                                          stream);
    case 2:
      return launch_delinearize<ROUTE, 2>(dtab, ndim, words, M, tile, coords,
                                          stream);
    case 4:
      return launch_delinearize<ROUTE, 4>(dtab, ndim, words, M, tile, coords,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// coords is (M, ndim), 16-byte aligned; every entry is written. words
// (M, nwords), nwords 1, 2 or 4, aligned to a row. dtab: the byte decode
// tables (ndim, nwords, 4, 256); tile: nonzeros per CTA tile, a multiple
// of 4 in [4, 4096]; route: ROUTE_*.
int alto_delinearize(int ndim, int nwords, const void* words,
                     const void* dtab, long long M, int tile, int route,
                     void* coords, void* stream) {
  if (ndim < 1 || ndim > ALTO_MAX_MODES || M < 0 || tile < 4 ||
      tile > 4096 || tile % 4 != 0 || dtab == nullptr ||
      reinterpret_cast<uintptr_t>(coords) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(words) % (4 * nwords) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const uint32_t* t = static_cast<const uint32_t*>(dtab);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  int* c = static_cast<int*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case ROUTE_SMEM:
      return launch_route<ROUTE_SMEM>(t, ndim, nwords, w, M, tile, c, s);
    case ROUTE_L1:
      return launch_route<ROUTE_L1>(t, ndim, nwords, w, M, tile, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
