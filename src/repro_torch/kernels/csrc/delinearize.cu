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

// ---------------------------------------------------------------------------
// ALTO-PRE Π rows
// ---------------------------------------------------------------------------

constexpr int PI_THREADS = 256;

// The other modes' factors in increasing mode order, those modes, and the
// elements between two tenants' factor (0 for one tensor).
struct PiFactors {
  const float* f[ALTO_MAX_MODES - 1];
  int mode[ALTO_MAX_MODES - 1];
  int64_t stride[ALTO_MAX_MODES - 1];
};

// Slots a thread holds at once: about 8 factor-row loads in flight.
template <int N>
struct PiUnroll {
  static constexpr int value = N - 1 >= 8 ? 1 : 8 / (N - 1);
};

template <int VEC>
struct Chunk;
template <>
struct Chunk<4> {
  using T = float4;
  static __device__ __forceinline__ float4 mul(float4 a, float4 b) {
    return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                       __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
  }
};
template <>
struct Chunk<1> {
  using T = float;
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};

// Elements of a tile: PI_THREADS·U slots, at least one element.
template <int N>
__host__ __device__ __forceinline__ int pi_tile(int chunks) {
  const int e = PI_THREADS * PiUnroll<N>::value / chunks;
  return e > 0 ? e : 1;
}

// A bucket's `tenants` stacked streams of M elements each are one walk over
// tenants · ⌈M / per_tile⌉ tiles; a tile lies inside one tenant, whose
// words, factors and Π rows it reads and writes at that tenant's offsets,
// so each tenant gets the tiles and the products of its solo launch.
template <int ROUTE, int N, int NW, int VEC>
__global__ void pi_rows_kernel(const uint32_t* __restrict__ dtab,
                               PiFactors fac, int rank,
                               const uint32_t* __restrict__ words, int64_t M,
                               int tenants, float* __restrict__ pi) {
  using V = typename Chunk<VEC>::T;
  constexpr int U = PiUnroll<N>::value;
  extern __shared__ uint4 pi_smem[];
  if constexpr (ROUTE == ROUTE_SMEM) {
    const uint4* src = reinterpret_cast<const uint4*>(dtab);
    for (int k = threadIdx.x; k < N * NW * 256; k += blockDim.x)
      pi_smem[k] = __ldg(src + k);
    __syncthreads();
  }
  const uint32_t* tab = ROUTE == ROUTE_SMEM
                            ? reinterpret_cast<const uint32_t*>(pi_smem)
                            : dtab;
  const int chunks = rank / VEC;            // chunks of a Π row
  const int per_tile = pi_tile<N>(chunks);
  const int64_t tiles = (M + per_tile - 1) / per_tile;   // a tenant's
  const int64_t n_tiles = tiles * tenants;
  V* out = reinterpret_cast<V*>(pi);
  for (int64_t g = blockIdx.x; g < n_tiles; g += gridDim.x) {
    const int64_t z = tenants == 1 ? 0 : g / tiles;     // the tenant
    const int64_t e1 = (g - z * tiles) * per_tile;      // in its stream
    const int64_t e0 = z * M + e1;                      // in the stack
    // The tile's slots are one contiguous run of Π's chunks.
    const int n = static_cast<int>(M - e1 < per_tile ? M - e1 : per_tile) *
                  chunks;
    for (int s0 = threadIdx.x; s0 < n; s0 += PI_THREADS * U) {
      V row[U][N - 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u * PI_THREADS;
        if (s < n) {
          const int e = s / chunks;
          const int q = s - e * chunks;
          Words<NW> w;
          w.load(words, e0 + e);
#pragma unroll
          for (int j = 0; j < N - 1; ++j) {
            const int i = decode<ROUTE, NW>(tab, w, fac.mode[j]);
            row[u][j] = __ldg(reinterpret_cast<const V*>(
                                  fac.f[j] + z * fac.stride[j] +
                                  static_cast<int64_t>(i) * rank) +
                              q);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u * PI_THREADS;
        if (s < n) {
          V acc = row[u][0];
#pragma unroll
          for (int j = 1; j < N - 1; ++j)
            acc = Chunk<VEC>::mul(acc, row[u][j]);
          __stcs(out + e0 * chunks + s, acc);
        }
      }
    }
  }
}

template <int ROUTE, int N, int NW, int VEC>
int launch_pi_rows(const uint32_t* dtab, const PiFactors& fac, int rank,
                   const uint32_t* words, int64_t M, int tenants, float* pi,
                   cudaStream_t stream) {
  auto kernel = pi_rows_kernel<ROUTE, N, NW, VEC>;
  const size_t smem =
      ROUTE == ROUTE_SMEM ? static_cast<size_t>(N) * NW * 4096 : 0;
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
                                                       PI_THREADS, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_tile = pi_tile<N>(rank / VEC);
  const int64_t n_tiles = (M + per_tile - 1) / per_tile * tenants;
  const int64_t grid = n_tiles < static_cast<int64_t>(sms) * per_sm
                           ? n_tiles
                           : static_cast<int64_t>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(grid), PI_THREADS, smem, stream>>>(
      dtab, fac, rank, words, M, tenants, pi);
  return static_cast<int>(cudaGetLastError());
}

// The launch for ndim N or above: one instantiation for each N up to
// ALTO_MAX_MODES.
template <int ROUTE, int NW, int VEC, int N = 2>
int pi_rows_for_n(int ndim, const uint32_t* dtab, const PiFactors& fac,
                  int rank, const uint32_t* words, int64_t M, int tenants,
                  float* pi, cudaStream_t stream) {
  if (ndim == N)
    return launch_pi_rows<ROUTE, N, NW, VEC>(dtab, fac, rank, words, M,
                                             tenants, pi, stream);
  if constexpr (N < ALTO_MAX_MODES)
    return pi_rows_for_n<ROUTE, NW, VEC, N + 1>(ndim, dtab, fac, rank, words,
                                                M, tenants, pi, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int ROUTE, int VEC>
int pi_rows_for_w(int ndim, int nwords, const uint32_t* dtab,
                  const PiFactors& fac, int rank, const uint32_t* words,
                  int64_t M, int tenants, float* pi, cudaStream_t stream) {
  switch (nwords) {
    case 1:
      return pi_rows_for_n<ROUTE, 1, VEC>(ndim, dtab, fac, rank, words, M,
                                          tenants, pi, stream);
    case 2:
      return pi_rows_for_n<ROUTE, 2, VEC>(ndim, dtab, fac, rank, words, M,
                                          tenants, pi, stream);
    case 4:
      return pi_rows_for_n<ROUTE, 4, VEC>(ndim, dtab, fac, rank, words, M,
                                          tenants, pi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC>
int pi_rows_for_route(int route, int ndim, int nwords, const uint32_t* dtab,
                      const PiFactors& fac, int rank, const uint32_t* words,
                      int64_t M, int tenants, float* pi,
                      cudaStream_t stream) {
  switch (route) {
    case ROUTE_SMEM:
      return pi_rows_for_w<ROUTE_SMEM, VEC>(ndim, nwords, dtab, fac, rank,
                                            words, M, tenants, pi, stream);
    case ROUTE_L1:
      return pi_rows_for_w<ROUTE_L1, VEC>(ndim, nwords, dtab, fac, rank,
                                          words, M, tenants, pi, stream);
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

// pi is (M, rank) float32, every entry written. words (M, nwords), nwords
// 1, 2 or 4, aligned to a row; dtab: the byte decode tables (ndim, nwords,
// 4, 256); factor_ptrs: a host array of the ndim factors' device addresses,
// each (I_m, rank) row-major (the target mode's is not read); route:
// ROUTE_*. n_tenants stacked tenants (Tenants in alto_decode.cuh): words
// (n_tenants, M, nwords), pi (n_tenants, M, rank), tenant_strides the
// elements between two tenants' factor m (ndim entries, then one this
// entry does not read); null for one. The chunk width is chosen here:
// float4 where rank % 4 == 0 and pi, every factor read and every tenant
// stride are 16-byte aligned, else one float.
int alto_pi_rows(int ndim, int nwords, const void* words, const void* dtab,
                 long long M, const void* factor_ptrs, int mode, int rank,
                 int route, void* pi, int n_tenants,
                 const int64_t* tenant_strides, void* stream) {
  Tenants tn;
  if (ndim < 2 || ndim > ALTO_MAX_MODES || mode < 0 || mode >= ndim ||
      rank < 1 || M < 0 || dtab == nullptr || factor_ptrs == nullptr ||
      reinterpret_cast<uintptr_t>(pi) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(words) % (4 * nwords) != 0 ||
      !tenants_make(&tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int64_t* ptrs = static_cast<const int64_t*>(factor_ptrs);
  PiFactors fac = {};
  bool vec = rank % 4 == 0 && reinterpret_cast<uintptr_t>(pi) % 16 == 0;
  for (int m = 0, j = 0; m < ndim; ++m) {
    if (m == mode) continue;
    fac.f[j] = reinterpret_cast<const float*>(ptrs[m]);
    fac.stride[j] = tn.factor[m];
    fac.mode[j++] = m;
    vec = vec && ptrs[m] % 16 == 0 && tn.factor[m] % 4 == 0;
  }
  const uint32_t* t = static_cast<const uint32_t*>(dtab);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  float* out = static_cast<float*>(pi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? pi_rows_for_route<4>(route, ndim, nwords, t, fac, rank, w, M,
                                    tn.count, out, s)
             : pi_rows_for_route<1>(route, ndim, nwords, t, fac, rank, w, M,
                                    tn.count, out, s);
}

}  // extern "C"
