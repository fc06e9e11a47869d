// Recursive-traversal CP-APR Φ on Hopper (K7): per-partition Temp buffers.
//
// Replaces phi_partials_pallas (src/repro/kernels/cpapr_phi.py:57; body
// _phi_partial_kernel :25), which forms the fused Φ update of one ALTO
// partition in VMEM and scatters it into the partition's Temp through a
// one-hot (chunk x temp_rows) matmul.
//
// What bounds it on an H100: bytes — words, values and part_start, B at
// the stream's rows, Π or the other factors, each once, and the
// (L, T, R) Temp written once. The earlier form (one thread per rank
// column of a partition: 128 CTAs, under one wave, and a read-modify-write
// of Temp in device memory per nonzero) ran at 1,700 times that bound.
//
// Design (phi_partials_smem_kernel, phi_scan.cuh): one CTA per partition,
// its Temp window and the window's B rows in shared memory; the sub-warps
// form the terms of a tile of nonzeros in parallel (K5's lane map and
// rounding), then each Temp entry adds its terms in stream order. A Temp
// larger than a CTA may hold is covered in row windows, the partition
// walked once per window that its own rows reach (zeros stored in the
// rest). The wrapper chooses the CTA's threads, its staging tile and the
// window together (common.k7_launch, from alto_phi_smem_limit): the
// plan's threads, tile_nnz and the tallest window that fits, unless that
// leaves an SM fewer than 16 warps; then a wider CTA of the same kernel,
// a tile scaled with its warps (common.k7_tile) and the window that
// remains. Every Temp entry adds its terms in stream order whatever the
// shape, so the shape never changes the bits. The words are decoded
// through byte tables (alto_coord_table); the factors of the other modes
// are gathered through L1, not staged in shared memory. The pull into (I_n, R)
// is ops.pull_reduction, a fixed-order sum over the partitions covering
// each row (sort + carry_fixup), so the route is bit-repeatable. A bucket
// of shape-class tenants (core/batched.py) is the grid's z axis, as K3's.
#include "phi_scan.cuh"

namespace {

template <int W, int COLS>
struct PhiPartialsLaunch {
  static int run(const PhiArgs& p) {
    if (p.n_parts == 0) return 0;
    const size_t smem =
        partials_smem_bytes(p.a.rank, p.window, p.tile, true);
    auto kernel = phi_partials_smem_kernel<W, COLS, phi_unroll<COLS>()>;
    if (smem > 48 * 1024) {
      const cudaError_t st = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (st != cudaSuccess) return static_cast<int>(st);
    }
    const dim3 grid(static_cast<unsigned>(p.n_parts), 1,
                    static_cast<unsigned>(p.tn.count));
    kernel<<<grid, p.threads, smem, p.stream>>>(
        p.a, p.tn, p.B, p.pi, p.eps, p.words, p.values, p.part_start, p.chunk,
        p.temp_rows, p.out_rows, p.window, p.tile, p.temp);
    return static_cast<int>(cudaGetLastError());
  }
};

int launch_phi_partials_smem(const AltoArgs& a, const Tenants& tn,
                             const void* B,
                             const void* pi, float eps, const void* words,
                             const void* values, const void* part_start,
                             long long n_parts, long long chunk,
                             long long temp_rows, int out_rows, int window,
                             int tile, int threads, void* temp,
                             void* stream) {
  if (chunk < 0 || temp_rows < 1 || window < 1 || tile < 1 || n_parts < 0 ||
      out_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PhiArgs p = phi_args(a, B, pi, eps, words, values, threads, stream);
  // Several windows: the partition's reach is reduced through the staging
  // tile (terms, then rows), an int a warp.
  if (window < temp_rows && tile * (a.rank + 1) < p.threads / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tn = tn;
  p.part_start = static_cast<const int*>(part_start);
  p.n_parts = n_parts;
  p.chunk = chunk;
  p.temp_rows = temp_rows;
  p.out_rows = out_rows;
  p.window = window;
  p.tile = tile;
  p.temp = static_cast<float*>(temp);
  return phi_dispatch<PhiPartialsLaunch>(a.rank, p);
}

// The most threads a CTA of K7's kernel for the lane map of a rank may
// have, as its registers allow (common.k7_launch widens no further).
template <int W, int COLS>
struct PhiPartialsMaxThreads {
  static int run(int* threads) {
    cudaFuncAttributes attr;
    const cudaError_t st = cudaFuncGetAttributes(
        &attr, phi_partials_smem_kernel<W, COLS, phi_unroll<COLS>()>);
    if (st == cudaSuccess) *threads = attr.maxThreadsPerBlock;
    return static_cast<int>(st);
  }
};

}  // namespace

extern "C" {

// The shared memory one CTA may opt in to on the current device, bytes.
int alto_phi_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
  return static_cast<int>(st);
}

// The most threads a K7 CTA may have at `rank` (its kernel's registers).
int alto_phi_partials_max_threads(int rank, int* threads) {
  return phi_dispatch<PhiPartialsMaxThreads>(rank, threads);
}

// temp is (n_parts, temp_rows, rank); every entry is written. pi is null
// under ALTO-OTF; dtab: the byte decode tables. out_rows: the rows of B.
// window: Temp rows per pass, tile: nonzeros per staging tile, threads:
// CTA size (whole warps). n_tenants stacked tenants (Tenants in
// alto_decode.cuh): tenant_strides holds the elements between two tenants'
// factor m (ndim entries), then between two tenants' B; null for one.
// Each tenant's stream, Π, part_start and temp follow the previous one's.
int alto_phi_partials(const int64_t* factor_ptrs, const int* runs,
                      int n_runs, int ndim, int nwords, int mode, int rank,
                      const void* words, const void* values,
                      const void* part_start, const void* B, const void* pi,
                      float eps, const void* dtab, long long n_parts,
                      long long chunk, long long temp_rows, int out_rows,
                      int window, int tile, int threads, void* temp,
                      int n_tenants, const int64_t* tenant_strides,
                      void* stream) {
  AltoArgs a;
  Tenants tn;
  if (!alto_make_args(&a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) || dtab == nullptr ||
      !tenants_make(&tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dtab = static_cast<const uint32_t*>(dtab);
  return launch_phi_partials_smem(a, tn, B, pi, eps, words, values,
                                  part_start,
                                  n_parts, chunk, temp_rows, out_rows,
                                  window, tile, threads, temp, stream);
}

}  // extern "C"
