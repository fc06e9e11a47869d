// Recursive-traversal MTTKRP on Hopper (K3): per-partition Temp buffers.
//
// Replaces mttkrp_partials_pallas (src/repro/kernels/mttkrp.py:75; body
// _mttkrp_partial_kernel :47), which scatters each ALTO partition into its
// dense Temp through a one-hot (chunk x temp_rows) matmul on the MXU
// because the TPU has no atomics.
//
// What bounds it on an H100: bytes — words, values and part_start, the
// other modes' factor rows, each once, and the (L, T, R) Temp written
// once. The earlier form (one thread per rank column of a partition: 128
// CTAs on Chicago, under one wave, every nonzero decoded once per column
// and a read-modify-write of Temp in device memory per nonzero, behind a
// memset) ran at 750 times that bound.
//
// A bucket of shape-class tenants (core/batched.py) is the grid's z axis:
// one launch for all of them, each tenant's CTAs the solo launch's.
//
// Design (mttkrp_partials_smem_kernel, alto_scan.cuh): K7's form over the
// MTTKRP term. One CTA per partition and rank tile, its Temp window in
// shared memory (no B rows, so a window holds twice K7's rows); the
// sub-warps form the terms of a tile of nonzeros in parallel with K1's
// lane map and loads (four contiguous columns a lane, as a float4;
// K1_UNROLL nonzeros in flight; the words decoded through byte tables),
// then each Temp entry adds its terms in stream order. A Temp larger than
// a window is covered in row windows (`window` rows, the wrapper's choice
// from the card's shared memory), the partition walked once per window;
// any window height gives the same bits. Every Temp entry is stored once,
// so the wrapper allocates Temp without zeroing it. The pull into (I_n, R)
// is ops.pull_reduction, a fixed-order sum over the partitions covering
// each row (carry_fixup.cuh).
#include "alto_scan.cuh"

namespace {

struct RecursiveArgs {     // the operands of K3
  AltoArgs a;              // a.dtab: the byte decode tables
  Tenants tn;              // the tenant axis (tenants_make)
  const uint32_t* words;
  const float* values;
  const int* part_start;
  int64_t n_parts, chunk, temp_rows;
  int r_block, window, tile, threads;
  float* temp;
  cudaStream_t stream;
};

// Rows of the factors and Temp start on 16 bytes in the rank tile: a
// lane's four columns may move as one float4 (also in shared memory).
inline bool aligned4(const RecursiveArgs& p) {
  bool ok = p.a.rank % 4 == 0 && p.r_block % 4 == 0 &&
            reinterpret_cast<uintptr_t>(p.temp) % 16 == 0;
  for (int m = 0; m < p.a.ndim; ++m)
    ok = ok && reinterpret_cast<uintptr_t>(p.a.factors[m]) % 16 == 0;
  return ok;
}

template <int W, int COLS>
struct MttkrpPartialsLaunch {
  static int run(const RecursiveArgs& p) {
    const size_t smem =
        partials_smem_bytes(p.r_block, p.window, p.tile, false);
    auto kernel = p.tn.count > 1
                      ? mttkrp_partials_smem_kernel<W, COLS, K1_UNROLL, true>
                      : mttkrp_partials_smem_kernel<W, COLS, K1_UNROLL, false>;
    if (smem > 48 * 1024) {
      const cudaError_t st = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (st != cudaSuccess) return static_cast<int>(st);
    }
    const dim3 grid(static_cast<unsigned>(p.n_parts),
                    static_cast<unsigned>(p.a.rank / p.r_block),
                    static_cast<unsigned>(p.tn.count));
    kernel<<<grid, p.threads, smem, p.stream>>>(
        p.a, p.tn, p.words, p.values, p.part_start, p.chunk, p.temp_rows,
        p.r_block, p.window, p.tile, aligned4(p), p.temp);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

// temp is (n_parts, temp_rows, rank); every entry is written. dtab: the
// byte decode tables; (lanes, cols): K1's lane map of r_block; window:
// Temp rows per pass, tile: nonzeros per staging tile, threads: CTA size
// (whole warps). n_tenants stacked tenants (Tenants in alto_scan.cuh):
// tenant_strides holds the elements between two tenants' factor m (ndim
// entries), then one more entry (unused here); null for one. Each
// tenant's stream, part_start and temp follow the previous one's.
int alto_recursive_partials(const int64_t* factor_ptrs, const int* runs,
                            int n_runs, int ndim, int nwords, int mode,
                            int rank, const void* words, const void* values,
                            const void* part_start, const void* dtab,
                            long long n_parts, long long chunk,
                            long long temp_rows, int r_block, int lanes,
                            int cols, int window, int tile, int threads,
                            void* temp, int n_tenants,
                            const int64_t* tenant_strides, void* stream) {
  RecursiveArgs p{};
  if (!alto_make_args(&p.a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      !tenants_make(&p.tn, n_tenants, tenant_strides, ndim) ||
      dtab == nullptr || r_block < 1 ||
      rank % r_block != 0 || lanes * cols < r_block || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || chunk < 0 || temp_rows < 1 ||
      window < 1 || tile < 1 || n_parts < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_parts == 0) return 0;
  p.a.dtab = static_cast<const uint32_t*>(dtab);
  p.words = static_cast<const uint32_t*>(words);
  p.values = static_cast<const float*>(values);
  p.part_start = static_cast<const int*>(part_start);
  p.n_parts = n_parts;
  p.chunk = chunk;
  p.temp_rows = temp_rows;
  p.r_block = r_block;
  p.window = window;
  p.tile = tile;
  p.threads = threads;
  p.temp = static_cast<float*>(temp);
  p.stream = static_cast<cudaStream_t>(stream);
  return k1_lane_dispatch<MttkrpPartialsLaunch>(lanes, cols, p);
}

}  // extern "C"
