// Output-oriented MTTKRP on Hopper: the carry kernel (K1: runs pass and
// fix-up walk), the per-block partials kernel (K2), the split of
// segment_merge, and the out-of-core chunk kernel (K8).
//
// Replaces, in src/repro/kernels/mttkrp_oriented.py:
//   K1  mttkrp_oriented_carry_pallas (:358; body _mttkrp_carry_kernel :333,
//       _carry_step :254) — a sequential grid whose carry scratch hands the
//       open run of one block to the next;
//   K2  mttkrp_oriented_partials_pallas (:132; body :108) — per-block run
//       sums as a one-hot (block_m x block_m) matmul on the MXU;
//   K8  mttkrp_oriented_carry_chunk_pallas (:541; body
//       _mttkrp_carry_chunk_kernel :511) — K1 over one chunk of a
//       host-resident stream, the running out and the open run carried in
//       and out (carry_chunk.cuh: K1's runs pass + the chunk fix-up);
// and the boundary merge ops.segment_merge (src/repro/kernels/ops.py:171,
// a jnp scatter-add, not a Pallas kernel).
//
// Design. The input is the row-sorted stream of one mode (rows, words,
// values), padded to a multiple of block_m. Blocks of the stream run in
// parallel and in no order, so nothing is carried from one slice to the
// next inside a kernel:
//   * K1's runs pass (mttkrp_carry_runs_kernel, alto_scan.cuh): a sub-warp
//     per block_m slice, its lanes on the rank columns (four each at
//     r_block 16), words decoded once per nonzero through the byte tables.
//     It stores every run that begins and ends inside its slice straight
//     to out, zeros to the rows the stream skips, and the slice's first
//     and last runs, with their rows, to a carries buffer (n_blocks, 2, R).
//   * The fix-up walk (carry_fixup.cuh) adds the carried pieces of each
//     row in block order and stores the row: a warp per tile of 32
//     pieces, the tile's values staged in shared memory, a chain that
//     leaves the tile walked on 32 steps a window. Deterministic, no
//     float atomics. So every row of out is written
//     exactly once, and K1's wrapper allocates out without a memset.
//   * K2 is the same runs pass in its slot layout (SLOTS): slot j of
//     block b gets the block's j-th run, the unused slots zeros (the JAX
//     partials layout). The port's segment_merge splits the slots on the
//     card (segment_split.cuh: inner runs and gap zeros to out, the first
//     and last runs to the carries) and sends the carries through the same
//     fix-up. K1 and K2 + segment_merge add the same terms in the same
//     order and agree bit for bit.
// The fix-up also finishes the Φ carry route (K5) and, with one slot per
// piece, the deterministic pull reduction (ops.pull_reduction).
//
// What bounds it on an H100: bytes. Each nonzero reads its row (4 B), its
// words (4·W B), its value (4 B) and one factor row of each other mode
// (gathers, mostly from L2 when the factors fit in 50 MB); out is written
// once. K2 also writes the (M, R) partials, of which the split reads the
// used slots back — the round trip the carry design removes.
#include "alto_scan.cuh"
#include "carry_chunk.cuh"
#include "segment_split.cuh"

namespace {

struct CarryRunsArgs {     // the operands of K1's runs pass (K8's, K2's)
  AltoArgs a;              // a.dtab: the byte decode tables
  Tenants tn;              // the tenant axis (one tenant for K8)
  const int* rows;
  const uint32_t* words;
  const float* values;
  int64_t block_m, n_blocks;
  int r_block;
  int n_rows;              // rows of out
  bool zero_gaps;
  int threads;             // CTA threads, whole warps
  float* out;
  int* carry_row;
  float* carry_val;
  float* partials;         // K2's slots, else null
  cudaStream_t stream;
};

// Rows of the factors, out, the carries and the slots start on 16 bytes in the rank
// tile: a lane's four columns may move as one float4.
inline bool aligned4(const CarryRunsArgs& p) {
  bool ok = p.a.rank % 4 == 0 && p.r_block % 4 == 0 &&
            reinterpret_cast<uintptr_t>(p.out) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.carry_val) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.partials) % 16 == 0;
  for (int m = 0; m < p.a.ndim; ++m)
    ok = ok && reinterpret_cast<uintptr_t>(p.a.factors[m]) % 16 == 0;
  return ok;
}

template <int W, int COLS>
struct MttkrpCarryRunsLaunch {
  static int run(const CarryRunsArgs& p) {
    const int64_t per_cta = p.threads / W;
    const dim3 grid(
        static_cast<unsigned>((p.n_blocks + per_cta - 1) / per_cta),
        static_cast<unsigned>(p.a.rank / p.r_block),
        static_cast<unsigned>(p.tn.count));
    if (p.partials != nullptr)
      mttkrp_carry_runs_kernel<W, COLS, K1_UNROLL, true>
          <<<grid, p.threads, 0, p.stream>>>(
              p.a, p.tn, p.rows, p.words, p.values, p.block_m, p.n_blocks,
              p.r_block, p.n_rows, p.zero_gaps, aligned4(p), p.out,
              p.carry_row, p.carry_val, p.partials);
    else
      mttkrp_carry_runs_kernel<W, COLS, K1_UNROLL, false>
          <<<grid, p.threads, 0, p.stream>>>(
              p.a, p.tn, p.rows, p.words, p.values, p.block_m, p.n_blocks,
              p.r_block, p.n_rows, p.zero_gaps, aligned4(p), p.out,
              p.carry_row, p.carry_val, p.partials);
    return static_cast<int>(cudaGetLastError());
  }
};

// K1's runs pass under the lane map (lanes, cols): a sub-warp of `lanes`
// lanes per slice, `cols` columns per lane, chosen by the wrapper from
// r_block (kernels/mttkrp_oriented.py `LANE_MAPS`: about four columns a
// lane, as K5's; k1_lane_dispatch refuses any other).
inline int launch_mttkrp_carry_runs(int lanes, int cols,
                                    const CarryRunsArgs& p) {
  const AltoArgs& a = p.a;
  if (p.r_block < 1 || a.rank % p.r_block != 0 || lanes * cols < p.r_block ||
      p.threads < 32 || p.threads > 1024 || p.threads % 32 != 0 ||
      p.block_m < 1 || p.n_blocks < 0 || a.dtab == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_blocks == 0) return 0;
  return k1_lane_dispatch<MttkrpCarryRunsLaunch>(lanes, cols, p);
}

}  // namespace

extern "C" {

// K1, runs pass: inner runs and the zeros of skipped rows into out (of
// n_rows rows), the slices' first and last runs into the carries. dtab:
// the byte decode tables; (lanes, cols): the lane map; threads: CTA size
// (whole warps). n_tenants stacked tenants (the tenant axis, Tenants in
// alto_decode.cuh): tenant_strides holds the elements between two tenants'
// factor m (ndim entries), then between two tenants' out; null for one.
int alto_carry_runs(const int64_t* factor_ptrs, const int* runs, int n_runs,
                    int ndim, int nwords, int mode, int rank,
                    const void* rows, const void* words, const void* values,
                    const void* dtab, long long block_m, long long n_blocks,
                    int r_block, int lanes, int cols, int threads,
                    int n_rows, void* out, void* carry_row, void* carry_val,
                    int n_tenants, const int64_t* tenant_strides,
                    void* stream) {
  CarryRunsArgs p{};
  if (!alto_make_args(&p.a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) ||
      !tenants_make(&p.tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  p.a.dtab = static_cast<const uint32_t*>(dtab);
  p.rows = static_cast<const int*>(rows);
  p.words = static_cast<const uint32_t*>(words);
  p.values = static_cast<const float*>(values);
  p.block_m = block_m;
  p.n_blocks = n_blocks;
  p.r_block = r_block;
  p.n_rows = n_rows;
  p.zero_gaps = true;
  p.threads = threads;
  p.out = static_cast<float*>(out);
  p.carry_row = static_cast<int*>(carry_row);
  p.carry_val = static_cast<float*>(carry_val);
  p.stream = static_cast<cudaStream_t>(stream);
  return launch_mttkrp_carry_runs(lanes, cols, p);
}

// K1, fix-up walk (also the deterministic half of segment_merge, of the K5
// route and of the pull reduction): n_pieces pieces in `slots` slots per
// block, rank tile r_block, CTAs of `threads` (carry_fixup.cuh); over
// n_tenants stacked tenants, each with n_pieces pieces and out_stride
// elements of out.
int alto_carry_fixup(const void* carry_row, const void* carry_val,
                     long long n_pieces, int slots, int rank, int r_block,
                     int threads, void* out, int n_tenants,
                     long long out_stride, void* stream) {
  FixupArgs f{};
  f.tenants = n_tenants;
  f.out_stride = out_stride;
  f.row = static_cast<const int*>(carry_row);
  f.val = static_cast<const float*>(carry_val);
  f.n = n_pieces;
  f.slots = slots;
  f.R = rank;
  f.rb = r_block;
  f.out = static_cast<float*>(out);
  return launch_carry_fixup(f, threads, static_cast<cudaStream_t>(stream));
}

// K8: one chunk of the carry route: K1's runs pass, then the chunk fix-up,
// both in rank tiles of r_block. out is the running output (zeros at
// rows no earlier chunk has reached); pieces_row (n_blocks, 2) and
// pieces_val (n_blocks, 2, rank) are scratch; (cin_row, cin_val) is the
// open run handed in, (cout_row, cout_val) the one handed on (-1 and zeros
// after the final chunk). cin and cout must not alias.
int alto_carry_chunk(const int64_t* factor_ptrs, const int* runs, int n_runs,
                     int ndim, int nwords, int mode, int rank,
                     const void* rows, const void* words, const void* values,
                     const void* dtab, long long block_m, long long n_blocks,
                     int r_block, int lanes, int cols, int threads,
                     void* out, void* pieces_row, void* pieces_val,
                     const void* cin_row, const void* cin_val,
                     int final_chunk, void* cout_row, void* cout_val,
                     void* stream) {
  CarryRunsArgs p{};
  if (!alto_make_args(&p.a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) || n_blocks < 1 ||
      !tenants_make(&p.tn, 1, nullptr, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  p.a.dtab = static_cast<const uint32_t*>(dtab);
  p.rows = static_cast<const int*>(rows);
  p.words = static_cast<const uint32_t*>(words);
  p.values = static_cast<const float*>(values);
  p.block_m = block_m;
  p.n_blocks = n_blocks;
  p.r_block = r_block;
  p.n_rows = 0;
  p.zero_gaps = false;
  p.threads = threads;
  p.out = static_cast<float*>(out);
  p.carry_row = static_cast<int*>(pieces_row);
  p.carry_val = static_cast<float*>(pieces_val);
  p.stream = static_cast<cudaStream_t>(stream);
  const int status = launch_mttkrp_carry_runs(lanes, cols, p);
  if (status != 0) return status;
  return launch_carry_fixup_chunk(rank, r_block, threads, n_blocks,
                                  pieces_row,
                                  pieces_val, cin_row, cin_val, final_chunk,
                                  out, cout_row, cout_val, p.stream);
}

// K2: K1's runs pass into the slots partials (n_blocks, block_m, rank):
// slot j of slice b the slice's j-th run, zeros in the unused slots (every
// slot is written). dtab, (lanes, cols), threads, n_tenants and
// tenant_strides: as alto_carry_runs.
int alto_oriented_partials(const int64_t* factor_ptrs, const int* runs,
                           int n_runs, int ndim, int nwords, int mode,
                           int rank, const void* rows, const void* words,
                           const void* values, const void* dtab,
                           long long block_m, long long n_blocks, int r_block,
                           int lanes, int cols, int threads, void* partials,
                           int n_tenants, const int64_t* tenant_strides,
                           void* stream) {
  CarryRunsArgs p{};
  if (!alto_make_args(&p.a, factor_ptrs, runs, n_runs, ndim, nwords, mode,
                      rank) || partials == nullptr ||
      !tenants_make(&p.tn, n_tenants, tenant_strides, ndim))
    return static_cast<int>(cudaErrorInvalidValue);
  p.a.dtab = static_cast<const uint32_t*>(dtab);
  p.rows = static_cast<const int*>(rows);
  p.words = static_cast<const uint32_t*>(words);
  p.values = static_cast<const float*>(values);
  p.block_m = block_m;
  p.n_blocks = n_blocks;
  p.r_block = r_block;
  p.zero_gaps = false;
  p.threads = threads;
  p.partials = static_cast<float*>(partials);
  p.stream = static_cast<cudaStream_t>(stream);
  return launch_mttkrp_carry_runs(lanes, cols, p);
}

// segment_merge's split: the slots partials (n_blocks, block_m, rank) of
// the padded stream `rows` -> inner runs and the zeros of skipped rows
// into out (n_rows, rank), the slices' first and last runs into the
// carries (segment_split.cuh); a warp per slice, sub-warps of the lane map
// (lanes, cols), CTAs of `threads` (whole warps); over n_tenants stacked
// tenants, each with n_blocks slices and n_rows rows of out.
int alto_segment_split(const void* partials, const void* rows,
                       long long block_m, long long n_blocks, int rank,
                       int lanes, int cols, int threads, int n_rows,
                       void* out, void* carry_row, void* carry_val,
                       int n_tenants, void* stream) {
  SplitArgs p{};
  p.tenants = n_tenants;
  p.partials = static_cast<const float*>(partials);
  p.rows = static_cast<const int*>(rows);
  p.block_m = block_m;
  p.n_blocks = n_blocks;
  p.R = rank;
  p.n_rows = n_rows;
  p.threads = threads;
  p.out = static_cast<float*>(out);
  p.carry_row = static_cast<int*>(carry_row);
  p.carry_val = static_cast<float*>(carry_val);
  p.stream = static_cast<cudaStream_t>(stream);
  return launch_segment_split(lanes, cols, p);
}

}  // extern "C"
