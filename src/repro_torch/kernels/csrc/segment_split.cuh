// The split of ops.segment_merge on the card: per-slice run sums (the
// slots of K2 and K6, (n_blocks, block_m, R)) -> every inner run stored to
// its row of out, zeros to the rows the stream skips, and each slice's
// first and last runs, with their rows, to the carries (n_blocks, 2) /
// (n_blocks, 2, R) that the fix-up walk (carry_fixup.cuh) merges. It is
// the layout of K1's runs pass (mttkrp_carry_runs_kernel, alto_scan.cuh),
// gap zeros included, so with the fix-up storing the carried rows every
// row of out is written exactly once and out needs no memset.
//
// Not a port of a Pallas kernel: the JAX segment_merge
// (src/repro/kernels/ops.py:171) is a jnp scatter-add of every slot to
// its run's row. Its plain twin is kernels/mttkrp_oriented.py
// split_block_runs, which it equals bit for bit (it only moves floats) in
// the carries and in out off the carried rows (zeros there in the plain
// version, left to the fix-up here).
//
// Design: a warp per slice. The warp reads the slice's rows 32 at a time;
// a ballot of the positions whose row differs from the one before marks
// where the runs start, and a popcount gives each start its slot j. The
// starts go round-robin to the warp's sub-warps (K1's lane map: W lanes,
// COLS contiguous columns a lane, a float4 where aligned), one ballot per
// sub-warp as in K3's sum phase. A sub-warp stores the zeros of the gap
// below its start's row, then moves slot j: to the carries when it is the
// slice's first run (j = 0) or its last (its row is the slice's last
// row), else to out. Only the used slots are read.
//
// What bounds it on an H100: bytes — the rows (M·4), the used slots, out
// (I_n·R·4) and the carries, each once.
//
// The tenant axis (blockIdx.z): a bucket stacks its tenants' slots, rows,
// out and carries, each tenant's contiguous; a warp splits one slice of
// its own tenant, as in the solo launch.
#pragma once

#include "alto_scan.cuh"

namespace {

// dst[col] = src[col] (zeros where src is null) for the columns lane sl
// of a sub-warp of W lanes holds in a row of R: k·W·COLS + sl·COLS + c.
template <int W, int COLS>
__device__ __forceinline__ void split_move_row(float* dst, const float* src,
                                               int R, int sl, bool vec4) {
  for (int c0 = sl * COLS; c0 < R; c0 += W * COLS) {
    if constexpr (COLS == 4) {
      if (vec4) {
        const float4 v =
            src == nullptr ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                           : __ldg(reinterpret_cast<const float4*>(src + c0));
        *reinterpret_cast<float4*>(dst + c0) = v;
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (c0 + c < R) dst[c0 + c] = src == nullptr ? 0.0f : __ldg(src + c0 + c);
  }
}

template <int W, int COLS>
__global__ void segment_split_kernel(
    const float* __restrict__ partials, const int* __restrict__ rows,
    int64_t block_m, int64_t n_blocks, int R, int n_rows, bool vec4,
    float* __restrict__ out, int* __restrict__ carry_row,
    float* __restrict__ carry_val) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int NSUB = 32 / W;
  const int lane = threadIdx.x & 31;
  const int sub = lane / W, sl = lane % W;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (b >= n_blocks) return;                 // the whole warp leaves
  const int64_t t = blockIdx.z;              // the tenant
  partials += t * n_blocks * block_m * R;
  rows += t * n_blocks * block_m;
  out += t * n_rows * static_cast<int64_t>(R);
  carry_row += t * 2 * n_blocks;
  carry_val += t * 2 * n_blocks * R;
  const int64_t s = b * block_m, e = s + block_m;
  const float* const slots = partials + s * R;
  const int last = __ldg(rows + e - 1);      // the row of the last run
  if (__ldg(rows + s) == last) {             // one run: slot 1 is empty
    if (lane == 0) carry_row[2 * b + 1] = -1;
    if (sub == 0)
      split_move_row<W, COLS>(carry_val + (2 * b + 1) * R, nullptr, R, sl,
                              vec4);
  }
  int prev = b == 0 ? -1 : __ldg(rows + s - 1);   // row before the window
  int64_t j0 = 0;                                  // runs begun before it
  for (int64_t w0 = s; w0 < e; w0 += 32) {
    const int64_t i = w0 + lane;
    const bool live = i < e;
    const int r = live ? __ldg(rows + i) : last;
    const int up = __shfl_up_sync(ALL, r, 1);
    const bool start = live && (i == s || r != (lane == 0 ? prev : up));
    const unsigned starts = __ballot_sync(ALL, start);
    const int t = __popc(starts & ((1u << lane) - 1u));   // its rank
    unsigned mine = 0;
#pragma unroll
    for (int q = 0; q < NSUB; ++q) {
      const unsigned m = __ballot_sync(ALL, start && t % NSUB == q);
      if (sub == q) mine = m;
    }
    prev = __shfl_sync(ALL, r, 31);
    while (mine != 0) {
      const int k = __ffs(mine) - 1;
      mine &= mine - 1;
      const int64_t pos = w0 + k;
      const int row = __ldg(rows + pos);
      const int64_t j = j0 + __popc(starts & ((1u << k) - 1u));
      const int gap0 = pos == 0 ? 0 : __ldg(rows + pos - 1) + 1;
      for (int g = gap0; g < row; ++g)
        split_move_row<W, COLS>(out + static_cast<int64_t>(g) * R, nullptr,
                                R, sl, vec4);
      float* dst;
      if (j == 0) {
        if (sl == 0) carry_row[2 * b] = row;
        dst = carry_val + (2 * b) * R;
      } else if (row == last) {
        if (sl == 0) carry_row[2 * b + 1] = row;
        dst = carry_val + (2 * b + 1) * R;
      } else {
        dst = out + static_cast<int64_t>(row) * R;
      }
      split_move_row<W, COLS>(dst, slots + j * R, R, sl, vec4);
    }
    j0 += __popc(starts);
  }
  if (b == n_blocks - 1)                     // rows above the last one
    for (int64_t g = last + 1 + sub; g < n_rows; g += NSUB)
      split_move_row<W, COLS>(out + g * R, nullptr, R, sl, vec4);
}

struct SplitArgs {
  const float* partials;
  const int* rows;
  int64_t block_m, n_blocks;
  int R;
  int n_rows;              // rows of out
  int threads;             // CTA threads, whole warps: a warp per slice
  int tenants;             // stacked tenants (gridDim.z), at least 1
  float* out;
  int* carry_row;
  float* carry_val;
  cudaStream_t stream;
};

template <int W, int COLS>
struct SegmentSplitLaunch {
  static int run(const SplitArgs& p) {
    const bool vec4 = p.R % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(p.partials) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.out) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.carry_val) % 16 == 0;
    const int64_t per_cta = p.threads / 32;
    segment_split_kernel<W, COLS>
        <<<dim3(static_cast<unsigned>((p.n_blocks + per_cta - 1) / per_cta),
                1, static_cast<unsigned>(p.tenants)),
           p.threads, 0, p.stream>>>(p.partials, p.rows, p.block_m,
                                     p.n_blocks, p.R, p.n_rows, vec4, p.out,
                                     p.carry_row, p.carry_val);
    return static_cast<int>(cudaGetLastError());
  }
};

// The split under K1's lane map (lanes, cols) (k1_lane_dispatch refuses
// any other).
inline int launch_segment_split(int lanes, int cols, const SplitArgs& p) {
  if (p.R < 1 || p.threads < 32 || p.threads > 1024 || p.threads % 32 != 0 ||
      p.block_m < 1 || p.n_blocks < 0 || p.n_rows < 1 || p.tenants < 1 ||
      p.tenants > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_blocks == 0) return 0;
  return k1_lane_dispatch<SegmentSplitLaunch>(lanes, cols, p);
}

}  // namespace
