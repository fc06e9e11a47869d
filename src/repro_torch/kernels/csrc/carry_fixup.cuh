// The fix-up walk of the carry route, for every caller: K1 and
// segment_merge (K2) (alto_carry_fixup, mttkrp_oriented.cu), the K5 route
// and the fixed-order pull of K3 and K7 (the same entry), and the chunk
// fix-up of K8 and K9 (carry_chunk.cuh).
//
// Replaces the carry hand-off of _carry_step
// (src/repro/kernels/mttkrp_oriented.py:254): on the TPU the open run of
// one block rides a scratch carry into the next grid step; here the blocks
// run in parallel, leave their first and last runs as pieces, and this
// kernel adds each row's pieces in block order.
//
// Pieces are numbered p = slots·b + slot. With two slots (K1's and K5's
// carries, segment_merge, the chunk kernels) slot 0 holds block b's first
// run and slot 1 its last run, row -1 when absent. With one slot (the pull)
// every piece is present and the pieces are sorted by row. A row's pieces
// form a chain: its head, then the next step (slot 0 of the next block, or
// the next piece) while the row goes on; a block holding a second run ends
// the chain at its slot 0.
//
// Fold order, the contract: a chain sums its pieces left to right with
// __fadd_rn, ((p0 + p1) + p2) ..., a chunk's carry-in first. K1 ≡ K2 +
// segment_merge, streamed ≡ in core and the fixed-order pull rest on it.
//
// The walk (carry_fixup_tiles_kernel), with or without the chunk contract:
// a warp per tile of 32 consecutive pieces. The tile's values go to shared
// memory in one coalesced cp.async copy while its rows are loaded; the
// rows (the neighbours' by shuffle) and a ballot of the links give the end
// of every chain inside the tile, and those chains are folded from shared
// memory, a lane per (chain, column) pair. Only the tile's last chain can
// leave the tile; the warp walks it on in windows of 32 steps: one
// coalesced load of the window's rows, two ballots for where the row
// changes or a block's second run ends it, the steps' values copied into
// shared memory with cp.async (two buffers: the next window's copies fly
// while this one is folded; the rows one window further ahead), and a
// lane per column folds them in step order. A Chicago chain of
// ~1,000-3,000 blocks takes ~30-100 windows, not as many dependent loads
// as steps; DARPA's chains of one or two pieces cost one copy and one
// row load per tile.
//
// What bounds it on an H100: bytes — the pieces' rows and values, each
// read once, and one store per chain and column. Each chain's fold is
// serial per column (the contract), so a long chain costs its latency.
//
// The tenant axis (blockIdx.z): a bucket of same-class tenants stacks its
// pieces (tenants, n) and its out (tenants, out_stride elements). Rows
// are tenant-local, so a walk over the concatenated pieces would join
// tenant t's last chain to tenant t + 1's first whenever their rows are
// equal; here each tenant's blocks walk only that tenant's pieces, with
// the solo launch's tiles and fold order.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int FIX_WIN = 32;          // pieces per tile, steps per window
constexpr int FIX_MAX_COLS = 4;      // columns per lane: a rank tile of at
                                     // most 128 columns

// The chunk contract of K8 and K9 (carry_chunk.cuh); cin_row null in core.
struct FixupChunk {
  const int* cin_row;
  const float* cin_val;
  int final_chunk;
  int* cout_row;
  float* cout_val;
};

struct FixupArgs {
  const int* row;        // (n) piece rows (per tenant)
  const float* val;      // (n, R) piece values
  int64_t n;             // pieces per tenant
  int tenants;           // stacked tenants (gridDim.z), at least 1
  int64_t out_stride;    // elements between two tenants' out
  int slots;
  int R;                 // row stride of val and out
  int rb;                // rank tile: columns blockIdx.y·rb ... + rb
  float* out;
  bool vec4;             // rb, R and val 4-float aligned
  FixupChunk ck;
};

// Piece q is the last present piece of the stream.
__device__ __forceinline__ bool fixup_holds_last(const FixupArgs& f,
                                                 int64_t q) {
  return q == f.n - 1 ||
         (q == f.n - 2 && f.slots == 2 && f.row[f.n - 1] < 0);
}

// (b) and (d) of the chunk contract, by the threads of piece 0: a carry-in
// whose run closed on the boundary is stored; a final chunk hands on an
// empty carry. Columns col0 + c, c = first, first + stride, ... < rb.
__device__ __forceinline__ void fixup_chunk_start(const FixupArgs& f,
                                                  int row0, int col0,
                                                  int first, int stride,
                                                  bool writes_row) {
  const int crow = f.ck.cin_row[0];
  for (int c = first; c < f.rb; c += stride) {
    if (crow >= 0 && crow != row0)
      f.out[static_cast<int64_t>(crow) * f.R + col0 + c] =
          f.ck.cin_val[col0 + c];
    if (f.ck.final_chunk) f.ck.cout_val[col0 + c] = 0.0f;
  }
  if (f.ck.final_chunk && writes_row) f.ck.cout_row[0] = -1;
}

// ---------------------------------------------------------------------------
// The walk: a warp per tile of 32 pieces.
// ---------------------------------------------------------------------------

// Shared memory of one warp, in 4-byte words: the tile's list of chains
// that end inside it (2 × 32 ints) and two buffers of FIX_WIN × rb values
// (buffer 1 holds the tile's values first, then the long chain's windows
// alternate between the two).
__host__ __device__ inline size_t fixup_warp_words(int rb) {
  return 64 + 2 * static_cast<size_t>(FIX_WIN) * rb;
}

// Steps of a window that a chain of row `row` takes, from lane j's rows
// (r0 its step piece, r1 that block's slot 1): k, and whether the chain
// ends inside the window.
__device__ __forceinline__ void fixup_window_extent(int r0, int r1, int row,
                                                    int slots, int& k,
                                                    bool& done) {
  const bool cont = r0 == row;
  const bool lnk = cont && (slots == 1 || r1 < 0);
  const unsigned stop = __ballot_sync(0xffffffffu, !cont);
  const unsigned endm = __ballot_sync(0xffffffffu, cont && !lnk);
  const int ks = stop ? __ffs(stop) - 1 : FIX_WIN;
  const int ke = endm ? __ffs(endm) : FIX_WIN;
  k = ks < ke ? ks : ke;
  done = (stop | endm) != 0;
}

// Copy the values of k steps into buf (k × rb), asynchronously: step j is
// piece first + stride·j (stride: slots for a window's steps, 1 for a
// tile's pieces). In 16-byte pieces where rb and the rows are 4-float
// aligned (f.vec4), else float by float. Lane l copies pieces l, l + 32,
// ...; its (step, piece) pair advances by 32 pieces without a division.
__device__ __forceinline__ void fixup_stage(const FixupArgs& f, float* buf,
                                            int64_t first, int stride,
                                            int k, int col0, int lane) {
  const int width = f.vec4 ? 4 : 1;          // floats per copy
  const int per_step = f.rb / width;         // copies per step
  const int dj = 32 / per_step, dc = 32 - dj * per_step;
  int j = lane / per_step, c = lane - j * per_step;
  const float* src = f.val + col0;
  for (int idx = lane; idx < k * per_step; idx += 32) {
    const int64_t off = (first + static_cast<int64_t>(stride) * j) * f.R +
                        c * width;
    if (f.vec4)
      __pipeline_memcpy_async(buf + idx * 4, src + off, 16);
    else
      __pipeline_memcpy_async(buf + idx, src + off, sizeof(float));
    j += dj;
    c += dc;
    if (c >= per_step) {
      c -= per_step;
      ++j;
    }
  }
}

// The rows of a window's steps for lane j: its step piece and, with two
// slots, that block's slot 1 (-1 past the end).
__device__ __forceinline__ int2 fixup_window_rows(const FixupArgs& f,
                                                  int64_t s, int lane) {
  const int64_t q = f.slots * (s + lane);
  if (q >= f.n) return make_int2(-1, -1);
  return make_int2(__ldg(f.row + q), f.slots == 2 ? __ldg(f.row + q + 1)
                                                  : -1);
}

// acc[c] += the k staged steps of column c·32 + lane, in step order.
__device__ __forceinline__ void fixup_fold(const float* w, int k, int rb,
                                           int lane,
                                           float (&acc)[FIX_MAX_COLS]) {
#pragma unroll
  for (int c = 0; c < FIX_MAX_COLS; ++c) {
    const int col = c * 32 + lane;
    if (col >= rb) continue;
    float a = acc[c];
    if (k == FIX_WIN) {                      // a full window: loads first
#pragma unroll
      for (int j = 0; j < FIX_WIN; ++j) a = __fadd_rn(a, w[j * rb + col]);
    } else {
      for (int j = 0; j < k; ++j) a = __fadd_rn(a, w[j * rb + col]);
    }
    acc[c] = a;
  }
}

__global__ void carry_fixup_tiles_kernel(const FixupArgs ft) {
  extern __shared__ float fix_smem[];
  FixupArgs f = ft;                        // this block's tenant
  const int64_t tenant = blockIdx.z;
  f.row += tenant * f.n;
  f.val += tenant * f.n * f.R;
  f.out += tenant * f.out_stride;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * 32;
  if (base >= f.n) return;                          // the whole warp
  float* wsm = fix_smem + warp * fixup_warp_words(f.rb);
  int* s_list = reinterpret_cast<int*>(wsm);
  int* s_row = s_list + 32;
  float* s_buf = wsm + 64;
  const int R = f.R, slots = f.slots, col0 = blockIdx.y * f.rb;
  const int win = FIX_WIN * f.rb;          // floats per window buffer
  float* s_tile = s_buf + win;             // the tile's values: buffer 1
  const bool chunk = f.ck.cin_row != nullptr;

  // The tile's values, on their way to shared memory (one coalesced copy)
  // while its rows are loaded and its chains found.
  const int kt = f.n - base < FIX_WIN ? static_cast<int>(f.n - base)
                                      : FIX_WIN;
  fixup_stage(f, s_tile, base, 1, kt, col0, lane);
  __pipeline_commit();

  // The tile's rows, and (loaded alongside, for a chain that leaves the
  // tile) the rows of the first window of steps past it.
  const int64_t p = base + lane;
  const int row = p < f.n ? __ldg(f.row + p) : -1;
  int64_t s = (base + FIX_WIN) / slots;    // first step past the tile
  const int2 wr = fixup_window_rows(f, s, lane);
  // Neighbours from the other lanes; past the tile, from wr (its lane 0
  // holds pieces base + 32 and, with two slots, base + 33).
  const int up1 = __shfl_up_sync(all, row, 1);
  const int up2 = __shfl_up_sync(all, row, 2);
  const int dn1 = __shfl_down_sync(all, row, 1);
  const int dn2 = __shfl_down_sync(all, row, 2);
  const int nx0 = __shfl_sync(all, wr.x, 0);
  const int nx1 = __shfl_sync(all, wr.y, 0);
  const int next1 = lane < 31 ? dn1 : nx0;                   // piece p + 1
  const int next2 = lane < 30 ? dn2 : (lane == 30 ? nx0 : nx1);  // p + 2
  const int64_t b = p / slots;
  const int slot = static_cast<int>(p - slots * b);
  bool head = row >= 0;
  if (head && slot == 0 && b > 0) {
    int prev = lane >= 1 ? up1 : __ldg(f.row + p - 1);  // previous block's
    if (prev < 0 && slots == 2)                          // last run, or its
      prev = lane >= 2 ? up2 : __ldg(f.row + p - 2);     // only one
    if (prev == row) head = false;         // not the head of its chain
  }
  // The chain's next step: slot 0 of the next block (p + 2 from a slot 0,
  // p + 1 from a slot 1), or the next piece; rows past n read as -1.
  const int64_t np = slots * (b + 1);
  const bool link = row >= 0 && (slots == 1 || slot == 1 || next1 < 0) &&
                    (np - p == 2 ? next2 : next1) == row;
  const unsigned links = __ballot_sync(all, link);
  int end = lane;                          // last chain piece, as a lane;
  if (head && link) {                      // FIX_WIN: beyond the tile
    const int64_t nl = np - base;
    end = FIX_WIN;
    if (nl < FIX_WIN) {
      const unsigned steps = slots == 2 ? 0x55555555u : all;
      const unsigned cand = ~links & steps & (all << nl);
      if (cand) end = __ffs(cand) - 1;
    }
  }
  const bool cin_here = chunk && p == 0 && f.ck.cin_row[0] == row;
  if (chunk && base == 0)
    fixup_chunk_start(f, __shfl_sync(all, row, 0), col0, lane, 32,
                      lane == 0 && blockIdx.y == 0);

  // The chain that leaves the tile, if any: its first window's extent, and
  // that window's values on their way to shared memory while the chains
  // inside the tile are folded.
  const unsigned longs = __ballot_sync(all, head && end == FIX_WIN);
  const int hl = longs ? __ffs(longs) - 1 : 0;
  const int lrow = __shfl_sync(all, row, hl);
  const bool lcin = __shfl_sync(all, cin_here, hl);
  int k = 0;
  bool done = true;
  int2 rn = make_int2(-1, -1);
  if (longs) {
    fixup_window_extent(wr.x, wr.y, lrow, slots, k, done);
    fixup_stage(f, s_buf, slots * s, slots, k, col0, lane);
    if (!done) rn = fixup_window_rows(f, s + FIX_WIN, lane);
  }
  __pipeline_commit();

  // Chains that end inside the tile: a lane per (chain, column), from the
  // tile's values in shared memory.
  const bool is_short = head && end < FIX_WIN;
  const unsigned shorts = __ballot_sync(all, is_short);
  if (is_short) {
    const int j = __popc(shorts & ((1u << lane) - 1u));
    const bool to_cout = chunk && !f.ck.final_chunk &&
                         fixup_holds_last(f, base + end);
    s_list[j] = lane | (end << 8) | (cin_here << 16) | (to_cout << 17);
    s_row[j] = row;
  }
  __pipeline_wait_prior(1);                // the tile's values
  __syncwarp();
  const int n_pairs = __popc(shorts) * f.rb;
  for (int idx = lane; idx < n_pairs; idx += 32) {
    const int j = idx / f.rb, c = idx - j * f.rb;
    const int e = s_list[j];
    const int h = e & 255, last = (e >> 8) & 255;
    float acc = s_tile[h * f.rb + c];
    if (e & (1 << 16)) acc = __fadd_rn(__ldg(f.ck.cin_val + col0 + c), acc);
    for (int q = slots * (h / slots + 1); q <= last; q += slots)
      acc = __fadd_rn(acc, s_tile[q * f.rb + c]);
    if (e & (1 << 17)) {
      f.ck.cout_val[col0 + c] = acc;
      if (col0 + c == 0) f.ck.cout_row[0] = s_row[j];
    } else {
      f.out[static_cast<int64_t>(s_row[j]) * R + col0 + c] = acc;
    }
  }
  if (longs == 0) return;

  // The long chain: its pieces inside the tile (all 32 are there), then
  // its windows, a lane per column.
  float acc[FIX_MAX_COLS];
#pragma unroll
  for (int c = 0; c < FIX_MAX_COLS; ++c) {
    const int col = c * 32 + lane;
    acc[c] = 0.0f;
    if (col >= f.rb) continue;
    float a = s_tile[hl * f.rb + col];
    if (lcin) a = __fadd_rn(__ldg(f.ck.cin_val + col0 + col), a);
    for (int q = slots * (hl / slots + 1); q < FIX_WIN; q += slots)
      a = __fadd_rn(a, s_tile[q * f.rb + col]);
    acc[c] = a;
  }
  __syncwarp();                            // buffer 1 free for a window
  int64_t last = slots * (s + k - 1);      // k >= 1: the chain left the tile
  for (int cur = 0;; cur ^= 1) {
    const int64_t sn = s + FIX_WIN;
    int kn = 0;
    bool dn = true;
    if (!done) {                           // the next window's extent and
      fixup_window_extent(rn.x, rn.y, lrow, slots, kn, dn);   // copies,
      fixup_stage(f, s_buf + (cur ^ 1) * win, slots * sn, slots, kn,
                  col0, lane);
      if (!dn) rn = fixup_window_rows(f, sn + FIX_WIN, lane);  // and rows
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    fixup_fold(s_buf + cur * win, k, f.rb, lane, acc);
    __syncwarp();
    if (done) break;
    s = sn;
    k = kn;
    done = dn;
    if (k > 0) last = slots * (s + k - 1);
  }
  const bool to_cout = chunk && !f.ck.final_chunk && fixup_holds_last(f, last);
  if (to_cout && lane == 0 && blockIdx.y == 0) f.ck.cout_row[0] = lrow;
#pragma unroll
  for (int c = 0; c < FIX_MAX_COLS; ++c) {
    const int col = c * 32 + lane;
    if (col >= f.rb) continue;
    if (to_cout)
      f.ck.cout_val[col0 + col] = acc[c];
    else
      f.out[static_cast<int64_t>(lrow) * R + col0 + col] = acc[c];
  }
}

// Launch the walk over n pieces of each of f.tenants tenants, rank tile
// f.rb (blockIdx.y), CTAs of about `threads` threads (whole warps).
inline int launch_carry_fixup(const FixupArgs& f, int threads,
                              cudaStream_t stream) {
  if (f.rb < 1 || f.rb > 32 * FIX_MAX_COLS || f.R % f.rb != 0 ||
      f.slots < 1 || f.slots > 2 || f.n < 0 || threads < 1 ||
      threads > 1024 || f.tenants < 1 || f.tenants > 65535 ||
      (f.ck.cin_row != nullptr && (f.slots != 2 || f.tenants > 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f.n == 0) return 0;
  FixupArgs g = f;
  g.vec4 = f.rb % 4 == 0 && f.R % 4 == 0 &&
           reinterpret_cast<uintptr_t>(f.val) % 16 == 0;
  const size_t per_warp = fixup_warp_words(f.rb) * 4;
  int warps = threads / 32;
  if (warps < 1) warps = 1;
  while (warps > 1 && warps * per_warp > 48 * 1024) --warps;
  const int64_t n_tiles = (f.n + FIX_WIN - 1) / FIX_WIN;
  carry_fixup_tiles_kernel<<<
      dim3(static_cast<unsigned>((n_tiles + warps - 1) / warps),
           static_cast<unsigned>(f.R / f.rb),
           static_cast<unsigned>(f.tenants)),
      warps * 32, warps * per_warp, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
