// ALTO word decode, shared by the hand-written kernels: the BitRun chain
// (alto_coord, the definition) and the byte tables the kernels decode
// through (alto_coord_table).
//
// Replaces the Pallas helper `_decode` (src/repro/kernels/mttkrp.py:36),
// which every TPU kernel inlines: a static shift/mask/or chain per BitRun
// of the encoding. Here the BitRun plan arrives as a small table inside
// the kernel's by-value argument struct, grouped by mode, so decoding one
// coordinate touches only that mode's runs.
//
// Arithmetic contract: the Khatri-Rao product multiplies the other modes'
// factor entries in increasing mode order, then scales by the value, with
// __fmul_rn (no contraction into an FMA). The run sums in the kernels use
// __fadd_rn. So every kernel rounds exactly as its plain PyTorch version
// does, element by element; only the order of the sums can differ.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ALTO_MAX_MODES 8
#define ALTO_MAX_RUNS 128

struct AltoArgs {
  const float* factors[ALTO_MAX_MODES];  // (I_m, rank) row-major; the
                                         // target mode's entry is unused
  int ndim;
  int nwords;
  int mode;                              // target mode
  int rank;                              // row stride of factors and outputs
  int run_start[ALTO_MAX_MODES + 1];     // runs of mode m: [run_start[m],
                                         // run_start[m + 1])
  unsigned char run_word[ALTO_MAX_RUNS];
  unsigned char run_src[ALTO_MAX_RUNS];  // bit offset inside the coordinate
  unsigned char run_dst[ALTO_MAX_RUNS];  // bit offset inside the word
  unsigned char run_len[ALTO_MAX_RUNS];
  const uint32_t* dtab;                  // byte decode tables, or nullptr:
                                         // (ndim, nwords, 4, 256) entries
};

// Host side: fill the struct from a (n_runs, 5) int table of
// (word, mode, src_shift, dst_shift, length) rows sorted by mode, and the
// device addresses of all ndim factors. Returns false on a table the
// struct cannot hold.
static inline bool alto_make_args(AltoArgs* a, const int64_t* factor_ptrs,
                                  const int* runs, int n_runs, int ndim,
                                  int nwords, int mode, int rank) {
  if (ndim < 2 || ndim > ALTO_MAX_MODES || n_runs < 0 ||
      n_runs > ALTO_MAX_RUNS || mode < 0 || mode >= ndim || rank < 1)
    return false;
  a->ndim = ndim;
  a->nwords = nwords;
  a->dtab = nullptr;
  a->mode = mode;
  a->rank = rank;
  for (int m = 0; m < ALTO_MAX_MODES; ++m)
    a->factors[m] = m < ndim ? reinterpret_cast<const float*>(factor_ptrs[m])
                             : nullptr;
  for (int m = 0; m <= ALTO_MAX_MODES; ++m) a->run_start[m] = 0;
  int prev_mode = 0;
  for (int k = 0; k < n_runs; ++k) {
    const int* r = runs + 5 * k;
    if (r[1] < prev_mode || r[1] >= ndim || r[0] >= nwords) return false;
    prev_mode = r[1];
    a->run_word[k] = static_cast<unsigned char>(r[0]);
    a->run_src[k] = static_cast<unsigned char>(r[2]);
    a->run_dst[k] = static_cast<unsigned char>(r[3]);
    a->run_len[k] = static_cast<unsigned char>(r[4]);
    a->run_start[r[1] + 1] = k + 1;
  }
  // Modes without runs (length-1 modes) start where the previous ended.
  for (int m = 1; m <= ALTO_MAX_MODES; ++m)
    if (a->run_start[m] < a->run_start[m - 1])
      a->run_start[m] = a->run_start[m - 1];
  return true;
}

// A bucket's tenant axis, shared by every in-core kernel: one launch over
// `count` tenants of one shape class, whose operands are stacked, each
// tenant's contiguous. How a kernel finds its tenant is its own (the scans
// of alto_scan.cuh: blockIdx.z; delinearize.cu's Π rows: its tile walk).
// A solo launch is one tenant with zero strides.
struct Tenants {
  int count;                        // tenants in the launch
  int64_t factor[ALTO_MAX_MODES];   // elements between tenants' factor m
  int64_t rows;                     // elements between tenants' out and B
};

// Host side: `count` tenants with strides[0 .. ndim) the factors' and
// strides[ndim] out's (null strides: one tenant). False on a count the
// grid cannot hold.
static inline bool tenants_make(Tenants* t, int count,
                                const int64_t* strides, int ndim) {
  if (count < 1 || count > 65535 || (count > 1 && strides == nullptr))
    return false;
  t->count = count;
  for (int m = 0; m < ALTO_MAX_MODES; ++m)
    t->factor[m] = strides != nullptr && m < ndim ? strides[m] : 0;
  t->rows = strides != nullptr ? strides[ndim] : 0;
  return true;
}

// Coordinate of mode m of the element whose words start at w.
__device__ __forceinline__ int alto_coord(const AltoArgs& a,
                                          const uint32_t* w, int m) {
  uint32_t c = 0;
  for (int k = a.run_start[m]; k < a.run_start[m + 1]; ++k) {
    const uint32_t len = a.run_len[k];
    const uint32_t mask = len >= 32 ? 0xffffffffu : ((1u << len) - 1u);
    c |= ((__ldg(w + a.run_word[k]) >> a.run_dst[k]) & mask) << a.run_src[k];
  }
  return static_cast<int>(c);
}

// Coordinate of mode m through the byte tables a.dtab: entry
// ((m·nwords + k)·4 + j)·256 + v holds the bits of mode m that byte j of
// word k carries when it equals v, already in place. Shifts and masks
// distribute over OR, so the OR of the word's lookups is alto_coord.
__device__ __forceinline__ int alto_coord_table(const AltoArgs& a,
                                                const uint32_t* w, int m) {
  const uint32_t* t = a.dtab + static_cast<int64_t>(m) * a.nwords * 1024;
  uint32_t c = 0;
  for (int k = 0; k < a.nwords; ++k, t += 1024) {
    const uint32_t x = __ldg(w + k);
    c |= __ldg(t + (x & 255u)) | __ldg(t + 256 + ((x >> 8) & 255u)) |
         __ldg(t + 512 + ((x >> 16) & 255u)) | __ldg(t + 768 + (x >> 24));
  }
  return static_cast<int>(c);
}
