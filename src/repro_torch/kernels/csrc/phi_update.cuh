// The per-nonzero CP-APR Φ term of the thread-per-column traversal (K6):
// contrib_r = v / max(<B[row, :], krp>, eps) · krp_r.
//
// Replaces `_phi` (src/repro/core/cpapr.py:78), which every Pallas Φ
// kernel inlines (mttkrp_oriented.py `_phi_oriented_kernel`,
// `_phi_carry_kernel`; cpapr_phi.py `_phi_partial_kernel`).
//
// What bounds it on an H100: the denominator needs the whole rank of the
// nonzero, and here every thread of a slice forms it itself, serially in
// r order, from all R entries of the B row and of the krp row: R times the
// loads and divisions the work needs (broadcast loads within the slice's
// threads). K6 keeps this form; K5, K7 and K9 share one denominator per
// sub-warp through shuffles (phi_scan.cuh), with the same rounding, so
// K5 equals K6 + segment_merge bit for bit.
//
// Rounding contract (extends alto_decode.cuh):
//   * krp_k is the product of the other modes' factor entries in
//     increasing mode order with __fmul_rn (ALTO-OTF), or the Π row read
//     as it is (ALTO-PRE: the target row comes from the caller, the other
//     modes are not decoded);
//   * the dot is __fmul_rn then __fadd_rn in k order from 0.0, then
//     fmaxf(dot, eps);
//   * the term is __fmul_rn(__fdiv_rn(v, denom), krp_r), the order of
//     `(vals / denom)[:, None] * krp`.
// Explicit intrinsics keep nvcc from contracting into FMAs, so the carry
// and the partials routes round alike term by term.
#pragma once

#include "alto_decode.cuh"

namespace {

struct PhiTerm {
  const float* B;   // (I_n, rank): the mode's B = (A + S)Λ
  const float* pi;  // (M, rank) Π rows in stream order (PRE), or nullptr
  float eps;

  __device__ __forceinline__ float operator()(const AltoArgs& a,
                                              const uint32_t* words,
                                              const float* values, int64_t i,
                                              int row, int r) const {
    const int R = a.rank;
    const float* brow = B + static_cast<int64_t>(row) * R;
    float dot = 0.0f;
    float mine = 0.0f;
    if (pi != nullptr) {
      const float* prow = pi + i * R;
      for (int k = 0; k < R; ++k) {
        const float kk = __ldg(prow + k);
        dot = __fadd_rn(dot, __fmul_rn(__ldg(brow + k), kk));
        if (k == r) mine = kk;
      }
    } else {
      // Factor rows of the other modes; nullptr for the target mode and
      // past ndim. Unrolled so the pointers stay in registers.
      const uint32_t* w = words + i * a.nwords;
      const float* frow[ALTO_MAX_MODES];
#pragma unroll
      for (int m = 0; m < ALTO_MAX_MODES; ++m)
        frow[m] = (m < a.ndim && m != a.mode)
                      ? a.factors[m] +
                            static_cast<int64_t>(alto_coord(a, w, m)) * R
                      : nullptr;
      for (int k = 0; k < R; ++k) {
        float kk = 1.0f;
        bool first = true;
#pragma unroll
        for (int m = 0; m < ALTO_MAX_MODES; ++m) {
          if (frow[m] == nullptr) continue;
          const float f = __ldg(frow[m] + k);
          kk = first ? f : __fmul_rn(kk, f);
          first = false;
        }
        dot = __fadd_rn(dot, __fmul_rn(__ldg(brow + k), kk));
        if (k == r) mine = kk;
      }
    }
    const float denom = fmaxf(dot, eps);
    return __fmul_rn(__fdiv_rn(__ldg(values + i), denom), mine);
  }
};

}  // namespace
