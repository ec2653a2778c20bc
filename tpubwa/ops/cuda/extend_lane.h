// One banded affine-gap seed extension (bwa's ksw_extend2 semantics, as
// defined by tpubwa/ops/extend_ref.py), written for one GPU thread.
//
// Inter-task layout: a thread owns one extension job, the layout of the
// reference's bandedSWA and of SSW.  The row loop runs over target bases,
// the column loop over the band, and F is a scalar carry along the row, so
// no running max across lanes is needed.  The H and E rows live in a
// caller-provided buffer with a stride: on the device, shared memory
// interleaved over the block's threads (stride = threads per block, so a
// warp never has a bank conflict); on the host, a plain array (stride 1),
// which is how the CPU tests check this exact code against extend_ref.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TPUBWA_HD __host__ __device__ __forceinline__
#else
#define TPUBWA_HD inline
#endif

namespace tpubwa {

struct Gaps {
  int32_t o_del, e_del, o_ins, e_ins, zdrop;
};

// the three distinct values of a bwa_fill_scmat matrix
struct Scores {
  int32_t match, mismatch, n;
};

struct LaneResult {
  int32_t score, qle, tle, gtle, gscore, max_off;
};

TPUBWA_HD int32_t max2(int32_t a, int32_t b) { return a > b ? a : b; }
TPUBWA_HD int32_t min2(int32_t a, int32_t b) { return a < b ? a : b; }

// max(a, b, c) and max(a, b, 0): Hopper's DPX instructions on the device
TPUBWA_HD int32_t max3(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  return max2(max2(a, b), c);
#endif
}

TPUBWA_HD int32_t relu_max(int32_t a, int32_t b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax_s32_relu(a, b);
#else
  return max2(max2(a, b), 0);
#endif
}

// q/t: codes 0..4 (4 = N), qlen <= the H/E/qs capacity.  w is the band
// after clamp_band.  H/E/qs are indexed [j * stride].
TPUBWA_HD LaneResult extend_lane(const int8_t* q, const int8_t* t,
                                 int32_t qlen, int32_t tlen, int32_t w,
                                 int32_t h0, Gaps g, Scores s, int32_t* H,
                                 int32_t* E, int8_t* qs, int stride) {
  if (qlen <= 0 || tlen <= 0) return LaneResult{h0, 0, 0, 0, -1, 0};
  const int32_t oe_del = g.o_del + g.e_del;
  const int32_t oe_ins = g.o_ins + g.e_ins;
  // H(-1, j) = max(0, h0 - oe_ins - j*e_ins); E(0, j) = 0.  E[j] holds
  // E(i, j) for the row about to run: it is computed one row ahead.
  for (int32_t j = 0; j < qlen; ++j) {
    qs[j * stride] = q[j];
    H[j * stride] = max2(h0 - oe_ins - j * g.e_ins, 0);
    E[j * stride] = 0;
  }
  int32_t best = h0, best_i = -1, best_j = -1;
  int32_t max_ie = -1, gscore = -1, max_off = 0;
  for (int32_t i = 0; i < tlen; ++i) {
    const int32_t beg = max2(i - w, 0);
    const int32_t end = min2(qlen, i + w + 1);
    const int32_t ti = t[i];
    // H(i-1, beg-1): the boundary column H(i-1, -1) when the band starts
    // at 0, else a cell the previous row's band wrote
    int32_t h_diag = beg > 0 ? H[(beg - 1) * stride]
                     : i == 0 ? h0
                              : max2(h0 - g.o_del - g.e_del * i, 0);
    int32_t f = 0, m = 0, mj = -1;
    for (int32_t j = beg; j < end; ++j) {
      const int32_t qj = qs[j * stride];
      const int32_t sc = (qj >= 4 || ti >= 4) ? s.n
                         : qj == ti           ? s.match
                                              : s.mismatch;
      const int32_t M = h_diag > 0 ? h_diag + sc : 0;
      const int32_t e = E[j * stride];
      h_diag = H[j * stride];
      const int32_t h = max3(M, e, f);
      H[j * stride] = h;
      E[j * stride] = relu_max(M - oe_del, e - g.e_del);
      f = relu_max(f - g.e_ins, M - oe_ins);
      if (h >= m) {
        m = h;
        mj = j;
      }
    }
    if (end == qlen) {  // the band touches the query end
      const int32_t h_last = beg < end ? H[(qlen - 1) * stride] : 0;
      if (h_last >= gscore) {
        gscore = h_last;
        max_ie = i;
      }
    }
    if (m == 0) break;
    if (m > best) {
      best = m;
      best_i = i;
      best_j = mj;
      max_off = max2(max_off, mj > i ? mj - i : i - mj);
    } else if (g.zdrop > 0) {
      const int32_t di = i - best_i, dj = mj - best_j;
      if (di > dj) {
        if (best - m - (di - dj) * g.e_del > g.zdrop) break;
      } else if (best - m - (dj - di) * g.e_ins > g.zdrop) {
        break;
      }
    }
  }
  return LaneResult{best, best_j + 1, best_i + 1, max_ie + 1, gscore,
                    max_off};
}

}  // namespace tpubwa
