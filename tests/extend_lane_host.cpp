// Host build of the CUDA extension kernel's per-lane DP (extend_lane.h),
// so the CPU tests check the kernel's own arithmetic against extend_ref.
// Arguments mirror the kernel's: [B, Q]/[B, T] int8 codes, int32 lanes,
// out [6, B].
#include <vector>

#include "extend_lane.h"

extern "C" void extend_lanes_host(const int8_t* query, const int8_t* target,
                                  const int32_t* qlen, const int32_t* tlen,
                                  const int32_t* w, const int32_t* h0,
                                  const int32_t* sc, int64_t B, int32_t Q,
                                  int32_t T, int32_t o_del, int32_t e_del,
                                  int32_t o_ins, int32_t e_ins, int32_t zdrop,
                                  int32_t* out) {
  std::vector<int32_t> H(Q), E(Q);
  std::vector<int8_t> qs(Q);
  const tpubwa::Gaps g{o_del, e_del, o_ins, e_ins, zdrop};
  const tpubwa::Scores s{sc[0], sc[1], sc[2]};
  for (int64_t b = 0; b < B; ++b) {
    const tpubwa::LaneResult r = tpubwa::extend_lane(
        query + b * Q, target + b * T, tpubwa::min2(qlen[b], Q),
        tpubwa::min2(tlen[b], T), w[b], h0[b], g, s, H.data(), E.data(),
        qs.data(), 1);
    const int32_t v[6] = {r.score, r.qle,    r.tle,
                          r.gtle,  r.gscore, r.max_off};
    for (int k = 0; k < 6; ++k) out[k * B + b] = v[k];
  }
}
