// Batched banded seed extension on Hopper, called from JAX through the XLA
// foreign function interface (tpubwa/ops/extend_cuda.py builds and
// registers it).  One thread runs one extension job to its own end
// (extend_lane.h); the whole row loop stays inside one kernel launch.
#include <cuda_runtime.h>

#include <string>

#include "extend_lane.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// lanes per block: one warp.  The block's shared memory holds its lanes'
// H and E rows (int32) and query codes (int8), so a wave of 8192 jobs
// spreads over 256 blocks on the card's 132 SMs.
constexpr int kLanes = 32;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void extend_kernel(const int8_t* __restrict__ query,
                              const int8_t* __restrict__ target,
                              const int32_t* __restrict__ qlen,
                              const int32_t* __restrict__ tlen,
                              const int32_t* __restrict__ w,
                              const int32_t* __restrict__ h0,
                              const int32_t* __restrict__ sc, int64_t B,
                              int32_t Q, int32_t T, tpubwa::Gaps g,
                              int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  if (b >= B) return;
  int32_t* H = smem + threadIdx.x;
  int32_t* E = smem + Q * kLanes + threadIdx.x;
  int8_t* qs = reinterpret_cast<int8_t*>(smem + 2 * Q * kLanes) + threadIdx.x;
  const tpubwa::Scores s{sc[0], sc[1], sc[2]};
  const tpubwa::LaneResult r = tpubwa::extend_lane(
      query + b * Q, target + b * T, tpubwa::min2(qlen[b], Q),
      tpubwa::min2(tlen[b], T), w[b], h0[b], g, s, H, E, qs, kLanes);
  out[0 * B + b] = r.score;
  out[1 * B + b] = r.qle;
  out[2 * B + b] = r.tle;
  out[3 * B + b] = r.gtle;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
}

ffi::Error ExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> query,
                      ffi::Buffer<ffi::S8> target, ffi::Buffer<ffi::S32> qlen,
                      ffi::Buffer<ffi::S32> tlen, ffi::Buffer<ffi::S32> w,
                      ffi::Buffer<ffi::S32> h0, ffi::Buffer<ffi::S32> sc,
                      int32_t o_del, int32_t e_del, int32_t o_ins,
                      int32_t e_ins, int32_t zdrop,
                      ffi::ResultBuffer<ffi::S32> out) {
  const auto qd = query.dimensions();
  const auto td = target.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0]) {
    return ffi::Error::InvalidArgument("query/target must be [B, Q]/[B, T]");
  }
  const int64_t B = qd[0];
  const int32_t Q = static_cast<int32_t>(qd[1]);
  const int32_t T = static_cast<int32_t>(td[1]);
  if (B == 0) return ffi::Error::Success();
  const size_t smem = ((static_cast<size_t>(kLanes) * Q * 9) + 3) & ~3ul;
  if (smem > kMaxSmem) {
    return ffi::Error::InvalidArgument(
        "query width " + std::to_string(Q) + " exceeds shared memory");
  }
  cudaError_t err = cudaFuncSetAttribute(
      extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("cudaFuncSetAttribute: ") +
                                cudaGetErrorString(err));
  }
  const tpubwa::Gaps g{o_del, e_del, o_ins, e_ins, zdrop};
  const unsigned blocks = static_cast<unsigned>((B + kLanes - 1) / kLanes);
  extend_kernel<<<blocks, kLanes, smem, stream>>>(
      query.typed_data(), target.typed_data(), qlen.typed_data(),
      tlen.typed_data(), w.typed_data(), h0.typed_data(), sc.typed_data(), B,
      Q, T, g, out->typed_data());
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("extend_kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TpubwaExtend, ExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // query
                                  .Arg<ffi::Buffer<ffi::S8>>()   // target
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tlen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // w
                                  .Arg<ffi::Buffer<ffi::S32>>()  // h0
                                  .Arg<ffi::Buffer<ffi::S32>>()  // scores
                                  .Attr<int32_t>("o_del")
                                  .Attr<int32_t>("e_del")
                                  .Attr<int32_t>("o_ins")
                                  .Attr<int32_t>("e_ins")
                                  .Attr<int32_t>("zdrop")
                                  .Ret<ffi::Buffer<ffi::S32>>());  // [6, B]
