// The flagship NeRF MLP's dimensions (D=8, W=256, skip at layer 4, view
// head; posenc 10/4 frequencies), the plain float32 weight buffer's layout,
// and one dense layer of float32 FMAs on a tile of kM points for a CTA of
// kThreads threads. The dimensions and the layout serve every kernel (the
// tensor-core chains nerf_mlp_mma.cuh and nerf_mlp_bf16.cuh, K-B1's
// mlp_train.cuh); dense / accumulate serve mlp_tp_pair.cu (K-B6 float32),
// the one kernel left on the SIMT cores.
//
// Layout. Activations live in shared memory transposed, channel-major
// (act[channel * kLd + point]), so that one thread reads eight consecutive
// points of a channel as two float4 loads that its whole warp shares, and a
// warp stores 32 consecutive channels without bank conflicts (kLd = kM + 4).
// Weights stream from global memory through L1/L2, one row of W per k step,
// read by every warp of the CTA.
//
// Packed weights: one float32 buffer, layers in nerf.layer_names order
// (pts_linears.0..7, feature_linear, alpha_linear, views_linears.0,
// rgb_linear). Each layer is W in (in, out) row-major, then its bias, padded
// to a multiple of 64 floats; LSA scales are folded in by the host
// (nnc_tpu_torch/ops/mlp_fused.py pack_weights, the same layout).
#pragma once

#include <cuda_runtime.h>

namespace nerf {

constexpr int kW = 256;        // hidden width
constexpr int kInPts = 63;     // posenc(xyz, 10)
constexpr int kInViews = 27;   // posenc(viewdir, 4)
constexpr int kM = 64;         // points per tile
constexpr int kLd = kM + 4;    // row stride of the activation buffers
constexpr int kThreads = 256;
constexpr int kLayers = 12;

__host__ __device__ constexpr int layer_in(int i) {
  return i == 0 ? kInPts : i == 5 ? kInPts + kW : i == 10 ? kW + kInViews
         : i == 11 ? kW / 2 : kW;
}
__host__ __device__ constexpr int layer_out(int i) {
  return i == 9 ? 1 : i == 10 ? kW / 2 : i == 11 ? 3 : kW;
}
__host__ __device__ constexpr int layer_size(int i) {
  return (layer_in(i) * layer_out(i) + layer_out(i) + 63) / 64 * 64;
}
__host__ __device__ constexpr int layer_offset(int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += layer_size(j);
  return off;
}
constexpr int kParamsSize = layer_offset(kLayers);

// acc[r][j] += sum_k x[k][r0 + r] * w[k][lane + 32 j]
template <int NOUT, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[8][NC],
                                           const float* __restrict__ x, int K,
                                           const float* __restrict__ w,
                                           int r0, int lane) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 xa = *reinterpret_cast<const float4*>(x + k * kLd + r0);
    const float4 xb = *reinterpret_cast<const float4*>(x + k * kLd + r0 + 4);
    const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) wv[j] = __ldg(w + k * NOUT + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(xr[r], wv[j], acc[r][j]);
  }
}

// out = act(bias + x @ w) for the kM points of the tile; each of the 256
// threads owns 8 points x NOUT/32 channels.
template <int NOUT, bool RELU>
__device__ __forceinline__ void dense(float* __restrict__ out,
                                      const float* __restrict__ x, int K,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b) {
  constexpr int NC = NOUT / 32;
  static_assert(NOUT % 32 == 0 && kM == 64 && kThreads == 256, "tiling");
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float bj = __ldg(b + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][j] = bj;
  }
  accumulate<NOUT, NC>(acc, x, K, w, r0, lane);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = RELU ? fmaxf(acc[r][j], 0.f) : acc[r][j];
    float4* o = reinterpret_cast<float4*>(out + (lane + 32 * j) * kLd + r0);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace nerf
