// The flagship NeRF MLP's dimensions (D=8, W=256, skip at layer 4, view
// head; posenc 10/4 frequencies), the tile and CTA sizes of the tensor-core
// chains, and the plain float32 weight buffer's layout. They serve every
// kernel: the chains nerf_mlp_mma.cuh and nerf_mlp_bf16.cuh, K-B1's
// mlp_train.cuh, and the host's packing. No kernel runs a wide product on
// the SIMT cores any more: K-B6 (mlp_tp_pair.cu), the last, moved onto the
// tensor cores, and the dense layer it ran left this file.
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

}  // namespace nerf
