// K-B3 in bf16: positional encoding + the NeRF MLP from raw points, operands
// rounded to bf16, sums and logits float32.
//
// Replaces the Pallas kernel _kernel_pts / _fused_call_pts
// (nnc_tpu/ops/mlp_pallas.py:238, :280) as it runs when
// config.compute_dtype is bfloat16 (mlp_pallas.py:398: weights packed in
// bf16, _mlp_body on a bf16 embedding).
//
// Bound on the H100: operations, ~1.2 MFLOP a point against 24 bytes of
// input and 16 of output, at the tensor cores' dense bf16 peak of 989
// TFLOP/s (H100 SXM data sheet, 700 W).
//
// Design: the persistent kernel of mlp_from_points.cuh over tiles of
// 16 NNC_BF16_MT points (128) and the chain of nerf_mlp_bf16.cuh.
#include "mlp_from_points.cuh"
#include "nerf_mlp_bf16.cuh"

extern "C" int nnc_bf16_params_size() { return nerf::bf16::kParamsSize; }
// points of a tile: K-B2 bf16 takes them as tile / 32 rays x 32 samples
extern "C" int nnc_bf16_tile_points() { return 16 * NNC_BF16_MT; }

#ifdef NNC_MMA_PROFILE
extern "C" int nnc_mma_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// params: the weights as pack_weights_bf16 lays them out.
extern "C" int nnc_mlp_from_points_bf16(const float* params,
                                        const float* pts, const float* dirs,
                                        float* out, int n, void* stream) {
  return nerf::launch_mlp_from_points<nerf::bf16::Chain<NNC_BF16_MT>>(
      params, pts, dirs, out, n, stream);
}
