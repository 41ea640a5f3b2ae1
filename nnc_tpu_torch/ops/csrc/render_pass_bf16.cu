// K-B2 in bf16: fused deterministic render pass, the MLP's operands rounded
// to bf16, its sums and logits and the whole compositing float32.
//
// Replaces the Pallas kernel _make_kernel / _fused_render_et_call
// (nnc_tpu/ops/render_pallas.py:88, :169) as it runs when
// config.compute_dtype is bfloat16 (render_pallas.py:292-295).
//
// Bound on the H100: operations, ~1.2 MFLOP per sample point against ~8
// bytes of per-sample input and 4 of output, at the tensor cores' dense bf16
// peak of 989 TFLOP/s (H100 SXM data sheet, 700 W), counted on the points
// whose ray is still alive.
//
// Design: render_pass.cuh's render_queue_kernel: early termination per ray,
// one persistent CTA per SM whose MLP tile of NNC_BF16_MT / 2 slots x 32
// samples (4 slots: 128 points, the tile of nerf_mlp_bf16.cuh) each carry
// one ray's next sample block and refill from a ray queue. It replaced
// render_pass_kernel on tiles of 4 rays, which ran a block while any of
// the four rays was alive: 568,448 points computed for 398,660 needed on
// chip_smoke.py phase 14's rays (NVIDIA H100 80GB HBM3, 700 W).
#include "render_pass.cuh"
#include "nerf_mlp_bf16.cuh"

extern "C" int nnc_bf16_params_size() { return nerf::bf16::kParamsSize; }
// points of the chain's tile: K-B2 bf16 takes them as tile / 32 rays x 32
// samples
extern "C" int nnc_bf16_tile_points() { return 16 * NNC_BF16_MT; }

// params: the weights as pack_weights_bf16 lays them out; queue: one int,
// zero, which the kernel counts the rays it hands out on.
extern "C" int nnc_render_pass_bf16(const float* params, const float* rays_o,
                                    const float* rays_d,
                                    const float* viewdirs, const float* z,
                                    const float* dists, const int* live,
                                    float term_csd, float* maps,
                                    float* weights, int* queue, int R, int S,
                                    void* stream) {
  return nerf::launch_render_queue<nerf::bf16::Chain<NNC_BF16_MT>>(
      params, rays_o, rays_d, viewdirs, z, dists, live, term_csd, maps,
      weights, queue, R, S, stream);
}
