// K-B2: fused deterministic render pass, float32.
//
// Replaces the Pallas kernel _make_kernel / _fused_render_et_call
// (nnc_tpu/ops/render_pallas.py:88, :169), reached through fused_render_pass
// (render_pallas.py:262): every deterministic blender render, coarse and
// fine pass (renderer.py:124-146).
//
// Bound on the H100: operations, ~1.2 MFLOP per sample point against ~8
// bytes of per-sample input (z, dist) and 4 of output (weight). The products
// run on the tensor cores as three TF32 products each (nerf_mlp_mma.cuh):
// 495 / 3 = 165 TFLOP/s float32-equivalent (H100 SXM data sheet, 700 W).
//
// Design: the kernel of render_pass.cuh over tiles of 2 rays x 32 samples
// (64 points, the MLP tile of nerf_mlp_mma.cuh). Occupancy mode's compacted
// rows (at most 32 slots a ray, rays ordered by their filled count) take
// the packed render pass of the same file (nnc_render_pass_packed), whose
// tiles hold filled slots only: the same bound on the points the rays need,
// of which render_pass_kernel's tiles computed 4.6x at a frame's shape.
#include "render_pass.cuh"

// params: the weights as pack_weights_mma lays them out.
extern "C" int nnc_render_pass(const float* params, const float* rays_o,
                               const float* rays_d, const float* viewdirs,
                               const float* z, const float* dists,
                               const int* live, float term_csd, float* maps,
                               float* weights, int R, int S, void* stream) {
  return nerf::launch_render_pass<nerf::mma::Chain>(
      params, rays_o, rays_d, viewdirs, z, dists, live, term_csd, maps,
      weights, R, S, stream);
}

// bounds: (S + 1,) int32, bounds[k] the rays with more than k filled slots
// (rays ordered by non-increasing count); stats: 2 int64 (filled slots,
// points computed) or null; S <= 32.
extern "C" int nnc_render_pass_packed(const float* params, const float* rays_o,
                                      const float* rays_d,
                                      const float* viewdirs, const float* z,
                                      const float* dists, const int* live,
                                      const int* bounds, float* maps,
                                      long long* stats, int R, int S,
                                      void* stream) {
  return nerf::launch_render_packed<nerf::mma::Chain>(
      params, rays_o, rays_d, viewdirs, z, dists, live, bounds, maps, stats,
      R, S, stream);
}
