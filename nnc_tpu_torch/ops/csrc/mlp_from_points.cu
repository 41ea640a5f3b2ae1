// K-B3: positional encoding + the NeRF MLP from raw points, float32.
//
// Replaces the Pallas kernel _kernel_pts / _fused_call_pts
// (nnc_tpu/ops/mlp_pallas.py:238, :280), reached through
// fused_nerf_mlp_from_points (mlp_pallas.py:384): deterministic renders of
// scenes with raw_noise_std > 0 (LLFF) take it (renderer.py:86-95).
//
// Bound on the H100: operations. Every point costs ~1.2 MFLOP (12 layers,
// ~0.6M weights) against 24 bytes of input and 16 of output. The products
// run on the tensor cores as three TF32 products each (nerf_mlp_mma.cuh), so
// the peak that bounds them is 495 / 3 = 165 TFLOP/s float32-equivalent
// (H100 SXM data sheet, dense TF32, at a 700 W power limit).
//
// Design: the persistent kernel of mlp_from_points.cuh over tiles of 64
// points and the chain of nerf_mlp_mma.cuh.
#include "mlp_from_points.cuh"

extern "C" int nnc_params_size() { return nerf::kParamsSize; }
extern "C" int nnc_mma_params_size() { return nerf::mma::kMmaParamsSize; }

#ifdef NNC_MMA_PROFILE
// The clock sums of the launches so far (nerf_mlp_mma.cuh, NNC_PROF).
extern "C" int nnc_mma_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// params: the weights as pack_weights_mma lays them out.
extern "C" int nnc_mlp_from_points(const float* params, const float* pts,
                                   const float* dirs, float* out, int n,
                                   void* stream) {
  return nerf::launch_mlp_from_points<nerf::mma::Chain>(params, pts, dirs,
                                                        out, n, stream);
}
