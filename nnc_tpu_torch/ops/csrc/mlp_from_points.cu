// K-B3: positional encoding + the NeRF MLP from raw points, float32.
//
// Replaces the Pallas kernel _kernel_pts / _fused_call_pts
// (nnc_tpu/ops/mlp_pallas.py:238, :280), reached through
// fused_nerf_mlp_from_points (mlp_pallas.py:384): deterministic renders of
// scenes with raw_noise_std > 0 (LLFF) take it (renderer.py:86-95).
//
// Bound on the H100: float32 FMA throughput outside the tensor cores. Every
// point costs ~1.2 MFLOP (12 layers, ~0.6M weights) against 24 bytes of input
// and 16 of output, so the kernel is compute bound; the SIMT float32 peak is
// 67 TFLOP/s (H100 SXM data sheet, at a 700 W power limit).
//
// Design: one CTA of 256 threads per tile of 64 points. The embedding and
// all activations stay in shared memory (nerf_mlp.cuh, ~162 KB); nothing but
// the 64 points' coordinates in and raw logits out touches device memory.
// Each thread keeps an 8 x 8 register tile of accumulators, so one k step
// costs two broadcast float4 loads of activations and eight coalesced weight
// loads (L1/L2 hits: all 8 warps read the same row) for 64 FMAs. The TPU
// kernel's 128-lane padding and packed (N, 8) input are not carried over:
// the input is points (N, 3) and directions (N, 3), the output (N, 4).
#include "nerf_mlp.cuh"

namespace {

struct PointsSmem {
  nerf::MlpSmem mlp;
  float xs[nerf::kM * 3];
  float ds[nerf::kM * 3];
};

__global__ void __launch_bounds__(nerf::kThreads, 1)
mlp_from_points_kernel(const float* __restrict__ P,
                       const float* __restrict__ pts,
                       const float* __restrict__ dirs,
                       float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PointsSmem& s = *reinterpret_cast<PointsSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * nerf::kM;
  if (tid < nerf::kM * 3) {
    const bool valid = base + tid / 3 < n;
    s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
    s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
  }
  __syncthreads();
  nerf::embed_tile(s.mlp.emb, s.xs, s.ds);
  __syncthreads();
  nerf::mlp_tile(s.mlp, P);
  static_assert(nerf::kM * 4 == nerf::kThreads, "one output per thread");
  if (base + tid / 4 < n) out[base * 4 + tid] = s.mlp.raw[tid];
}

}  // namespace

extern "C" int nnc_params_size() { return nerf::kParamsSize; }

// pts, dirs: (n, 3); out: (n, 4) [rgb logits, sigma]; params: packed weights.
extern "C" int nnc_mlp_from_points(const float* params, const float* pts,
                                   const float* dirs, float* out, int n,
                                   void* stream) {
  const int smem = static_cast<int>(sizeof(PointsSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_from_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + nerf::kM - 1) / nerf::kM;
    mlp_from_points_kernel<<<grid, nerf::kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        params, pts, dirs, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
