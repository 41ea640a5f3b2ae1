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
// Design: persistent CTAs of 256 threads, one per SM, each walking tiles of
// 64 points (tile = blockIdx.x, + gridDim.x, ...). The embedding and the
// activations stay in shared memory, the layer's accumulators in registers,
// and the weights stream through a ring of shared-memory slabs that keeps
// running from one tile into the next (nerf_mlp_mma.cuh); nothing but the 64
// points' coordinates in and raw logits out touches device memory. The TPU
// kernel's 128-lane padding and packed (N, 8) input are not carried over:
// the input is points (N, 3) and directions (N, 3), the output (N, 4).
#include "nerf_mlp_mma.cuh"

namespace {

namespace mma = nerf::mma;

struct PointsSmem {
  mma::MlpSmem mlp;
  float xs[nerf::kM * 3];
  float ds[nerf::kM * 3];
};

__global__ void __launch_bounds__(nerf::kThreads, 1)
mlp_from_points_kernel(const float* __restrict__ P,
                       const float* __restrict__ pts,
                       const float* __restrict__ dirs,
                       float* __restrict__ out, int n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PointsSmem& s = *reinterpret_cast<PointsSmem*>(smem_raw);
  const int tid = threadIdx.x;
  mma::prof_begin();
  mma::Pipe pipe;
  pipe.start(P, s.mlp.ring);
  mma::zero_embedding_pad(s.mlp.emb);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * nerf::kM;
    if (tid < nerf::kM * 3) {
      const bool valid = base + tid / 3 < n;
      s.xs[tid] = valid ? pts[base * 3 + tid] : 0.f;
      s.ds[tid] = valid ? dirs[base * 3 + tid] : 0.f;
    }
    __syncthreads();
    NNC_PROF(0);
    mma::embed_tile(s.mlp.emb, s.xs, s.ds);
    mma::mlp_tile(s.mlp, pipe, P);
    static_assert(nerf::kM * 4 == nerf::kThreads, "one output per thread");
    if (base + tid / 4 < n) out[base * 4 + tid] = s.mlp.raw[tid];
    NNC_PROF(8);
  }
  pipe.drain();
  mma::prof_end();
}

}  // namespace

extern "C" int nnc_params_size() { return nerf::kParamsSize; }
extern "C" int nnc_mma_params_size() { return nerf::mma::kMmaParamsSize; }

#ifdef NNC_MMA_PROFILE
// Reads the clock sums of the launches so far into out[kProfSlots] and
// zeroes them (nerf_mlp_mma.cuh, NNC_PROF).
extern "C" int nnc_mma_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(
      out, nerf::mma::prof_total, sizeof(nerf::mma::prof_total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[nerf::mma::kProfSlots] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(nerf::mma::prof_total, zero, sizeof(zero)));
}
#endif

// pts, dirs: (n, 3); out: (n, 4) [rgb logits, sigma]; params: the weights as
// pack_weights_mma lays them out, 16-byte aligned.
extern "C" int nnc_mlp_from_points(const float* params, const float* pts,
                                   const float* dirs, float* out, int n,
                                   void* stream) {
  const int smem = static_cast<int>(sizeof(PointsSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_from_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + nerf::kM - 1) / nerf::kM;
    const int grid = tiles < sms ? tiles : sms;
    mlp_from_points_kernel<<<grid, nerf::kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        params, pts, dirs, out, n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
