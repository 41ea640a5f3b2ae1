// K-B5: the NeRF MLP on embeddings computed outside the kernel, float32.
//
// Replaces the Pallas kernel _kernel / _fused_call
// (nnc_tpu/ops/mlp_pallas.py:191, :248), reached through fused_nerf_mlp
// (mlp_pallas.py:416), the drop-in for nerf.apply_mlp on the flagship
// architecture: the renderer's route for a fused MLP whose positional
// encoding is made outside (renderer.py:96-106).
//
// Bound on the H100: float32 FMA throughput outside the tensor cores, as for
// K-B3 (~1.2 MFLOP per point against 360 bytes of input and 16 of output; the
// SIMT float32 peak is 67 TFLOP/s, H100 SXM data sheet, at a 700 W power
// limit).
//
// Design: K-B3's CTA (256 threads, 64 points, activations in shared memory,
// nerf_mlp.cuh) with the embedding loaded instead of computed. The TPU
// kernel's (N, 128) packed input and zero-padded weight rows are not carried
// over: the inputs are pts_emb (N, 63) and views_emb (N, 27) as the caller
// has them, the weights those of K-B3. The ragged tail is masked here; N is
// not padded on the host.
#include "nerf_mlp.cuh"

namespace {

__global__ void __launch_bounds__(nerf::kThreads, 1)
mlp_embedded_kernel(const float* __restrict__ P,
                    const float* __restrict__ pts_emb,
                    const float* __restrict__ views_emb,
                    float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nerf::MlpSmem& s = *reinterpret_cast<nerf::MlpSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * nerf::kM;
  nerf::load_embedded_tile(s.emb, pts_emb, views_emb, base, n);
  __syncthreads();
  nerf::mlp_tile(s, P);
  static_assert(nerf::kM * 4 == nerf::kThreads, "one output per thread");
  if (base + tid / 4 < n) out[base * 4 + tid] = s.raw[tid];
}

}  // namespace

// pts_emb: (n, 63); views_emb: (n, 27); out: (n, 4) [rgb logits, sigma];
// params: packed weights.
extern "C" int nnc_mlp_embedded(const float* params, const float* pts_emb,
                                const float* views_emb, float* out, int n,
                                void* stream) {
  const int smem = static_cast<int>(sizeof(nerf::MlpSmem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_embedded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + nerf::kM - 1) / nerf::kM;
    mlp_embedded_kernel<<<grid, nerf::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        params, pts_emb, views_emb, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
