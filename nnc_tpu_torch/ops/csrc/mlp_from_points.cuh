// The kernel of K-B3, posenc + the NeRF MLP from raw points, over a chain:
// mma::Chain (float32 as 3xTF32, nerf_mlp_mma.cuh; mlp_from_points.cu) or
// bf16::Chain<MT> (nerf_mlp_bf16.cuh; mlp_from_points_bf16.cu). Beside it
// the kernel of K-B5 float32 (mlp_embedded.cu), the same walk over tiles
// with the embedding read from device memory (Chain::load_embedded) in place
// of the points' coordinates and Chain::embed. K-B5 bf16
// (mlp_embedded_bf16.cu) launches a kernel of its own on this file's
// launch_persistent, which brings the next tile's pts in beside the products.
//
// Design: persistent CTAs of 256 threads, one per SM, each walking tiles of
// Chain::kPoints points (tile = blockIdx.x, + gridDim.x, ...). The embedding
// and the activations stay in shared memory, the layer's accumulators in
// registers, and the weights stream through a ring of shared-memory slabs
// that keeps running from one tile into the next; nothing but the points'
// coordinates (K-B5: their embeddings) in and raw logits out touches device
// memory. The TPU kernel's
// 128-lane padding and packed (N, 8) input are not carried over: the input
// is points (N, 3) and directions (N, 3), the output (N, 4).
#pragma once

#include "nerf_mlp_mma.cuh"

namespace nerf {

template <class Chain>
struct PointsSmem {
  typename Chain::Smem mlp;
  float xs[Chain::kPoints * 3];
  float ds[Chain::kPoints * 3];
};

template <class Chain>
__global__ void __launch_bounds__(kThreads, 1)
mlp_from_points_kernel(const float* __restrict__ P,
                       const float* __restrict__ pts,
                       const float* __restrict__ dirs,
                       float* __restrict__ out, int n, int tiles) {
  constexpr int kPoints = Chain::kPoints;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PointsSmem<Chain>& s = *reinterpret_cast<PointsSmem<Chain>*>(smem_raw);
  const int tid = threadIdx.x;
  mma::prof_begin();
  typename Chain::Pipe pipe;
  Chain::begin(s.mlp, pipe, P);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kPoints;
    for (int i = tid; i < kPoints * 3; i += kThreads) {
      const bool valid = base + i / 3 < n;
      s.xs[i] = valid ? pts[base * 3 + i] : 0.f;
      s.ds[i] = valid ? dirs[base * 3 + i] : 0.f;
    }
    __syncthreads();
    NNC_PROF(0);
    Chain::embed(s.mlp, s.xs, s.ds);
    Chain::mlp(s.mlp, pipe, P);
    for (int i = tid; i < kPoints * 4; i += kThreads)
      if (base + i / 4 < n) out[base * 4 + i] = s.mlp.raw[i];
    NNC_PROF(8);
  }
  pipe.drain();
  mma::prof_end();
}

// pts_emb: (n, kInPts), views_emb: (n, kInViews), the embeddings computed
// outside; the rest as mlp_from_points_kernel. A tile's load of its
// embedding writes s.emb after the previous tile's last read of it (the
// barrier that ends Chain::mlp) and before Chain::mlp's first barrier. The
// clock marks (-DNNC_MMA_PROFILE) put thread 0's own share of the load in
// slot 0 and its wait for the other threads' shares in slot 1 (Chain::mlp's
// first barrier).
template <class Chain>
__global__ void __launch_bounds__(kThreads, 1)
mlp_embedded_kernel(const float* __restrict__ P,
                    const float* __restrict__ pts_emb,
                    const float* __restrict__ views_emb,
                    float* __restrict__ out, int n, int tiles) {
  constexpr int kPoints = Chain::kPoints;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename Chain::Smem& s =
      *reinterpret_cast<typename Chain::Smem*>(smem_raw);
  const int tid = threadIdx.x;
  mma::prof_begin();
  typename Chain::Pipe pipe;
  Chain::begin(s, pipe, P);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * kPoints;
    Chain::load_embedded(s, pts_emb, views_emb, base, n);
    NNC_PROF(0);
    Chain::mlp(s, pipe, P);
    for (int i = tid; i < kPoints * 4; i += kThreads)
      if (base + i / 4 < n) out[base * 4 + i] = s.raw[i];
    NNC_PROF(8);
  }
  pipe.drain();
  mma::prof_end();
}

// One persistent CTA per SM (at most one per tile) of `kernel` with `smem`
// bytes, over the tiles of kPoints points of n; args... then n and the
// number of tiles are the kernel's arguments.
template <int kPoints, class Kernel, class... Args>
int launch_persistent(Kernel kernel, int smem, int n, void* stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + kPoints - 1) / kPoints;
    const int grid = tiles < sms ? tiles : sms;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        args..., n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// pts, dirs: (n, 3); out: (n, 4) [rgb logits, sigma]; params: the weights as
// the chain's packing lays them out, 16-byte aligned.
template <class Chain>
int launch_mlp_from_points(const float* params, const float* pts,
                           const float* dirs, float* out, int n,
                           void* stream) {
  return launch_persistent<Chain::kPoints>(
      mlp_from_points_kernel<Chain>,
      static_cast<int>(sizeof(PointsSmem<Chain>)), n, stream, params, pts,
      dirs, out);
}

// pts_emb: (n, kInPts), views_emb: (n, kInViews); the rest as above.
template <class Chain>
int launch_mlp_embedded(const float* params, const float* pts_emb,
                        const float* views_emb, float* out, int n,
                        void* stream) {
  return launch_persistent<Chain::kPoints>(
      mlp_embedded_kernel<Chain>,
      static_cast<int>(sizeof(typename Chain::Smem)), n, stream, params,
      pts_emb, views_emb, out);
}

}  // namespace nerf
