// K-B6: one shard's column + row pair of the tensor-parallel NeRF MLP,
// out = act(x @ Wa + ba) @ Wb, float32.
//
// Replaces the Pallas kernel _pair_kernel / fused_pair
// (nnc_tpu/ops/mlp_tp_pallas.py:64, :82). Wa (K, S) is a column shard of an
// even layer (w0, w2, w4, w6, wf), Wb (S, O2) the matching row shard of the
// odd layer behind it (w1, w3, w5b, w7, wva); S = 256 / M for M shards. The
// hidden tile act(x @ Wa + ba) never leaves the CTA: that is the point of the
// pair. The result is a partial sum; the sum over the shards, the odd layer's
// bias and its activation happen outside (nnc_tpu_torch/ops/mlp_tp_fused.py).
//
// Bound on the H100 (float32 outside the tensor cores, 67 TFLOP/s; device
// memory 3.35 TB/s): 2 * S * (K + O2) operations per point against
// 4 * (K + O2) bytes, so S / 2 operations per byte against the card's 20:
// bound by operations at S >= 64 (M <= 4), by bytes at S = 32 (M = 8).
//
// Design: nerf_mlp.cuh's CTA (256 threads, a tile of 64 points, activations
// channel-major in shared memory with row stride kLd = 68). The x tile
// (K x 64) and the hidden tile (S x 64) are the only shared buffers, at most
// (256 + 256) x 68 floats = 139 KB. First product: dense<S>, every thread
// owns 8 points x S / 32 channels, so all 256 threads work at every S and
// only the accumulators per thread shrink with it. Second product: 8 points
// x O2 / 32 channels per thread, accumulated in registers over the S hidden
// channels and stored straight to out, a warp writing 32 consecutive floats
// of one row. S, O2 and the activation are template parameters; K (63 or
// 256) is a run-time loop count. x rows are read as scalars (K = 63 is odd);
// the transposed store into shared memory costs a 4-way bank conflict,
// small against the products. Every sum runs over k in increasing order in
// one thread: reruns are bit-equal. The ragged last tile is masked here; N
// is not padded on the host.
#include "nerf_mlp.cuh"

namespace {

using nerf::kLd;
using nerf::kM;
using nerf::kThreads;

template <int S, int O2, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tp_pair_kernel(const float* __restrict__ x, int K,
                   const float* __restrict__ wa, const float* __restrict__ ba,
                   const float* __restrict__ wb, float* __restrict__ out,
                   int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);   // K x kLd
  float* h = xs + K * kLd;                          // S x kLd
  const long long base = static_cast<long long>(blockIdx.x) * kM;
  const int rows = n - base < kM ? static_cast<int>(n - base) : kM;

  for (int i = threadIdx.x; i < kM * K; i += kThreads) {
    const int m = i / K;
    const int c = i - m * K;
    xs[c * kLd + m] = m < rows ? __ldg(x + base * K + i) : 0.f;
  }
  __syncthreads();
  nerf::dense<S, RELU>(h, xs, K, wa, ba);
  __syncthreads();

  constexpr int NC = O2 / 32;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  nerf::accumulate<O2, NC>(acc, h, S, wb, r0, lane);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r0 + r < rows) {
      float* o = out + (base + r0 + r) * O2 + lane;
#pragma unroll
      for (int j = 0; j < NC; ++j) o[32 * j] = acc[r][j];
    }
  }
}

template <int S, int O2, bool RELU>
int launch(const float* x, int k, const float* wa, const float* ba,
           const float* wb, float* out, int n, cudaStream_t stream) {
  const int smem = (k + S) * kLd * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tp_pair_kernel<S, O2, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + kM - 1) / kM;
    mlp_tp_pair_kernel<S, O2, RELU><<<grid, kThreads, smem, stream>>>(
        x, k, wa, ba, wb, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int O2, bool RELU>
int launch_s(int s, const float* x, int k, const float* wa, const float* ba,
             const float* wb, float* out, int n, cudaStream_t stream) {
  switch (s) {
    case 256: return launch<256, O2, RELU>(x, k, wa, ba, wb, out, n, stream);
    case 128: return launch<128, O2, RELU>(x, k, wa, ba, wb, out, n, stream);
    case 64: return launch<64, O2, RELU>(x, k, wa, ba, wb, out, n, stream);
    case 32: return launch<32, O2, RELU>(x, k, wa, ba, wb, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, k); wa: (k, s); ba: (s,); wb: (s, o2); out: (n, o2), all contiguous
// float32. Compiled shapes: 1 <= k <= 256; s in {32, 64, 128, 256};
// (o2, relu_mid) = (256, 1) or (128, 0). Any other returns
// cudaErrorInvalidValue.
extern "C" int nnc_mlp_tp_pair(const float* x, const float* wa,
                               const float* ba, const float* wb, float* out,
                               int n, int k, int s, int o2, int relu_mid,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > nerf::kW) return static_cast<int>(cudaErrorInvalidValue);
  if (o2 == 256 && relu_mid)
    return launch_s<256, true>(s, x, k, wa, ba, wb, out, n, st);
  if (o2 == 128 && !relu_mid)
    return launch_s<128, false>(s, x, k, wa, ba, wb, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
