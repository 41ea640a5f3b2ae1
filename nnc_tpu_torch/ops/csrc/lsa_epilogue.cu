// K-B7: the LSA epilogue of a layer that runs as one float32 GEMM.
//
// mip-NeRF 360's MLPs (render/mipnerf360.py) are 1,024 and 256 wide. One
// 1024 x 1024 float32 layer is 4 MB, far past an SM's 228 KB of shared
// memory, so K-B1's design (every layer's slabs resident in one kernel) does
// not hold them. Each layer runs as one GEMM, acc = x @ W^T (cuBLAS, TF32
// off), and this kernel applies what LSA puts around it:
//
//   forward   y = act(acc * s + b)         s: the per-output-channel scales
//   backward  g = dy * [acc * s + b > 0]   (ReLU layers; dy otherwise)
//             dacc = g * s                 the product's cotangent, for dx
//             ds = sum_rows g * acc        the scales' gradient
//             db = sum_rows g              the biases' gradient
//
// The scale gradient is a column reduction of g * acc: no (out, in) product
// the size of dW is formed. The column sums are deterministic: each CTA sums
// its chunk of rows in a fixed order into a (chunks, 2, c) workspace, and a
// second kernel sums the chunks in order. dacc may be acc itself: each
// element is read before the same thread writes it. Nothing reads back to
// the host, so a CUDA graph captures both launches.
//
// Bound on the H100: bytes. The forward reads acc and writes y (8 bytes an
// element), the backward reads dy and acc and writes dacc (12; 8 where no
// dacc is wanted, the first layer's), each once, at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;

template <bool RELU>
__device__ __forceinline__ float act(float z) {
  return RELU ? fmaxf(z, 0.f) : z;
}

// y = act(acc * s + b), four columns a thread (c % 4 == 0).
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
    lsa_epilogue_fwd_kernel_v4(const float4* __restrict__ acc,
                               const float* __restrict__ s,
                               const float* __restrict__ b,
                               float4* __restrict__ y, long long total4,
                               int c) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < total4; e += (long long)gridDim.x * kThreads) {
    const int col = static_cast<int>((e * 4) % c);
    const float4 a = acc[e];
    const float4 sc = *reinterpret_cast<const float4*>(s + col);
    const float4 bi = *reinterpret_cast<const float4*>(b + col);
    y[e] = make_float4(act<RELU>(fmaf(a.x, sc.x, bi.x)),
                       act<RELU>(fmaf(a.y, sc.y, bi.y)),
                       act<RELU>(fmaf(a.z, sc.z, bi.z)),
                       act<RELU>(fmaf(a.w, sc.w, bi.w)));
  }
}

// The same, one element a thread (narrow heads: c = 1, 3).
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
    lsa_epilogue_fwd_kernel(const float* __restrict__ acc,
                            const float* __restrict__ s,
                            const float* __restrict__ b,
                            float* __restrict__ y, long long total, int c) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const int col = static_cast<int>(e % c);
    y[e] = act<RELU>(fmaf(acc[e], s[col], b[col]));
  }
}

// One CTA: VEC columns a lane (VEC = 4: 128 columns a CTA; 1: 32), the rows
// [chunk * rows, (chunk + 1) * rows), warp w taking rows w, w + 8, ... of
// it. Writes dacc (unless null) and the chunk's column sums of g * acc and
// g to part[chunk][0][:] and part[chunk][1][:].
template <bool RELU, int VEC>
__global__ void __launch_bounds__(kThreads)
    lsa_epilogue_bwd_kernel(const float* __restrict__ dy, const float* acc,
                            const float* __restrict__ s,
                            const float* __restrict__ b, float* dacc,
                            float* __restrict__ part, long long n, int c,
                            long long rows) {
  __shared__ float sh_s[kWarps][32 * VEC];
  __shared__ float sh_b[kWarps][32 * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (blockIdx.x * 32 + lane) * VEC;
  const long long r0 = blockIdx.y * rows;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  float gs[VEC], gb[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) gs[k] = gb[k] = 0.f;
  if (col < c) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sc[k] = s[col + k];
      bi[k] = b[col + k];
    }
    for (long long r = r0 + warp; r < r1; r += kWarps) {
      const long long at = r * c + col;
      float g[VEC], a[VEC];
      if (VEC == 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(dy + at);
        const float4 a4 = *reinterpret_cast<const float4*>(acc + at);
        g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
        g[0] = dy[at];
        a[0] = acc[at];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (RELU && !(fmaf(a[k], sc[k], bi[k]) > 0.f)) g[k] = 0.f;
        gs[k] = fmaf(g[k], a[k], gs[k]);
        gb[k] += g[k];
        g[k] *= sc[k];
      }
      if (dacc != nullptr) {
        if (VEC == 4)
          *reinterpret_cast<float4*>(dacc + at) =
              make_float4(g[0], g[1], g[2], g[3]);
        else
          dacc[at] = g[0];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh_s[warp][lane * VEC + k] = gs[k];
    sh_b[warp][lane * VEC + k] = gb[k];
  }
  __syncthreads();
  // the warps' sums in warp order, one column a thread
  for (int j = threadIdx.x; j < 32 * VEC; j += kThreads) {
    const int cj = blockIdx.x * 32 * VEC + j;
    if (cj >= c) continue;
    float ts = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += sh_s[w][j];
      tb += sh_b[w][j];
    }
    part[(blockIdx.y * 2 + 0) * (long long)c + cj] = ts;
    part[(blockIdx.y * 2 + 1) * (long long)c + cj] = tb;
  }
}

// ds[j], db[j]: the chunks' sums in chunk order.
__global__ void __launch_bounds__(kThreads)
    lsa_epilogue_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ ds, float* __restrict__ db,
                            int chunks, int c) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= 2 * c) return;
  const int which = j / c, col = j % c;
  float t = 0.f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k)
    t += part[(k * 2LL + which) * c + col];
  (which ? db : ds)[col] = t;
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = 132LL * 16;
  return static_cast<int>(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

}  // namespace

// acc, y: (n, c); s, b: (c,); contiguous float32.
extern "C" int nnc_lsa_epilogue_fwd(const float* acc, const float* s,
                                    const float* b, float* y, long long n,
                                    int c, int relu, void* stream) {
  if (n < 0 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = n * c;
  const bool vec = c % 4 == 0 && aligned16(acc) && aligned16(y) &&
                   aligned16(s) && aligned16(b);
  if (vec) {
    auto kern = relu ? lsa_epilogue_fwd_kernel_v4<true>
                     : lsa_epilogue_fwd_kernel_v4<false>;
    kern<<<grid_for(total / 4), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(acc), s, b,
        reinterpret_cast<float4*>(y), total / 4, c);
  } else {
    auto kern = relu ? lsa_epilogue_fwd_kernel<true>
                     : lsa_epilogue_fwd_kernel<false>;
    kern<<<grid_for(total), kThreads, 0, st>>>(acc, s, b, y, total, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, acc, dacc: (n, c) (dacc may be null: not written, or acc: written
// over it); s, b, ds, db:
// (c,); part: (chunks, 2, c) workspace; rows: a chunk's rows, chunks * rows
// >= n; contiguous float32.
extern "C" int nnc_lsa_epilogue_bwd(const float* dy, const float* acc,
                                    const float* s, const float* b,
                                    float* dacc, float* part, float* ds,
                                    float* db, long long n, int c, int relu,
                                    int chunks, long long rows,
                                    void* stream) {
  if (n < 1 || c < 1 || chunks < 1 || rows < 1 || chunks * rows < n ||
      chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && aligned16(dy) && aligned16(acc) &&
                   (dacc == nullptr || aligned16(dacc));
  const int per = vec ? 128 : 32;
  dim3 grid((c + per - 1) / per, chunks);
  if (vec) {
    auto kern = relu ? lsa_epilogue_bwd_kernel<true, 4>
                     : lsa_epilogue_bwd_kernel<false, 4>;
    kern<<<grid, kThreads, 0, st>>>(dy, acc, s, b, dacc, part, n, c, rows);
  } else {
    auto kern = relu ? lsa_epilogue_bwd_kernel<true, 1>
                     : lsa_epilogue_bwd_kernel<false, 1>;
    kern<<<grid, kThreads, 0, st>>>(dy, acc, s, b, dacc, part, n, c, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lsa_epilogue_sum_kernel<<<(2 * c + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(part, ds, db, chunks, c);
  return static_cast<int>(cudaGetLastError());
}
