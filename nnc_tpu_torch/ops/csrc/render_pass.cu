// K-B2: fused deterministic render pass, float32. In-kernel points
// pts = o + d * z, positional encoding, the NeRF MLP and alpha compositing
// with a running optical depth, with early ray termination and skipping of
// culled rays and of sample blocks whose dists are all zero.
//
// Replaces the Pallas kernel _make_kernel / _fused_render_et_call
// (nnc_tpu/ops/render_pallas.py:88, :169), reached through fused_render_pass
// (render_pallas.py:262): every deterministic blender render, coarse and
// fine pass (renderer.py:124-146).
//
// Bound on the H100: float32 FMA throughput, ~1.2 MFLOP per sample point
// against ~8 bytes of per-sample input (z, dist) and 4 of output (weight);
// the SIMT float32 peak is 67 TFLOP/s (H100 SXM data sheet, 700 W).
//
// Design: one CTA of 256 threads owns a tile of kRT = 2 rays and walks its
// sample blocks of kSB = 32 in order (64 points per block, the MLP tile of
// nerf_mlp.cuh). This loop replaces the Pallas grid's sequential sample-block
// axis and its VMEM scratch: the running optical depth and the rgb/acc/depth
// sums live in shared memory across blocks. A block is skipped, uniformly
// across the CTA, once every ray of the tile has optical depth >= term_csd
// (early termination; that block and all later ones are skipped) or when all
// its dists are 0; a tile whose rays are all culled (live == 0) writes zeros.
// Transmittance is T = exp(-(csd_in + exclusive cumsum(sigma * dist))), the
// exclusive sum taken as a shifted inclusive warp scan, never as
// inclusive - x: at the 1e10 far-sentinel sample that difference cancels
// catastrophically (render_pallas.py:68-71). A ragged last sample block is
// masked. Outputs: maps (R, 5) [rgb, acc, depth] and, when asked, the
// per-sample weights (R, S).
#include "nerf_mlp.cuh"

namespace {

constexpr int kRT = 2;
constexpr int kSB = 32;
static_assert(kRT * kSB == nerf::kM, "a sample block is one MLP tile");
static_assert(kSB == 32, "one warp composites one ray's block");
constexpr unsigned kFull = 0xffffffffu;

struct RenderSmem {
  nerf::MlpSmem mlp;
  float xs[nerf::kM * 3];
  float ds[nerf::kM * 3];
  float zb[nerf::kM];
  float db[nerf::kM];
  float ray[kRT][9];   // o, d, viewdir
  float csd[kRT];      // optical depth before the current block
  float maps[kRT][5];  // rgb, acc, depth
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(nerf::kThreads, 1)
render_pass_kernel(const float* __restrict__ P,
                   const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d,
                   const float* __restrict__ viewdirs,
                   const float* __restrict__ z,
                   const float* __restrict__ dists,
                   const int* __restrict__ live, float term_csd,
                   float* __restrict__ maps, float* __restrict__ weights,
                   int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RenderSmem& s = *reinterpret_cast<RenderSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * kRT;
  const int n_rays = min(kRT, R - ray0);
  const int nblk = (S + kSB - 1) / kSB;

  const int tile_live =
      __syncthreads_or(tid < n_rays && live[ray0 + tid] != 0);
  if (!tile_live) {
    for (int i = tid; i < n_rays * 5; i += nerf::kThreads)
      maps[static_cast<long long>(ray0) * 5 + i] = 0.f;
    if (weights)
      for (int i = tid; i < n_rays * S; i += nerf::kThreads)
        weights[static_cast<long long>(ray0) * S + i] = 0.f;
    return;
  }
  if (tid < kRT) {
    const bool valid = tid < n_rays;
    const long long r = ray0 + tid;
    for (int c = 0; c < 3; ++c) {
      s.ray[tid][c] = valid ? rays_o[r * 3 + c] : 0.f;
      s.ray[tid][3 + c] = valid ? rays_d[r * 3 + c] : 0.f;
      s.ray[tid][6 + c] = valid ? viewdirs[r * 3 + c] : 0.f;
    }
    s.csd[tid] = 0.f;
    for (int c = 0; c < 5; ++c) s.maps[tid][c] = 0.f;
  }
  __syncthreads();

  for (int blk = 0; blk < nblk; ++blk) {
    float min_csd = INFINITY;
    for (int r = 0; r < n_rays; ++r) min_csd = fminf(min_csd, s.csd[r]);
    const bool alive = min_csd < term_csd;

    // stage this block's samples: point m = ray (m / kSB), sample (m % kSB)
    int any_dist = 0;
    if (tid < nerf::kM) {
      const int r = tid / kSB;
      const int si = blk * kSB + tid % kSB;
      const bool valid = r < n_rays && si < S;
      const long long idx = static_cast<long long>(ray0 + r) * S + si;
      const float zz = valid ? z[idx] : 0.f;
      const float dd = valid ? dists[idx] : 0.f;
      s.zb[tid] = zz;
      s.db[tid] = dd;
      for (int c = 0; c < 3; ++c) {
        // o + d * z rounded as two operations, like the plain version
        s.xs[tid * 3 + c] =
            valid ? __fadd_rn(s.ray[r][c], __fmul_rn(s.ray[r][3 + c], zz)) : 0.f;
        s.ds[tid * 3 + c] = valid ? s.ray[r][6 + c] : 0.f;
      }
      any_dist = dd > 0.f;
    }
    const int work = __syncthreads_or(alive && any_dist);
    if (!work) {
      // contributes nothing: early-terminated (this and all later blocks)
      // or all dists zero (this block only)
      if (weights) {
        const int s_end = alive ? min(S, (blk + 1) * kSB) : S;
        const int width = s_end - blk * kSB;
        for (int i = tid; i < n_rays * width; i += nerf::kThreads) {
          const long long r = ray0 + i / width;
          weights[r * S + blk * kSB + i % width] = 0.f;
        }
      }
      if (!alive) break;
      continue;
    }
    nerf::embed_tile(s.mlp.emb, s.xs, s.ds);
    __syncthreads();
    nerf::mlp_tile(s.mlp, P);

    // composite: warp r takes ray r, lane = sample within the block
    if (tid < kRT * 32) {
      const int r = tid >> 5;
      const int lane = tid & 31;
      const int m = r * kSB + lane;
      const float* raw = s.mlp.raw + m * 4;
      const float sd = fmaxf(raw[3], 0.f) * s.db[m];
      float incl = sd;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float total = __shfl_sync(kFull, incl, 31);
      const float csd_in = s.csd[r];
      const float trans = expf(-(csd_in + excl));
      const float alpha = 1.f - expf(-sd);
      const float w = alpha * trans;
      float v[5];
      for (int c = 0; c < 3; ++c) v[c] = w * (1.f / (1.f + expf(-raw[c])));
      v[3] = w;
      v[4] = w * s.zb[m];
      for (int c = 0; c < 5; ++c) v[c] = warp_sum(v[c]);
      const int si = blk * kSB + lane;
      if (weights && r < n_rays && si < S)
        weights[static_cast<long long>(ray0 + r) * S + si] = w;
      if (lane == 0) {
        for (int c = 0; c < 5; ++c) s.maps[r][c] += v[c];
        s.csd[r] = csd_in + total;
      }
    }
    __syncthreads();
  }
  if (tid < n_rays * 5)
    maps[static_cast<long long>(ray0) * 5 + tid] = s.maps[tid / 5][tid % 5];
}

}  // namespace

// rays_o, rays_d, viewdirs: (R, 3); z, dists: (R, S) (dists already scaled by
// |rays_d|); live: (R,) int32; maps: (R, 5); weights: (R, S) or null.
extern "C" int nnc_render_pass(const float* params, const float* rays_o,
                               const float* rays_d, const float* viewdirs,
                               const float* z, const float* dists,
                               const int* live, float term_csd, float* maps,
                               float* weights, int R, int S, void* stream) {
  const int smem = static_cast<int>(sizeof(RenderSmem));
  cudaError_t err = cudaFuncSetAttribute(
      render_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && S > 0) {
    const int grid = (R + kRT - 1) / kRT;
    render_pass_kernel<<<grid, nerf::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        params, rays_o, rays_d, viewdirs, z, dists, live, term_csd, maps,
        weights, R, S);
  }
  return static_cast<int>(cudaGetLastError());
}
