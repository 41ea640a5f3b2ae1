// The kernels of K-B2, the fused deterministic render pass, over a chain:
// mma::Chain (float32 as 3xTF32, nerf_mlp_mma.cuh; render_pass.cu) or
// bf16::Chain<MT> (nerf_mlp_bf16.cuh; render_pass_bf16.cu). In-kernel points
// pts = o + d * z, positional encoding, the NeRF MLP and alpha compositing
// with a running optical depth, with early ray termination and skipping of
// culled rays and of sample blocks whose dists are all zero. The
// compositing is float32 whatever the chain.
//
// render_pass_kernel (the float32 K-B2) decides early termination per tile
// of rays; render_queue_kernel (below; K-B2 bf16) per ray.
//
// Design: one CTA of 256 threads owns a tile of kRT = Chain::kPoints / 32
// rays (2 for the float32 chain's 64 points, 4 for the bf16 chain's 128) and
// walks its sample blocks of kSB = 32 in order (one MLP tile per block).
// This loop replaces the Pallas grid's sequential
// sample-block axis and its VMEM scratch: the running optical depth and the
// rgb/acc/depth sums live in shared memory across blocks. The weight ring
// keeps running across blocks, so the next block's first slabs arrive while
// kRT warps composite this one. A block is skipped, uniformly
// across the CTA, once every ray of the tile has optical depth >= term_csd
// (early termination; that block and all later ones are skipped) or when all
// its dists are 0; a tile whose rays are all culled (live == 0) writes zeros.
// Transmittance is T = exp(-(csd_in + exclusive cumsum(sigma * dist))), the
// exclusive sum taken as a shifted inclusive warp scan, never as
// inclusive - x: at the 1e10 far-sentinel sample that difference cancels
// catastrophically (render_pallas.py:68-71). A ragged last sample block is
// masked. Outputs: maps (R, 5) [rgb, acc, depth] and, when asked, the
// per-sample weights (R, S).
#pragma once

#include "nerf_mlp_mma.cuh"

namespace nerf {

constexpr int kSB = 32;   // one warp composites one ray's block
constexpr unsigned kFull = 0xffffffffu;

template <class Chain>
struct RenderSmem {
  static constexpr int kRT = Chain::kPoints / kSB;   // rays of a tile
  typename Chain::Smem mlp;
  float xs[Chain::kPoints * 3];
  float ds[Chain::kPoints * 3];
  float zb[Chain::kPoints];
  float db[Chain::kPoints];
  float ray[kRT][9];   // o, d, viewdir
  float csd[kRT];      // optical depth before the current block
  float maps[kRT][5];  // rgb, acc, depth
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <class Chain>
__global__ void __launch_bounds__(kThreads, 1)
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
  RenderSmem<Chain>& s = *reinterpret_cast<RenderSmem<Chain>*>(smem_raw);
  constexpr int kRT = RenderSmem<Chain>::kRT;
  constexpr int kPoints = Chain::kPoints;
  static_assert(kRT * kSB == kPoints && kPoints <= kThreads,
                "a sample block is one MLP tile, staged by one thread a point");
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * kRT;
  const int n_rays = min(kRT, R - ray0);
  const int nblk = (S + kSB - 1) / kSB;

  const int tile_live =
      __syncthreads_or(tid < n_rays && live[ray0 + tid] != 0);
  if (!tile_live) {
    for (int i = tid; i < n_rays * 5; i += kThreads)
      maps[static_cast<long long>(ray0) * 5 + i] = 0.f;
    if (weights)
      for (int i = tid; i < n_rays * S; i += kThreads)
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
  typename Chain::Pipe pipe;
  Chain::begin(s.mlp, pipe, P);
  __syncthreads();

  for (int blk = 0; blk < nblk; ++blk) {
    float min_csd = INFINITY;
    for (int r = 0; r < n_rays; ++r) min_csd = fminf(min_csd, s.csd[r]);
    const bool alive = min_csd < term_csd;

    // stage this block's samples: point m = ray (m / kSB), sample (m % kSB)
    int any_dist = 0;
    if (tid < kPoints) {
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
        for (int i = tid; i < n_rays * width; i += kThreads) {
          const long long r = ray0 + i / width;
          weights[r * S + blk * kSB + i % width] = 0.f;
        }
      }
      if (!alive) break;
      continue;
    }
    Chain::embed(s.mlp, s.xs, s.ds);
    Chain::mlp(s.mlp, pipe, P);

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
  pipe.drain();
  if (tid < n_rays * 5)
    maps[static_cast<long long>(ray0) * 5 + tid] = s.maps[tid / 5][tid % 5];
}

// ------------------------------------------------------------------------
// The same render pass with early termination per ray, on a persistent ray
// queue (render_queue_kernel; K-B2 bf16 takes it, render_pass_bf16.cu).
//
// One CTA per SM. Its MLP tile of Chain::kPoints points is kRT slots of kSB
// samples; a slot carries one ray's next sample block. Warp w < kRT owns
// slot w: it composites the slot's block, and then refills the slot: a ray
// that has terminated (optical depth >= term_csd before the block: its
// remaining weights are written as 0), has run out of samples, or was
// culled (live == 0: maps and weights 0) leaves the slot, which takes the
// next ray from the queue (an atomic counter over ray indices), and a
// block whose dists are all 0 is skipped (its weights written as 0) until
// the slot holds a block that does work or the queue is empty. The ray's
// state (o, d, viewdir, the block, the optical depth, the rgb / acc / depth
// sums) lives in shared memory across the MLP, in the owner's registers
// while it composites and refills. The tile runs while any slot holds a
// block; idle slots feed the MLP zero points, which nothing reads. Every
// point's MLP row depends on its own inputs alone, and a ray's blocks are
// composited in order by one warp, so a ray's result does not depend on
// the slot or the CTA that ran it: reruns are bit-equal although the
// queue's order varies. The compositing is render_pass_kernel's.
// A slot's ray.
struct SlotRay {
  int ray;       // -1: empty; R: the queue is drained
  int blk;       // the next sample block
  float csd;     // optical depth before it
  float o[3], d[3], v[3];
  float maps[5];
};

template <class Chain>
struct QueueSmem {
  static constexpr int kRT = Chain::kPoints / kSB;   // slots of a tile
  typename Chain::Smem mlp;
  float xs[Chain::kPoints * 3];
  float ds[Chain::kPoints * 3];
  float zb[Chain::kPoints];
  float db[Chain::kPoints];
  SlotRay slot[kRT];
};

template <class Chain>
__global__ void __launch_bounds__(kThreads, 1)
render_queue_kernel(const float* __restrict__ P,
                    const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ viewdirs,
                    const float* __restrict__ z,
                    const float* __restrict__ dists,
                    const int* __restrict__ live, float term_csd,
                    float* __restrict__ maps, float* __restrict__ weights,
                    int* __restrict__ queue, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QueueSmem<Chain>& s = *reinterpret_cast<QueueSmem<Chain>*>(smem_raw);
  constexpr int kRT = QueueSmem<Chain>::kRT;
  static_assert(kRT * kSB == Chain::kPoints && kRT <= kThreads / 32,
                "a slot is one warp's block");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = (S + kSB - 1) / kSB;
  const bool owner = warp < kRT;
  const int m = warp * kSB + lane;   // the slot's point of this lane

  // weights [from, S) of ray r written as 0, by the warp
  auto zero_weights = [&](int r, int from) {
    if (weights)
      for (int si = from + lane; si < S; si += 32)
        weights[static_cast<long long>(r) * S + si] = 0.f;
  };
  // Run by the owner's warp: composite the slot's block (`composite`: the
  // tile computed it), then stage the slot's next block that does work.
  // Returns whether the slot holds one. The ray's state goes through
  // registers here and lives in shared memory across the MLP.
  auto advance = [&](bool composite) -> bool {
    SlotRay sr = s.slot[warp];
    if (composite) {
      // lane = sample within the block (render_pass_kernel's compositing)
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
      const float trans = expf(-(sr.csd + excl));
      const float alpha = 1.f - expf(-sd);
      const float w = alpha * trans;
      float v[5];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = w * (1.f / (1.f + expf(-raw[c])));
      v[3] = w;
      v[4] = w * s.zb[m];
#pragma unroll
      for (int c = 0; c < 5; ++c) sr.maps[c] += warp_sum(v[c]);
      const int si = sr.blk * kSB + lane;
      if (weights && si < S)
        weights[static_cast<long long>(sr.ray) * S + si] = w;
      sr.csd += total;
      ++sr.blk;
    }
    bool work = false;
    while (sr.ray < R) {
      if (sr.ray < 0) {
        int r = 0;
        if (lane == 0) r = atomicAdd(queue, 1);
        sr.ray = __shfl_sync(kFull, r, 0);
        if (sr.ray >= R) break;
        const long long r3 = static_cast<long long>(sr.ray) * 3;
        if (live[sr.ray] == 0) {
          // culled: zeros
          if (lane < 5) maps[static_cast<long long>(sr.ray) * 5 + lane] = 0.f;
          zero_weights(sr.ray, 0);
          sr.ray = -1;
          continue;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sr.o[c] = rays_o[r3 + c];
          sr.d[c] = rays_d[r3 + c];
          sr.v[c] = viewdirs[r3 + c];
        }
        sr.blk = 0;
        sr.csd = 0.f;
#pragma unroll
        for (int c = 0; c < 5; ++c) sr.maps[c] = 0.f;
      }
      const bool alive = sr.csd < term_csd;
      if (!alive || sr.blk == nblk) {
        // early-terminated (this and every later block contribute
        // nothing) or through all its samples: the ray leaves the slot
        if (!alive) zero_weights(sr.ray, sr.blk * kSB);
        if (lane < 5)
          maps[static_cast<long long>(sr.ray) * 5 + lane] = sr.maps[lane];
        sr.ray = -1;
        continue;
      }
      const int si = sr.blk * kSB + lane;
      const bool valid = si < S;
      const long long idx = static_cast<long long>(sr.ray) * S + si;
      const float zz = valid ? z[idx] : 0.f;
      const float dd = valid ? dists[idx] : 0.f;
      if (!__any_sync(kFull, dd > 0.f)) {
        // all dists zero: this block alone contributes nothing
        if (weights && valid) weights[idx] = 0.f;
        ++sr.blk;
        continue;
      }
      s.zb[m] = zz;
      s.db[m] = dd;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // o + d * z rounded as two operations, like the plain version
        s.xs[m * 3 + c] =
            valid ? __fadd_rn(sr.o[c], __fmul_rn(sr.d[c], zz)) : 0.f;
        s.ds[m * 3 + c] = valid ? sr.v[c] : 0.f;
      }
      work = true;
      break;
    }
    if (!work) {
      // the queue is drained: the slot feeds the MLP zero points
      s.zb[m] = s.db[m] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) s.xs[m * 3 + c] = s.ds[m * 3 + c] = 0.f;
    }
    __syncwarp();
    if (lane == 0) s.slot[warp] = sr;
    __syncwarp();
    return work;
  };

  typename Chain::Pipe pipe;
  Chain::begin(s.mlp, pipe, P);
  if (owner && lane == 0) s.slot[warp].ray = -1;
  __syncwarp();
  bool work = owner && advance(false);
  while (__syncthreads_or(work)) {
    Chain::embed(s.mlp, s.xs, s.ds);
    Chain::mlp(s.mlp, pipe, P);
    // (the MLP's last barrier: every warp is done with the staged block)
    if (owner) work = advance(work);
  }
  pipe.drain();
}

// rays_o, rays_d, viewdirs: (R, 3); z, dists: (R, S) (dists already scaled by
// |rays_d|); live: (R,) int32; maps: (R, 5); weights: (R, S) or null; params:
// the weights as the chain's packing lays them out, 16-byte aligned; queue:
// one int, 0 (the kernel counts the rays it hands out there).
template <class Chain>
int launch_render_queue(const float* params, const float* rays_o,
                        const float* rays_d, const float* viewdirs,
                        const float* z, const float* dists, const int* live,
                        float term_csd, float* maps, float* weights,
                        int* queue, int R, int S, void* stream) {
  constexpr int kRT = QueueSmem<Chain>::kRT;
  const int smem = static_cast<int>(sizeof(QueueSmem<Chain>));
  cudaError_t err = cudaFuncSetAttribute(
      render_queue_kernel<Chain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && S > 0) {
    const int tiles = (R + kRT - 1) / kRT;
    render_queue_kernel<Chain><<<tiles < sms ? tiles : sms, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        params, rays_o, rays_d, viewdirs, z, dists, live, term_csd, maps,
        weights, queue, R, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// rays_o, rays_d, viewdirs: (R, 3); z, dists: (R, S) (dists already scaled by
// |rays_d|); live: (R,) int32; maps: (R, 5); weights: (R, S) or null; params:
// the weights as the chain's packing lays them out, 16-byte aligned.
template <class Chain>
int launch_render_pass(const float* params, const float* rays_o,
                       const float* rays_d, const float* viewdirs,
                       const float* z, const float* dists, const int* live,
                       float term_csd, float* maps, float* weights, int R,
                       int S, void* stream) {
  constexpr int kRT = RenderSmem<Chain>::kRT;
  const int smem = static_cast<int>(sizeof(RenderSmem<Chain>));
  cudaError_t err = cudaFuncSetAttribute(
      render_pass_kernel<Chain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && S > 0) {
    const int grid = (R + kRT - 1) / kRT;
    render_pass_kernel<Chain><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        params, rays_o, rays_d, viewdirs, z, dists, live, term_csd, maps,
        weights, R, S);
  }
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------------------
// The packed render pass (render_pass_kernel_packed; K-B2 float32 as
// occupancy mode calls it, render_pass.cu): rays of at most kSB samples
// whose MLP tiles hold filled sample slots (dists > 0) only.
//
// A compacted occupancy row has at most `budget` (<= kSB) slots, a part of
// them filled, so render_pass_kernel's tile of 2 rays x 32 samples computes
// points that no ray needs: the lanes past S, and the empty slots. Here the
// rays come in runs of equal filled count k (the caller orders them by
// non-increasing count), and a tile of run k holds floor(kPoints / k) whole
// rays, each ray's filled slots in their order, ray q of the tile at points
// q k .. q k + k - 1. The plan is a cumulative histogram of the counts:
// bounds[k] (k = 0..S) rays have more than k filled slots, so run k is the
// rays [bounds[k], bounds[k - 1]); the rays [bounds[0], R) have none (or
// are culled: live == 0) and write zeros. Every CTA derives the runs' tiles
// from bounds (one warp, S <= 32 runs), then walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... (one persistent CTA an SM), so
// that the weight ring runs on across tiles: the next tile's first slabs
// arrive while this one composites.
//
// Staging and compositing take one warp a ray, lane = the slot: a
// __ballot_sync of dists > 0 and a popcount give each filled slot its rank,
// which is its point in the tile and, in compositing, its lane. The
// compositing is render_pass_kernel's on one block from an optical depth of
// 0; lanes at or past the ray's count add exact zeros, as the lanes of empty
// slots and of slots past S do there. A ray's rows of the MLP depend on its
// own points alone, so where the filled slots are a prefix of the row (as
// occupancy's compaction leaves them) the maps are render_pass_kernel's bit
// for bit. With one block a ray there is nothing for early termination to
// skip (render_pass_kernel always runs a ray's first block). A ray whose
// filled count is not its run's (rays not in non-increasing count order)
// gets NaN maps. With `stats`, CTA 0 writes the filled slots launched and
// the points the tiles compute (kPoints a tile).
template <class Chain>
struct PackedSmem {
  static constexpr int kRays = Chain::kPoints;   // a tile's rays at count 1
  typename Chain::Smem mlp;
  float xs[Chain::kPoints * 3];
  float ds[Chain::kPoints * 3];
  float zb[Chain::kPoints];
  float db[Chain::kPoints];
  int count[kRays];        // each ray's filled count, as staged
  int run_ray0[kSB];       // run j (count S - j): its first ray,
  int run_rays[kSB];       // its rays,
  int run_tile0[kSB];      // its first tile
  int tiles;
};

template <class Chain>
__global__ void __launch_bounds__(kThreads, 1)
render_pass_kernel_packed(const float* __restrict__ P,
                          const float* __restrict__ rays_o,
                          const float* __restrict__ rays_d,
                          const float* __restrict__ viewdirs,
                          const float* __restrict__ z,
                          const float* __restrict__ dists,
                          const int* __restrict__ live,
                          const int* __restrict__ bounds,
                          float* __restrict__ maps,
                          long long* __restrict__ stats, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PackedSmem<Chain>& s = *reinterpret_cast<PackedSmem<Chain>*>(smem_raw);
  constexpr int kPoints = Chain::kPoints;
  constexpr int kWarps = kThreads / 32;
  static_assert(kPoints <= kThreads && kPoints <= 64,
                "a tile's points are staged by one thread each");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // the plan: run j = lane holds the rays of count k = S - j
  long long slots = 0;   // (warp 0) the filled slots of all runs
  if (warp == 0) {
    const int k = S - lane;
    const bool run = lane < S;
    const int ray0 = run ? bounds[k] : 0;
    const int rays = run ? bounds[k - 1] - ray0 : 0;
    const int cap = run ? kPoints / k : 1;
    const int tiles = (rays + cap - 1) / cap;
    int incl = tiles;
    slots = static_cast<long long>(k) * rays;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
      slots += __shfl_xor_sync(kFull, slots, off);
    }
    s.run_ray0[lane] = ray0;
    s.run_rays[lane] = rays;
    s.run_tile0[lane] = incl - tiles;
    if (lane == 31) s.tiles = incl;
  }
  __syncthreads();
  const int n_tiles = s.tiles;
  if (stats && blockIdx.x == 0 && tid == 0) {
    stats[0] = slots;
    stats[1] = static_cast<long long>(kPoints) * n_tiles;
  }
  // rays without a filled slot: zeros
  for (long long i = static_cast<long long>(bounds[0]) * 5 +
                     static_cast<long long>(blockIdx.x) * kThreads + tid;
       i < static_cast<long long>(R) * 5;
       i += static_cast<long long>(gridDim.x) * kThreads)
    maps[i] = 0.f;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;

  typename Chain::Pipe pipe;
  Chain::begin(s.mlp, pipe, P);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int j = 0;
    while (j + 1 < S && s.run_tile0[j + 1] <= t) ++j;
    const int k = S - j;
    const int cap = kPoints / k;
    const int ray0 = s.run_ray0[j] + (t - s.run_tile0[j]) * cap;
    const int n_rays = min(cap, s.run_ray0[j] + s.run_rays[j] - ray0);

    // stage: warp w takes rays w, w + kWarps, ...; lane = the ray's slot
    for (int q = warp; q < n_rays; q += kWarps) {
      const long long r = ray0 + q;
      const long long idx = r * S + lane;
      const bool in = lane < S;
      const float dd = in ? dists[idx] : 0.f;
      const float zz = in ? z[idx] : 0.f;
      const unsigned filled = __ballot_sync(kFull, dd > 0.f);
      const int rank = __popc(filled & ((1u << lane) - 1u));
      // lanes 0..8 read the ray's o, d and view direction
      const float rv = lane < 3 ? rays_o[r * 3 + lane]
                     : lane < 6 ? rays_d[r * 3 + lane - 3]
                     : lane < 9 ? viewdirs[r * 3 + lane - 6] : 0.f;
      float o[3], d[3], v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = __shfl_sync(kFull, rv, c);
        d[c] = __shfl_sync(kFull, rv, 3 + c);
        v[c] = __shfl_sync(kFull, rv, 6 + c);
      }
      if (lane == 0) s.count[q] = live[r] != 0 ? __popc(filled) : 0;
      if (((filled >> lane) & 1u) && rank < k) {
        const int m = q * k + rank;
        s.zb[m] = zz;
        s.db[m] = dd;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          // o + d * z rounded as two operations, like the plain version
          s.xs[m * 3 + c] = __fadd_rn(o[c], __fmul_rn(d[c], zz));
          s.ds[m * 3 + c] = v[c];
        }
      }
    }
    // the tile's points past its rays: zero points, which nothing reads
    if (tid >= n_rays * k && tid < kPoints) {
      s.zb[tid] = s.db[tid] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) s.xs[tid * 3 + c] = s.ds[tid * 3 + c] = 0.f;
    }
    __syncthreads();
    Chain::embed(s.mlp, s.xs, s.ds);
    Chain::mlp(s.mlp, pipe, P);

    // composite: warp w takes rays w, w + kWarps, ...; lane = the rank
    for (int q = warp; q < n_rays; q += kWarps) {
      const bool on = lane < k;
      const int m = q * k + lane;
      const float* raw = s.mlp.raw + (on ? m : 0) * 4;
      const float sd = on ? fmaxf(raw[3], 0.f) * s.db[m] : 0.f;
      float incl = sd;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float trans = expf(-excl);
      const float alpha = 1.f - expf(-sd);
      const float w = alpha * trans;
      float v[5];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = w * (1.f / (1.f + expf(-(on ? raw[c] : 0.f))));
      v[3] = w;
      v[4] = w * (on ? s.zb[m] : 0.f);
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = warp_sum(v[c]);
      const bool whole = s.count[q] == k;
      if (lane < 5) {
        const float out = lane == 0 ? v[0] : lane == 1 ? v[1]
                        : lane == 2 ? v[2] : lane == 3 ? v[3] : v[4];
        maps[(static_cast<long long>(ray0) + q) * 5 + lane] =
            whole ? 0.f + out : __int_as_float(0x7fc00000);
      }
    }
    __syncthreads();
  }
  pipe.drain();
}

// rays_o, rays_d, viewdirs: (R, 3); z, dists: (R, S), S <= kSB (dists
// already scaled by |rays_d|); live: (R,) int32; bounds: (S + 1,) int32,
// bounds[k] the rays with more than k filled slots (of a live ray), the rays
// ordered by non-increasing filled count; maps: (R, 5); stats: 2 int64 or
// null; params: the weights as the chain's packing lays them out, 16-byte
// aligned.
template <class Chain>
int launch_render_packed(const float* params, const float* rays_o,
                         const float* rays_d, const float* viewdirs,
                         const float* z, const float* dists, const int* live,
                         const int* bounds, float* maps, long long* stats,
                         int R, int S, void* stream) {
  if (S < 1 || S > kSB) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(PackedSmem<Chain>));
  cudaError_t err = cudaFuncSetAttribute(
      render_pass_kernel_packed<Chain>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0)
    render_pass_kernel_packed<Chain><<<R < sms ? R : sms, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
        params, rays_o, rays_d, viewdirs, z, dists, live, bounds, maps,
        stats, R, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerf
