// K-B1's weight gradient on the tensor cores, float32 (3xTF32) and bf16:
// the second pass of K-B1's backward with dW.
//
// Replaces the with-dW form of the Pallas _bwd_call
// (nnc_tpu/ops/mlp_train_pallas.py:300, _make_bwd_kernel :164): its tdot(x,
// du) per layer (:218-253), the view layer's wva and wvb, the skip's w5a and
// w5b. Users reach it through RenderConfig.train_with_dw (fine-tuning) and
// tools/bench_train_step.py --with_dw.
//
// What it computes. dW_l = X_l^T dU_l for the twelve layers, summed over
// every point: dU_l is the layer's du = dpre * ls, which the first pass (the
// tensor-core backward of mlp_train.cu / mlp_train_bf16.cu, with a du
// workspace) wrote per point in the u_offset layout of the forward's
// workspace of u; X_l is the layer's input, rebuilt here as the forward
// computed it: act(fmaf(u, ls, b)) of the layer below from the workspace of
// u (relu but for the feature layer), or the positional encoding of the
// points (layer 0, the skip's first 63 columns) or of the view directions
// (the view layer's last 27). In bf16 X is rounded to bf16 where the
// forward rounds it and dU is the first pass's bf16(du), so every product
// is exact in float32 (mlp_train_pallas.py:181-192); dW is rounded to bf16
// once summed over all points (:358).
//
// Bound on the H100. float32: operations, 590,848 multiply-adds a point
// (every weight once), 233 GFLOP at 196,608 points, at 165 TFLOP/s (a third
// of the dense TF32 peak: three TF32 products a float32 product) 1.41 ms.
// bf16: bytes, the workspaces of u (9,744 B a point) and du (4,880 B, its
// rows padded to 16 bytes) read once: 2.9 GB, 0.86 ms at 3.35 TB/s (H100 SXM
// data sheet, 700 W).
//
// Design: a GEMM whose depth runs over the points.
//  - Jobs. The dW of the network is cut into 42 output tiles of at most 128
//    out x 128 in channels (kJobs), each a block of one layer's dW with one
//    source of X; the points into fixed chunks of `chunk` points (a multiple
//    of 64). A CTA computes one tile over one chunk (grid = jobs x chunks;
//    the jobs of a chunk are neighbours in launch order, so that its rows of
//    u and du are read from device memory about once and then from L2) and
//    writes its partial tile to the chunk's row of a partial buffer; a
//    second kernel sums the rows in a fixed order (reduce_rows,
//    mlp_train.cuh) and rounds dW in bf16. No atomics: reruns are bit-equal.
//  - Staging. A k-block is 64 points: their 128 du columns and the 128
//    columns of u that X is made of, point-major in shared memory, copied
//    by cp.async through a ring of three stages, two blocks ahead of the
//    products; X is rebuilt (and rounded) from the landed u one block ahead
//    of the products, so that one barrier a block suffices and the rebuild
//    overlaps other warps' products. Rows past the last point the first
//    pass wrote are never read; rows past n hold du = 0 (a zero cotangent),
//    so they add exactly zero.
//  - Products. 8 warps as 2 (out) x 4 (in), a warp 64 x 32: 4 x 4 m16n8
//    tiles. float32: mma.sync m16n8k8 .tf32, every operand split into hi +
//    lo (nerf_mlp_mma.cuh), lo * hi + hi * lo + hi * hi, A and B fragments
//    by conflict-free scalar loads (row stride 136 = 8 mod 32 words). bf16:
//    mma.sync m16n8k16 with float32 sums, A = dU^T and B = X by
//    ldmatrix.trans from the point-major staging (row stride 272 B).
//  - Two-level sums. The tensor core adds into its accumulator by cutting,
//    not rounding (nerf_mlp_mma.cuh); over a depth of 196,608 points that
//    bias would grow far past what the float32 chain holds. So every 32
//    points (kSum) sum in a tile of their own, started from zero, which
//    joins the tile's sum by a rounded float32 add; the chunks' partials add
//    in float32 too.
//  - Tiles that are not full (the heads' 1 and 3 out channels, the
//    embeddings' 63 and 27 in channels) stage zeros in their padding; a warp
//    whose 64 x 32 part lies wholly in it skips its products. The
//    embeddings' tiles compute each sincosf once a point, frequency and
//    coordinate, not once a channel.
//
// Where the time goes at 196,608 points (NVIDIA H100 80GB HBM3, 700 W;
// nnc_tpu_torch/tools/kb1_dw_bench.py --profile, thread 0's clock marks):
// float32 5.7 ms, 60% of a CTA's clocks in the products, 21% issuing the
// next blocks' copies, 14% rebuilding X; bf16 4.4 ms, 53% issuing the
// copies, 21% rebuilding, 18% in the products. Both stream about 1.45 TB/s
// of u and du from L2 into the SMs (the 42 tiles read a point's row 2.2
// times over: 6.2 GB in bf16, 8.3 GB in float32); --profile also times a
// build whose chunks all read the first chunk's rows, held in L2
// (-DNNC_DW_PROBE_HOT, wrong sums), to show how much of that device memory
// accounts for. Fewer, larger tiles would read less, but a 128 x 128
// tile's accumulators and their two-level partners already take 128 of a
// thread's 244 registers.
#include "mlp_train.cuh"
#include "nerf_mlp_bf16.cuh"

namespace {

using namespace nerf;
using namespace nerf::train;

// points whose products sum in a tile of their own (the two-level sums)
constexpr int kSum = 32;
// points of a k-block, the unit of the staging ring (a multiple of kSum;
// three stages of 64 points fill 209 KB of shared memory in float32)
constexpr int kKB = 64;
static_assert(kKB % kSum == 0 && kKB % 8 == 0, "k-blocks of whole sums");
constexpr int kTile = 128;           // out and in channels of a job's tile
constexpr int kLdS = kTile + 8;      // staging row stride, in elements
constexpr int kSrcPts = -1, kSrcViews = -2;

// One output tile: layer, first out channel, out channels, source of X (the
// layer whose activation it is, or an embedding), X's first column in the
// source (a workspace column, or an embedding channel), in channels, and
// the tile's first input column of the layer.
struct Job {
  int layer, m0, m_valid, src, col, n_valid, n_base;
};

constexpr int kNumJobs = 42;
__constant__ Job kJobs[kNumJobs] = {
    // pts layers 1..7 but 5 (X = h of the layer below), feature (X = h7)
#define NNC_SQUARE(L, S)                                                    \
  {L, 0, 128, S, u_offset(S), 128, 0}, {L, 0, 128, S, u_offset(S) + 128,    \
                                        128, 128},                          \
      {L, 128, 128, S, u_offset(S), 128, 0},                                \
      {L, 128, 128, S, u_offset(S) + 128, 128, 128}
    NNC_SQUARE(1, 0), NNC_SQUARE(2, 1), NNC_SQUARE(3, 2), NNC_SQUARE(4, 3),
    NNC_SQUARE(6, 5), NNC_SQUARE(7, 6), NNC_SQUARE(8, 7),
    // the skip: its columns 63.. act on h4
    {5, 0, 128, 4, u_offset(4), 128, kInPts},
    {5, 0, 128, 4, u_offset(4) + 128, 128, kInPts + 128},
    {5, 128, 128, 4, u_offset(4), 128, kInPts},
    {5, 128, 128, 4, u_offset(4) + 128, 128, kInPts + 128},
    // the view layer's feature columns (no relu)
    {10, 0, 128, 8, u_offset(8), 128, 0},
    {10, 0, 128, 8, u_offset(8) + 128, 128, 128},
#undef NNC_SQUARE
    // the tiles that are not full
    {0, 0, 128, kSrcPts, 0, kInPts, 0},
    {0, 128, 128, kSrcPts, 0, kInPts, 0},
    {5, 0, 128, kSrcPts, 0, kInPts, 0},
    {5, 128, 128, kSrcPts, 0, kInPts, 0},
    {10, 0, 128, kSrcViews, 0, kInViews, kW},
    {kLayerAlpha, 0, 1, 7, u_offset(7), 128, 0},
    {kLayerAlpha, 0, 1, 7, u_offset(7) + 128, 128, 128},
    {kLayerRgb, 0, 3, kLayerViews, u_offset(kLayerViews), 128, 0},
};

template <bool BF16>
struct DwTypes;
template <>
struct DwTypes<false> {
  using T = float;                 // du and the staged dU
  static constexpr int kDuLd = kU;  // the du workspace's row stride
};
template <>
struct DwTypes<true> {
  using T = __nv_bfloat16;
  static constexpr int kDuLd = kDuLdBf16;
};

constexpr int kStagesDw = 3;   // k-blocks in the ring: copied, rebuilt,
                               // multiplied

// The ring: per stage the k-block's dU (A) and the raw u of X's source,
// point-major; in float32 X is rebuilt in place over the raw u, in bf16
// into one of two buffers of its own.
template <bool BF16>
struct DwSmem {
  using T = typename DwTypes<BF16>::T;
  T a[kStagesDw][kKB * kLdS];
  float u[kStagesDw][kKB * kLdS];
  __nv_bfloat16 xb[2][BF16 ? kKB * kLdS : 8];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

// The k-block's rows p0 .. of a workspace (row stride LD), columns
// col .. col + valid - 1 (and the rest of the last VEC-element copy), into
// a stage (row stride kLdS): cp.async copies of VEC elements, whose source
// is then VEC-aligned; VEC = 0: plain loads and stores, for the columns at
// the view layer's and the rgb head's odd offsets in bf16, which no
// cp.async size reaches.
template <int VEC, int LD, class T>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long p0, int col, int valid) {
  constexpr int kVec = VEC > 0 ? VEC : 1;
  constexpr int kPerRow = kTile / kVec;
  for (int i = threadIdx.x; i < kKB * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (c >= valid) continue;
    const T* g = src + (p0 + r) * LD + col + c;
    if (VEC > 0)
      cp_async<kVec * sizeof(T)>(dst + r * kLdS + c, g);
    else
      dst[r * kLdS + c] = *g;
  }
}

// Starts the copies of the k-block at p0 into stage st (one commit group).
template <bool BF16>
__device__ __forceinline__ void issue_block(
    DwSmem<BF16>& s, int st, const Job& j, const float* __restrict__ ws,
    const typename DwTypes<BF16>::T* __restrict__ DU, long long p0) {
  // 16-byte copies: 4 float32 or 8 bf16 values
  constexpr int kVecDu = BF16 ? 8 : 4;
  constexpr int kLdDu = DwTypes<BF16>::kDuLd;
  const int du_col = u_offset(j.layer) + j.m0;
  if (du_col % kVecDu == 0)
    copy_rows<kVecDu, kLdDu>(s.a[st], DU, p0, du_col, j.m_valid);
  else
    copy_rows<BF16 ? 0 : 1, kLdDu>(s.a[st], DU, p0, du_col, j.m_valid);
  if (j.src >= 0) {
    if ((j.col & 3) == 0)
      copy_rows<4, kU>(s.u[st], ws, p0, j.col, j.n_valid);
    else
      copy_rows<1, kU>(s.u[st], ws, p0, j.col, j.n_valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// X of the k-block at p0 as the forward computed it, from the raw u in
// stage st (or the points' positional encoding), into that stage (float32)
// or xb[xi] (bf16): this thread's rows (tid >> 5) + 8 i and columns
// 4 (tid & 31) .. + 3. ls, b: the thread's columns' scales and biases.
template <bool BF16>
__device__ __forceinline__ void rebuild_block(
    DwSmem<BF16>& s, int st, int xi, const Job& j, const float (&ls)[4],
    const float (&b)[4], const float* __restrict__ pts,
    const float* __restrict__ dirs, long long p0, int n) {
  if (j.src < 0) {
    // the positional encoding as the forward's embed_tile computes it (the
    // same sincosf of the same argument): one item a point, frequency and
    // coordinate, the raw coordinate at frequency 0; the padding channels
    // stay zero
    const int freqs = j.src == kSrcPts ? 10 : 4;
    const int per_point = 3 * (freqs + 1);
    const float* __restrict__ xyz = j.src == kSrcPts ? pts : dirs;
    for (int it = threadIdx.x; it < kKB * per_point; it += kThreads) {
      const int r = it / per_point;
      const int f = (it - r * per_point) / 3;
      const int d = it - r * per_point - 3 * f;
      const long long p = p0 + r;
      const float x = p < n ? __ldg(xyz + p * 3 + d) : 0.f;
      float v0 = x, v1 = 0.f;
      int c0 = d, c1 = -1;
      if (f > 0) {
        sincosf(x * static_cast<float>(1 << (f - 1)), &v0, &v1);
        c0 = 6 * f - 3 + d;
        c1 = 6 * f + d;
      }
      if constexpr (BF16) {
        s.xb[xi][r * kLdS + c0] = __float2bfloat16_rn(v0);
        if (c1 >= 0) s.xb[xi][r * kLdS + c1] = __float2bfloat16_rn(v1);
      } else {
        s.u[st][r * kLdS + c0] = v0;
        if (c1 >= 0) s.u[st][r * kLdS + c1] = v1;
      }
    }
    return;
  }
  const int q = 4 * (threadIdx.x & 31);
  const bool relu = j.src != kLayerFeature;
#pragma unroll
  for (int i = 0; i < kKB / 8; ++i) {
    const int r = (threadIdx.x >> 5) + 8 * i;
    float* raw = s.u[st] + r * kLdS + q;
    const float4 u = *reinterpret_cast<const float4*>(raw);
    const float uv[4] = {u.x, u.y, u.z, u.w};
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float h = fmaf(uv[c], ls[c], b[c]);
      x[c] = q + c < j.n_valid ? (relu ? fmaxf(h, 0.f) : h) : 0.f;
    }
    if constexpr (BF16) {
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(s.xb[xi] + r * kLdS + q);
      o[0] = __floats2bfloat162_rn(x[0], x[1]);
      o[1] = __floats2bfloat162_rn(x[2], x[3]);
    } else {
      *reinterpret_cast<float4*>(raw) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// part (this warp's 64 x 32) = A^T X over the k-block's 32 points, float32
// as 3xTF32: lane 4 g + t reads A (m, k) at a[k * kLdS + m], X (k, n) at
// x[k * kLdS + n].
__device__ __forceinline__ void block_products(float (&part)[4][4][4],
                                               const float* __restrict__ a,
                                               const float* __restrict__ x,
                                               int m_w, int n_w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kSum / 8; ++ks) {
    const float* ak = a + (ks * 8 + t) * kLdS + m_w + g;
    const float* xk = x + (ks * 8 + t) * kLdS + n_w + g;
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      mma::split_tf32(ak[mt * 16], ah[mt][0], al[mt][0]);
      mma::split_tf32(ak[mt * 16 + 8], ah[mt][1], al[mt][1]);
      mma::split_tf32(ak[4 * kLdS + mt * 16], ah[mt][2], al[mt][2]);
      mma::split_tf32(ak[4 * kLdS + mt * 16 + 8], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma::split_tf32(xk[nt * 8], bh[nt][0], bl[nt][0]);
      mma::split_tf32(xk[4 * kLdS + nt * 8], bh[nt][1], bl[nt][1]);
    }
    // the small terms first
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (ks == 0)
          mma::mma_tf32_first(part[mt][nt], al[mt], bh[nt]);
        else
          mma::mma_tf32(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma::mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma::mma_tf32(part[mt][nt], ah[mt], bh[nt]);
  }
}

// The same in bf16: two k16 steps, A = dU^T and B = X by ldmatrix.trans.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void block_products(
    float (&part)[4][4][4], const __nv_bfloat16* __restrict__ a,
    const __nv_bfloat16* __restrict__ x, int m_w, int n_w) {
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3, r = lane & 7;
  // matrix i of A's x4: k rows 8 (i >> 1) + r, m columns 8 (i & 1); of B's:
  // k rows 8 (i & 1) + r, n columns 8 (i >> 1)
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      a + (8 * (i >> 1) + r) * kLdS + m_w + 8 * (i & 1)));
  const uint32_t x_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      x + (8 * (i & 1) + r) * kLdS + n_w + 8 * (i >> 1)));
  constexpr uint32_t kStep = 16 * kLdS * sizeof(__nv_bfloat16);
#pragma unroll
  for (int ks = 0; ks < kSum / 16; ++ks) {
    uint32_t bf[4][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t v[4];
      ldmatrix_x4_trans(v, x_addr + ks * kStep + q * 16 * sizeof(__nv_bfloat16));
      bf[2 * q][0] = v[0];
      bf[2 * q][1] = v[1];
      bf[2 * q + 1][0] = v[2];
      bf[2 * q + 1][1] = v[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, a_addr + ks * kStep +
                                mt * 16 * sizeof(__nv_bfloat16));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (ks == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
        }
        bf16::mma_bf16(part[mt][nt], af, bf[nt]);
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_dw_kernel(const float* __restrict__ ws,
                    const typename DwTypes<BF16>::T* __restrict__ DU,
                    const float* __restrict__ LS,
                    const float* __restrict__ BI,
                    const float* __restrict__ pts,
                    const float* __restrict__ dirs,
                    float* __restrict__ partials, int n, int rows,
                    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<BF16>& s = *reinterpret_cast<DwSmem<BF16>*>(smem_raw);
  mma::prof_begin();
  const Job j = kJobs[blockIdx.x];
#ifdef NNC_DW_PROBE_HOT
  const long long first = 0;   // kb1_dw_bench.py's probe: every chunk reads
                               // the first one's rows
#else
  const long long first = static_cast<long long>(blockIdx.y) * chunk;
#endif
  const int blocks =
      static_cast<int>((min(first + chunk, static_cast<long long>(rows)) -
                        first) / kKB);
  const int warp = threadIdx.x >> 5;
  const int m_w = 64 * (warp >> 2), n_w = 32 * (warp & 3);
  const bool active = m_w < j.m_valid && n_w < j.n_valid;

  // the padding of A and X stays zero: no copy ever writes there
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(DwSmem<BF16>) / 4);
       i += kThreads)
    reinterpret_cast<float*>(smem_raw)[i] = 0.f;
  // this thread's columns' scales and biases (they share the workspace's
  // columns)
  float ls[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  if (j.src >= 0) {
    const int q = 4 * (threadIdx.x & 31);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (q + c < j.n_valid) {
        ls[c] = __ldg(LS + j.col + q + c);
        b[c] = __ldg(BI + j.col + q + c);
      }
  }
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  __syncthreads();

  // one barrier a block: block k's products run while the next block's X
  // is rebuilt (by other warps, or before them by the same one) and the
  // copies of the blocks after it are in flight
  for (int k = 0; k < kStagesDw - 1; ++k) {
    if (k < blocks) issue_block<BF16>(s, k, j, ws, DU, first + k * kKB);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStagesDw - 2) : "memory");
  __syncthreads();
  rebuild_block<BF16>(s, 0, 0, j, ls, b, pts, dirs, first, n);
  NNC_PROF(0);
  for (int k = 0; k < blocks; ++k) {
    const int st = k % kStagesDw;
    // block k + 1 has landed; block k's X is rebuilt; every warp is done
    // with block k - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStagesDw - 3) : "memory");
    NNC_PROF(1);
    __syncthreads();
    NNC_PROF(2);
    const int ahead = k + kStagesDw - 1;
    if (ahead < blocks)
      issue_block<BF16>(s, ahead % kStagesDw, j, ws, DU, first + ahead * kKB);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    NNC_PROF(3);
    if (k + 1 < blocks)
      rebuild_block<BF16>(s, (k + 1) % kStagesDw, (k + 1) & 1, j, ls, b, pts,
                          dirs, first + (k + 1) * kKB, n);
    NNC_PROF(4);
    if (active) {
#pragma unroll 1
      for (int h = 0; h < kKB; h += kSum) {
        float part[4][4][4];
        if constexpr (BF16)
          block_products(part, s.a[st] + h * kLdS, s.xb[k & 1] + h * kLdS,
                         m_w, n_w);
        else
          block_products(part, s.a[st] + h * kLdS, s.u[st] + h * kLdS, m_w,
                         n_w);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
      }
    }
    NNC_PROF(5);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  mma::prof_end();

  if (!active) return;
  // c0 (row g, col 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* out = partials + static_cast<size_t>(blockIdx.y) * kWt +
               wt_offset(j.layer) + j.n_base;
  const int ldw = layer_in(j.layer);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_w + mt * 16 + g + 8 * half;
      if (m >= j.m_valid) continue;
      float* row = out + static_cast<size_t>(j.m0 + m) * ldw;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n_w + nt * 8 + 2 * t + c;
          if (col < j.n_valid) row[col] = acc[mt][nt][2 * half + c];
        }
    }
}

template <bool BF16>
int launch_dw(const float* ws, const void* du, const float* ls,
              const float* bi, const float* pts, const float* dirs,
              float* partials, float* out, int n, int chunk,
              cudaStream_t st) {
  if (chunk <= 0 || chunk % kKB) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(DwSmem<BF16>));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_dw_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the rows the first pass wrote: whole tiles of kM points
  const int rows = (n + kM - 1) / kM * kM;
  const int chunks = (rows + chunk - 1) / chunk;
  if (n > 0) {
    mlp_train_dw_kernel<BF16><<<dim3(kNumJobs, chunks), kThreads, smem, st>>>(
        ws, static_cast<const typename DwTypes<BF16>::T*>(du), ls, bi, pts,
        dirs, partials, n, rows, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return reduce_rows(partials, n > 0 ? chunks : 0, kWt, out, st,
                     BF16 ? kWt : 0);
}

}  // namespace

// The second pass of K-B1's backward with dW: out (593,408,) = every
// layer's dW (out, in), summed over the n points. ws: the forward's
// workspace of u; du: the first pass's du workspace (float32 here, bf16 with
// rows of 2,440 values in nnc_mlp_train_dw_bf16), both (rows, 2,436) with
// rows of at least ceil(n / 64) * 64; ls, bi: scales and biases (2,436 each); pts, dirs:
// (n, 3); partials: (ceil(ceil(n / 64) * 64 / chunk), 593,408) scratch;
// chunk: points of a CTA, a multiple of the k-block (64).
#ifdef NNC_MMA_PROFILE
// Reads the clock sums of the launches so far into out[9] and zeroes them:
// thread 0 of a CTA (warp 0: its products count) from its start to the
// first block's X (slot 0), then a block's wait for its copies (1), the
// barrier (2), the next copies issued (3), the next X rebuilt (4), the
// products (5) (nnc_tpu_torch/tools/kb1_dw_bench.py --profile).
extern "C" int nnc_dw_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

extern "C" int nnc_mlp_train_dw(const float* ws, const float* du,
                                const float* ls, const float* bi,
                                const float* pts, const float* dirs,
                                float* partials, float* out, int n, int chunk,
                                void* stream) {
  return launch_dw<false>(ws, du, ls, bi, pts, dirs, partials, out, n, chunk,
                          static_cast<cudaStream_t>(stream));
}

// The same in bf16, on the workspaces of mlp_train_bf16.cu; dW rounded to
// bf16 once summed.
extern "C" int nnc_mlp_train_dw_bf16(const float* ws, const void* du,
                                     const float* ls, const float* bi,
                                     const float* pts, const float* dirs,
                                     float* partials, float* out, int n,
                                     int chunk, void* stream) {
  return launch_dw<true>(ws, du, ls, bi, pts, dirs, partials, out, n, chunk,
                         static_cast<cudaStream_t>(stream));
}
