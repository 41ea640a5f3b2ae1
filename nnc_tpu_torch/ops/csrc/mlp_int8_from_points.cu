// K-B4: positional encoding + the NeRF MLP from raw points with every matrix
// product as int8 x int8 -> int32, on the tensor cores.
//
// Replaces the Pallas kernel _kernel_pts_int8 / _fused_call_pts_int8
// (nnc_tpu/ops/mlp_pallas.py:310, :323; body _mlp_body_int8, :127), reached
// through fused_nerf_mlp_int8_from_points (mlp_pallas.py:356): deterministic
// renders with use_int8_mlp (renderer.py:89-92).
//
// What it computes. Weights are int8 with one float32 scale s_o per output
// column (pack_weights_int8, nnc_tpu_torch/ops/mlp_fused.py). The input x of
// every product is quantized at run time with one scale per block of
// kBlock = 64 consecutive points (INT8_ACT_BLOCK in mlp_fused.py),
// m = max|x| + 1e-12 over the block's valid points and all features,
// xq = clip(rint(x * (127 / m)), +-127); the product is summed exactly in
// int32 and leaves as u * (s_o * (m / 127)) in float32. Bias, relu, the skip
// and the view concatenation (two products each, summed in float32 before the
// bias) stay in float32. The TPU kernel takes m over its half tile of 1,024
// points, padding rows included; here rows past n do not enter m. Rounding
// is to nearest even (jnp.round), and every float32 step is a single rounded
// operation (no fused multiply-add), in the plain version's order, so that
// kernel and plain version round the same ties the same way. The integer
// sums are exact, so the order of the products does not change a bit: this
// kernel's output equals that of the __dp4a kernel it replaced.
//
// Bound on the H100: operations. 593,408 int8 multiply-adds a point against
// 24 bytes in and 16 out, at the dense int8 tensor-core peak of 1,979 TOP/s
// (H100 SXM data sheet, 700 W): 262,144 points cannot take less than
// 0.157 ms. The kernel it replaced issued them as __dp4a on the SIMT cores
// (4.976 ms at 262,144 points, 61 TOP/s, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
//
// Design: the bf16 chain's products with s8 operands, and two groups of
// warps in turns.
//  * Products: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, one per
//    16 x 8 output tile and 32 channels, int32 accumulators started at zero.
//    The m16n8k32 A fragment of s8 is, byte for byte, the m16n8k16 fragment
//    of 16-bit values, so A comes from ldmatrix.x4 as in the bf16 chain.
//  * The tile: 128 points, two activation-scale blocks of 64, so that the
//    ~0.6 MB of weights a tile streams from L2 serve twice the points (5.0
//    KB a point). The eight warps form two groups of four, one a block: a
//    warp owns its block's 64 points x 64 (the view layer: 32) output
//    channels, 4 x 8 (4 x 4) m16n8 tiles, 128 (64) int32 accumulators.
//  * Turns. A layer is products (tensor cores, shared memory) and then an
//    epilogue (FP32 and integer pipes: every value converted, scaled,
//    biased, its block's maximum taken, quantized, stored): with both in
//    step, each SM sub-partition's two warps sat in the same phase and one
//    pipe idled (PERF.md). Here the groups take the tensor cores in
//    turns: group 1 runs a layer's products while group 0 runs the
//    epilogue, then the other way round (two named barriers, bar.sync /
//    bar.arrive over both groups, as FlashAttention-3's ping-pong
//    warpgroups); each sub-partition holds one warp of each group.
//  * Activations int8 and point-major in shared memory (row strides 272 and
//    112 bytes: odd multiples of 16 modulo 128, so ldmatrix's eight 16-byte
//    rows lie in distinct bank groups); each group reads and writes its own
//    64 rows only, and synchronises its four warps with a named barrier.
//  * B packed on the host in fragment order (mlp_fused.repack_int8_mma): per
//    slab (32 KB), per eighth of its columns, per k step, per pair of
//    n-tiles, per lane, four 32-bit words {b0 b1} of two n-tiles, each word
//    four consecutive rows of one column (the lowest row in the low byte):
//    rows 32 ks + 4 t + 16 r .. + 3, column 8 (n-tiles an eighth) e + 8 nt +
//    g. A warp reads two eighths (its 64 columns). The 20 slabs stream
//    through a ring of three stages that both groups read: one bulk copy a
//    slab (cp.async.bulk, completion on an mbarrier), refilled by the last
//    of the eight warps to release a stage. The skip and the view layer put
//    their large product first (w5b on h, wva on the feature) and their
//    small one (w5a, wvb on the embedding, 2 and 1 k steps) in the
//    epilogue; fadd is commutative, so the float32 sum of the two scaled
//    products is the same either way round.
//  * The block maxima come from the float32 values in the registers: per
//    thread, by shuffles within the warp, then over the group's four warps
//    through shared memory (a maximum is exact in any order). The heads
//    (alpha 256 -> 1, rgb 128 -> 3) are integer sums of the quantized
//    outputs of layer 7 and of the view layer: each thread multiplies its
//    own values by the head's weights, the four lanes of a row add by
//    shuffles and the warps by shared-memory atomics (exact in any order).
//  * No conversion instruction: integers enter float32 and leave it by
//    adding and subtracting 1.5 * 2^23 (exact below 2^22), since the H100
//    issues I2F and F2I at a quarter of the FP32 rate.
//  * The embedding is computed in float32 (sincosf, as the other kernels),
//    kept in shared memory for its quantization, and quantized once; its
//    scale enters three products (layer 0, the skip, the view layer).
//  * The layer is one function, not inlined: a layer's epilogue is ~1,500
//    instructions of straight code, and a copy inlined at each of the ten
//    calls overflowed the instruction cache (0.985 against 1.146 ms at
//    262,144 points, NVIDIA H100 80GB HBM3, 700 W;
//    nnc_tpu_torch/tools/mma_probe.py section 6). It reaches shared memory
//    through the kernel's extern array (smem()), so that its loads and
//    stores stay LDS / STS.
//  * Persistent CTAs, one per SM, walk the tiles; the ring runs across them.
//    Reruns are bit-equal: integer sums, no float atomics.
#include <cstdint>

#include "nerf_mlp_bf16.cuh"
#include "slab_ring.cuh"

namespace {

using nerf::kInPts;
using nerf::kInViews;
using nerf::kThreads;
using nerf::kW;
using nerf::mma::kSlab;

constexpr int kBlock = 64;             // points per activation scale
constexpr int kMT = kBlock / 16;       // m-tiles of a group's block
constexpr int kPoints = 2 * kBlock;    // 128 points a tile, two groups
constexpr int kStages = 3;             // the weight ring's
constexpr int kLdA = kW + 16;          // int8 activation row stride (bytes)
constexpr int kLdE = 64 + 32 + 16;     // int8 embedding row stride (bytes)
constexpr int kViewsOff = 64;          // the view channels' first byte
constexpr int kLdF = 64 + 32 + 4;      // float embedding row stride

// The 14 weight blocks, in the order of INT8_BLOCKS (mlp_fused.py), for the
// offsets of their scales.
enum { W0, W1, W2, W3, W4, W5A, W5B, W6, W7, WF, WA, WVA, WVB, WR, kBlocks };
// The 12 bias rows, in the order of INT8_BIASES.
enum { B0, B1, B2, B3, B4, B5, B6, B7, BF, BA, BV, BR, kBiases };

__host__ __device__ constexpr int block_rows(int b) {
  return (b == W0 || b == W5A) ? kInPts : b == WVB ? kInViews
         : b == WR ? kW / 2 : kW;
}
__host__ __device__ constexpr int block_out(int b) {
  return b == WA ? 1 : (b == WVA || b == WVB) ? kW / 2 : b == WR ? 3 : kW;
}
// bytes of pack_weights_int8's wq before block b (rows padded to 4)
__host__ __device__ constexpr int block_byte_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += (block_rows(i) + 3) / 4 * 4 * block_out(i);
  return off;
}
__host__ __device__ constexpr int scale_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += block_out(i);
  return off;
}
__host__ __device__ constexpr int bias_size(int i) {
  return i == BA ? 1 : i == BV ? kW / 2 : i == BR ? 3 : kW;
}
__host__ __device__ constexpr int bias_offset(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += bias_size(i);
  return off;
}

// The fragment-ordered buffer (mlp_fused.repack_int8_mma), in 32-bit words:
// the slabs of w0 (1), w1-w4 (2 each), w5b (2), w5a (1), w6, w7, wf (2
// each), wva (1), wvb (1); then alpha's 256 weights and rgb's (128, 4) (3 +
// one zero), one int32 each; then the scales and the biases as float32.
constexpr int kSlabs = 1 + 4 * 2 + 2 + 1 + 3 * 2 + 1 + 1;
static_assert(kSlabs == 20, "slab schedule");
constexpr int kOffAlpha = kSlabs * kSlab;
constexpr int kOffRgb = kOffAlpha + kW;
constexpr int kOffScales = kOffRgb + 4 * (kW / 2);
constexpr int kOffBiases = kOffScales + scale_offset(kBlocks);
constexpr int kParamsSize = (kOffBiases + bias_offset(kBiases) + 63) / 64 * 64;

// Conversions without a conversion instruction (the H100 issues I2F and F2I
// at a quarter of the FP32 rate, and every layer converts each of its
// values twice). 1.5 * 2^23 + x, for an integer |x| < 2^22, is the float32
// whose bits are 0x4B400000 + x: its ulp is 1.
// x as float32, exactly: the integer sums here are at most 256 * 128 * 127
// < 2^22 in magnitude.
__device__ __forceinline__ float exact_float(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.f);
}
// rint(x * q), to nearest even as __float2int_rn, in the low byte of the
// result's bits (adding 1.5 * 2^23 rounds to an integer). The plain
// version's clip to +-127 never binds: a valid point's |x| <= m, so
// |x * q| <= 127 (1 + 2^-24), which rounds to 127 at most. (Rows past n
// may get other bytes; no output reads them.)
__device__ __forceinline__ uint32_t quantize_bits(float x, float q) {
  return __float_as_uint(__fadd_rn(__fmul_rn(x, q), 12582912.f));
}
// the low bytes of a and b as two consecutive int8
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x0040);
}
// the low byte as a signed integer
__device__ __forceinline__ int byte_value(uint32_t bits) {
  return static_cast<int8_t>(bits & 0xffu);
}

// c (16 x 8) += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums;
// lane = 4 g + t holds a0 (g, 4t..4t+3) a1 (g+8, ..) a2 (g, 16+4t..) a3
// (g+8, 16+4t..), four values a word, the lowest channel in the low byte;
// b0 (4t..4t+3, g) b1 (16+4t.., g); c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t)
// c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

using Ring = nerf::ring::SlabRing<kSlabs, kStages>;
static_assert(kSlab == nerf::ring::kSlabFloats, "one slab size");

struct Smem {
  nerf::ring::RingSmem<kStages> ring;   // weight slabs in flight
  int8_t act[kPoints * kLdA];     // the layer's input, then its output
  int8_t embq[kPoints * kLdE];    // 0..62 pts, 63 zero, 64..90 dirs, 91.. zero
  float embf[kPoints * kLdF];     // the float32 embedding, the same columns
  float xs[kPoints * 3];
  float ds[kPoints * 3];
  float red[2][4];                // the warps' maxima of their block
  int uh[kPoints][4];             // the heads' integer sums: r, g, b, alpha
};

// The CTA's shared memory, reached through this array also in the layers'
// own (not inlined) function, where the compiler then still knows every
// pointer into it for a shared-memory one (LDS / STS, not generic loads).
extern __shared__ __align__(128) unsigned char smem_raw[];
__device__ __forceinline__ Smem& smem() {
  return *reinterpret_cast<Smem*>(smem_raw);
}

// Named barriers: the two turns (both groups, 256 threads) and each group's
// own (128 threads). 0 is __syncthreads'.
constexpr int kTurnBar = 1;    // + group: that group may run its products
constexpr int kGroupBar = 3;   // + group
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The heads' weights a thread multiplies its quantized outputs by (HEAD 1:
// alpha's on layer 7, 2: rgb's on the view layer), at its columns.
template <int NT, int HEAD>
struct HeadWeights {
  static constexpr int kC = HEAD == 1 ? 1 : 3;
  int w[NT][2][kC];
  __device__ __forceinline__ void load(const int* __restrict__ P, int col0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          w[nt][j][c] = HEAD == 1
              ? __ldg(P + kOffAlpha + col0 + nt * 8 + j)
              : __ldg(P + kOffRgb + 4 * (col0 + nt * 8 + j) + c);
  }
  // m-tile mt's quantized outputs (their bits) times the weights, summed
  // over the four lanes of a row by shuffles and over the warps into uh
  // (rows of the group's block)
  __device__ __forceinline__ void add(const uint32_t (&hq)[NT][4], int mt,
                                      int (*uh)[4]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int p[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        p[c] = 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            p[c] += byte_value(hq[nt][2 * half + j]) * w[nt][j][c];
        p[c] += __shfl_xor_sync(0xffffffffu, p[c], 1);
        p[c] += __shfl_xor_sync(0xffffffffu, p[c], 2);
      }
      if ((lane & 3) == 0) {
        const int row = mt * 16 + (lane >> 2) + 8 * half;
#pragma unroll
        for (int c = 0; c < kC; ++c)
          atomicAdd(&uh[row][HEAD == 1 ? 3 : c], p[c]);
      }
    }
  }
};

// The group's block maximum of v over its four warps (every thread's v,
// each warp's maximum through s.red); ends with the group's barrier, which
// also orders every warp's reads of the layer's input before the writes of
// its output.
__device__ __forceinline__ float group_max(float v, int group) {
  Smem& s = smem();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int wg = (threadIdx.x >> 5) & 3;
  if ((threadIdx.x & 31) == 0) s.red[group][wg] = v;
  bar_sync(kGroupBar + group, 128);
  return fmaxf(fmaxf(s.red[group][0], s.red[group][1]),
               fmaxf(s.red[group][2], s.red[group][3]));
}

// A layer for the group's block: its products in the group's turn, then
// out[:, 0..64 NT) = quantized act(u1 * (s1 * (m1 / 127)) [+ u2 * (s2 *
// (m2 / 127))] + bias), act the relu if `relu`, into the group's rows of
// the activations: u1 = x1 @ (the next slabs, K1 deep), x1 the group's
// embedding if x1_emb, else its activations (the layer's output overwrites
// them); u2 = the embedding's columns from x2_col (K2 = 0, 32 or 64 deep) @
// (the slab after them); the layer's first slab is slab j0 of the CTA's
// stream of `total`. Returns the output's scale; `head` adds the sums
// of a head on the quantized output (NT = 8: alpha's, 4: rgb's). last: the
// CTA's last products of group 1, which hand no turn on. Ends with the
// group's barrier. Not inlined (see the design notes).
template <int NT, int K2>
__device__ __noinline__ float layer(
    const int* __restrict__ P, int total, int j0, int group, bool x1_emb,
    int K1, float m1, int blk1, int x2_col, float m2, int blk2, int bias,
    int rows, bool relu, bool head, bool last) {
  Smem& s = smem();
  Ring ring{&s.ring, reinterpret_cast<const float*>(P), total, j0};
  int8_t* out = s.act + kBlock * group * kLdA;
  const int8_t* x2 = s.embq + kBlock * group * kLdE + x2_col;
  const int8_t* x1 = x1_emb ? s.embq + kBlock * group * kLdE : out;
  const int ld1 = x1_emb ? kLdE : kLdA;
  constexpr int kHead = NT == 8 ? 1 : 2;
  // fmaxf(v, floor): the relu, or nothing
  const float floor = relu ? 0.f : -__int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int wg = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int col0 = wg * 8 * NT + 2 * (lane & 3);
  const float* scales = reinterpret_cast<const float*>(P + kOffScales);
  const float* b = reinterpret_cast<const float*>(P + kOffBiases) + bias;
  int acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  NNC_PROF(1);
  bar_sync(kTurnBar + group, 256);   // this group's turn
  NNC_PROF(2);
  nerf::ring::run_two_eighths<kMT, NT>(
      ring, acc, x1, ld1, K1 / 32,
      [](int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
        mma_s8(c, a, b);
      });
  if (!last) bar_arrive(kTurnBar + 1 - group, 256);   // the other's turn
  NNC_PROF(3);

  // float32 values in place of the sums, and the block's maximum
  const float d1 = __fdiv_rn(m1, 127.f);
  float f[kMT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + nt * 8 + j;
      const float sc = __fmul_rn(__ldg(scales + blk1 + c), d1);
      const float bj = K2 > 0 ? 0.f : __ldg(b + c);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = __fmul_rn(exact_float(acc[mt][nt][2 * half + j]), sc);
          if constexpr (K2 == 0) v = fmaxf(__fadd_rn(v, bj), floor);
          f[mt][nt][2 * half + j] = v;
        }
    }
  if constexpr (K2 > 0) {
    // the small product on the embedding, then the bias and the relu
    constexpr int kSteps2 = K2 / 32;
    constexpr int kPer = NT / 2;
    constexpr int kStepVec = 16 * kPer;
    constexpr int kEighth = kSlab / 8 / 4;
    const uint4* e0 = reinterpret_cast<const uint4*>(ring.acquire()) +
                      2 * wg * kEighth + lane;
    uint32_t a2[kMT][kSteps2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int ks = 0; ks < kSteps2; ++ks)
        nerf::bf16::ldmatrix_x4(
            a2[mt][ks],
            nerf::ring::smem_u32(x2 + (mt * 16 + (lane & 15)) * kLdE +
                                 16 * (lane >> 4) + 32 * ks));
    const float d2 = __fdiv_rn(m2, 127.f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b2[kSteps2][2];
#pragma unroll
      for (int ks = 0; ks < kSteps2; ++ks) {
        const uint4 w4 = e0[(nt / kPer) * kEighth + ks * kStepVec +
                            ((nt % kPer) / 2) * 32];
        b2[ks][0] = nt % 2 ? w4.z : w4.x;
        b2[ks][1] = nt % 2 ? w4.w : w4.y;
      }
      float sc2[2], bb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + nt * 8 + j;
        sc2[j] = __fmul_rn(__ldg(scales + blk2 + c), d2);
        bb[j] = __ldg(b + c);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        int acc2[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < kSteps2; ++ks) mma_s8(acc2, a2[mt][ks], b2[ks]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = __fadd_rn(f[mt][nt][i], __fmul_rn(exact_float(acc2[i]),
                                                       sc2[i & 1]));
          f[mt][nt][i] = fmaxf(__fadd_rn(v, bb[i & 1]), floor);
        }
      }
    }
    ring.release();
  }
  float mx = 0.f;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (mt * 16 + g + 8 * half < rows)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(fabsf(f[mt][nt][2 * half]),
                               fabsf(f[mt][nt][2 * half + 1])));
  NNC_PROF(4);
  const float m = __fadd_rn(group_max(mx, group), 1e-12f);
  NNC_PROF(5);
  const float q = __fdiv_rn(127.f, m);
  HeadWeights<NT, kHead> hw;
  if (head) hw.load(P, col0);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    uint32_t hq[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hq[nt][i] = quantize_bits(f[mt][nt][i], q);
      int8_t* o = out + (mt * 16 + g) * kLdA + col0 + nt * 8;
      *reinterpret_cast<uint16_t*>(o) =
          static_cast<uint16_t>(pack2(hq[nt][0], hq[nt][1]));
      *reinterpret_cast<uint16_t*>(o + 8 * kLdA) =
          static_cast<uint16_t>(pack2(hq[nt][2], hq[nt][3]));
    }
    if (head) hw.add(hq, mt, s.uh + kBlock * group);
  }
  NNC_PROF(6);
  // the group's output stored (and s.red read) before its next products
  bar_sync(kGroupBar + group, 128);
  NNC_PROF(7);
  return m;
}

// The group's posenc (as nerf_mlp_bf16.cuh's embed_tile computes it, in
// float32) into s.embf, then quantized with one scale over the group's
// valid points into its rows of s.embq; returns the scale. The padding
// columns stay as the CTA zeroed them. Ends with the group's barrier.
__device__ __forceinline__ float embed(int group, int rows) {
  Smem& s = smem();
  float mx = 0.f;
  // c = 3 f + d; f = 0: raw xyz, 1..10: xyz freqs, 11: raw dir, 12..15: dir
  static_assert(kBlock * 48 % 128 == 0, "whole rounds");
#pragma unroll 6
  for (int k = 0; k < kBlock * 48 / 128; ++k) {
    const int i = (threadIdx.x & 127) + 128 * k;
    const int m = i / 48, c = i - m * 48, f = c / 3, d = c - f * 3;
    const int p = kBlock * group + m;
    const bool view = f >= 11;
    const float x = view ? s.ds[p * 3 + d] : s.xs[p * 3 + d];
    float* e = s.embf + p * kLdF + (view ? kViewsOff : 0);
    const int fr = view ? f - 12 : f - 1;
    float a;
    if (fr < 0) {
      e[d] = x;
      a = fabsf(x);
    } else {
      float sn, cs;
      sincosf(x * static_cast<float>(1 << fr), &sn, &cs);
      e[3 + 6 * fr + d] = sn;
      e[6 + 6 * fr + d] = cs;
      a = fmaxf(fabsf(sn), fabsf(cs));
    }
    if (m < rows) mx = fmaxf(mx, a);
  }
  const float me = __fadd_rn(group_max(mx, group), 1e-12f);
  const float q = __fdiv_rn(127.f, me);
  // four channels of one point a thread: a float4 in, a word out
  for (int i = threadIdx.x & 127; i < kBlock * (kLdE - 16) / 4; i += 128) {
    const int m = kBlock * group + i / ((kLdE - 16) / 4);
    const int c0 = 4 * (i % ((kLdE - 16) / 4));
    const float4 x = *reinterpret_cast<const float4*>(s.embf + m * kLdF + c0);
    *reinterpret_cast<uint32_t*>(s.embq + m * kLdE + c0) = __byte_perm(
        pack2(quantize_bits(x.x, q), quantize_bits(x.y, q)),
        pack2(quantize_bits(x.z, q), quantize_bits(x.w, q)), 0x5410);
  }
  bar_sync(kGroupBar + group, 128);
  return me;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_int8_from_points_kernel(const int* __restrict__ P,
                            const float* __restrict__ pts,
                            const float* __restrict__ dirs,
                            float* __restrict__ out, int n, int tiles) {
  Smem& s = smem();
  const int tid = threadIdx.x;
  const int group = tid >> 7;
  const int gt = tid & 127;   // thread of the group
  nerf::mma::prof_begin();
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1)
                       / gridDim.x;
  const int total = my_tiles * kSlabs;   // the slabs the CTA reads
  if (tid == 0)
    Ring{&s.ring, reinterpret_cast<const float*>(P), total, 0}.start();
  // the float embedding's padding columns (63, 91..99), never written
  for (int i = tid; i < kPoints * 10; i += kThreads) {
    const int m = i / 10, j = i - m * 10;
    s.embf[m * kLdF + (j == 0 ? kInPts : kViewsOff + kInViews + j - 1)] = 0.f;
  }
  __syncthreads();
  // group 0 takes the first turn
  if (group == 1) bar_arrive(kTurnBar, 256);
  const float* scales = reinterpret_cast<const float*>(P + kOffScales);
  const float* biases = reinterpret_cast<const float*>(P + kOffBiases);
  for (int t = 0; t < my_tiles; ++t) {
    const long long base = static_cast<long long>(blockIdx.x + t * gridDim.x)
                           * kPoints + kBlock * group;
    const long long left = n - base;
    const int rows = left < 0 ? 0 : left < kBlock ? static_cast<int>(left)
                                                  : kBlock;
    const bool last = group == 1 && t == my_tiles - 1;
    for (int i = gt; i < kBlock * 3; i += 128) {
      const bool valid = i / 3 < rows;
      s.xs[kBlock * 3 * group + i] = valid ? pts[base * 3 + i] : 0.f;
      s.ds[kBlock * 3 * group + i] = valid ? dirs[base * 3 + i] : 0.f;
    }
    for (int i = gt; i < kBlock * 4; i += 128)
      (&s.uh[kBlock * group][0])[i] = 0;
    bar_sync(kGroupBar + group, 128);
    NNC_PROF(0);

    // the embedding and its one scale (points and view directions
    // together), which enters layer 0, the skip and the view layer
    const float me = embed(group, rows);

    // the tile's slabs: w0 (0), w1-w4 (1-8), w5b, w5a (9-11), w6 (12-13),
    // w7 (14-15), wf (16-17), wva, wvb (18-19)
    const int j = t * kSlabs;
    float m = layer<8, 0>(P, total, j, group, true, 64, me, scale_offset(W0),
                          0, 0.f, 0, bias_offset(B0), rows, true, false,
                          false);
#pragma unroll 1
    for (int i = 1; i <= 4; ++i)
      m = layer<8, 0>(P, total, j + 2 * i - 1, group, false, kW, m,
                      scale_offset(W0 + i), 0, 0.f, 0, bias_offset(B0 + i),
                      rows, true, false, false);
    // skip: h @ w5b + emb @ w5a, each with its own activation scale
    m = layer<8, 64>(P, total, j + 9, group, false, kW, m, scale_offset(W5B),
                     0, me, scale_offset(W5A), bias_offset(B5), rows, true,
                     false, false);
    m = layer<8, 0>(P, total, j + 12, group, false, kW, m, scale_offset(W6),
                    0, 0.f, 0, bias_offset(B6), rows, true, false, false);
    // layer 7, and the alpha head's sums of its quantized output h
    const float mh = layer<8, 0>(P, total, j + 14, group, false, kW, m,
                                 scale_offset(W7), 0, 0.f, 0, bias_offset(B7),
                                 rows, true, true, false);
    // feature (no activation) on h
    const float mf = layer<8, 0>(P, total, j + 16, group, false, kW, mh,
                                 scale_offset(WF), 0, 0.f, 0, bias_offset(BF),
                                 rows, false, false, false);
    // views: relu(feature @ wva + view emb @ wvb + bv), and the rgb head's
    // sums of its quantized output
    const float mv = layer<4, 32>(P, total, j + 18, group, false, kW, mf,
                                  scale_offset(WVA), kViewsOff, me,
                                  scale_offset(WVB), bias_offset(BV), rows,
                                  true, true, last);

    // the logits: r, g, b from the view layer's scale, sigma from layer 7's
    for (int i = gt; i < kBlock * 4; i += 128) {
      const int row = i >> 2, c = i & 3;
      if (row >= rows) continue;
      const bool alpha = c == 3;
      const float sc = __fmul_rn(
          __ldg(scales + (alpha ? scale_offset(WA) : scale_offset(WR) + c)),
          __fdiv_rn(alpha ? mh : mv, 127.f));
      const float bias = __ldg(biases + (alpha ? bias_offset(BA)
                                               : bias_offset(BR) + c));
      out[(base + row) * 4 + c] = __fadd_rn(
          __fmul_rn(exact_float(s.uh[kBlock * group + row][c]), sc), bias);
    }
    // (s.uh read before the next tile zeroes it)
    bar_sync(kGroupBar + group, 128);
    NNC_PROF(8);
  }
  nerf::mma::prof_end();
}

}  // namespace

// Sizes of pack_weights_int8's three buffers (int8 bytes, floats, floats),
// for the host to hold against the offsets used here.
extern "C" int nnc_int8_sizes(int* wq_bytes, int* n_scales, int* n_biases) {
  *wq_bytes = block_byte_offset(kBlocks);
  *n_scales = scale_offset(kBlocks);
  *n_biases = bias_offset(kBiases);
  return 0;
}

// Length of the fragment-ordered buffer (repack_int8_mma), in 32-bit words.
extern "C" int nnc_int8_mma_size() { return kParamsSize; }

#ifdef NNC_MMA_PROFILE
extern "C" int nnc_int8_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// packed: the buffer of repack_int8_mma, 16-byte aligned; pts, dirs: (n, 3);
// out: (n, 4) [rgb logits, sigma].
extern "C" int nnc_mlp_int8_from_points(const void* packed, const float* pts,
                                        const float* dirs, float* out, int n,
                                        void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_int8_from_points_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (n + kPoints - 1) / kPoints;
    mlp_int8_from_points_kernel<<<tiles < sms ? tiles : sms, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(packed), pts, dirs, out, n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
