// K-B6: one shard's column + row pair of the tensor-parallel NeRF MLP,
// out = act(x @ Wa + ba) @ Wb, float32, both products on the tensor cores
// at float32 accuracy (3xTF32).
//
// Replaces the Pallas kernel _pair_kernel / fused_pair
// (nnc_tpu/ops/mlp_tp_pallas.py:64, :82). Wa (K, S) is a column shard of an
// even layer (w0, w2, w4, w6, wf), Wb (S, O2) the matching row shard of the
// odd layer behind it (w1, w3, w5b, w7, wva); S = 256 / M for M shards. The
// hidden tile act(x @ Wa + ba) never leaves the CTA: that is the point of the
// pair. The result is a partial sum; the sum over the shards, the odd layer's
// bias and its activation happen outside (nnc_tpu_torch/ops/mlp_tp_fused.py).
//
// Bound on the H100: 2 S (K + O2) operations a point against 4 (K + O2)
// bytes (x read, the partial sums written, float32). Every float32 product
// is three TF32 products, so the float32-equivalent peak is a third of the
// dense TF32 peak of 495 TFLOP/s (H100 SXM data sheet, 700 W): 165 TFLOP/s,
// S / 2 operations a byte against the card's 49. At M = 4 (K 256, S 64, O2
// 256) and 262,144 points: 0.160 ms by bytes, 0.104 ms by operations.
//
// Design (the structure of mlp_tp_pair_bf16.cu with the products of
// nerf_mlp_mma.cuh). A CTA of 256 threads takes a tile of 64 points.
//  * x: the tile's rows copied once into shared memory by cp.async,
//    point-major with row stride Kp + 4 (Kp: K rounded up to 32, the
//    padding columns zero); 16-byte copies where K % 4 == 0 and x is 16-byte
//    aligned, else 4-byte copies (K = 63: rows of 252 bytes).
//  * The hidden width in chunks of SC = 32 channels:
//    act(x Wa + ba) Wb = sum over chunks c of act(x Wa[:, c] + ba[c]) Wb[c, :].
//    A chunk's Wa columns (Kp x 32, rows past K zero) and Wb rows (32 x O2)
//    are staged row-major in shared memory by cp.async, each in one buffer:
//    Wb[c] lands while the chunk's first product runs, Wa[c + 1] while its
//    second product runs. 156 KB at K = 256, O2 = 256: one CTA an SM.
//  * Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, every
//    operand split in registers into hi (rounded to TF32) and lo (the rest),
//    and lo * hi + hi * lo + hi * hi summed in float32, the small terms
//    first (nerf_mlp_mma.cuh's split_tf32 / mma_tf32). The fragments load as
//    scalars in the instruction's own k order from the row-major buffers;
//    row strides of 4 mod 32 words (activations, point-major) and of 8 mod
//    32 (weights) make every fragment load conflict-free.
//  * Sums in two levels, as in the chain: the products of 32 channels (four
//    k steps) sum in a tile of their own, started from zero, which joins the
//    running sum by a rounded float32 add (the tensor core cuts when it adds
//    into its accumulator; ROADMAP C).
//  * The first product: each warp one m-tile x two n-tiles of the chunk (64
//    points x 32 channels), its running sum started from the bias, a sum
//    group's lo * hi, hi * lo and hi * hi products in three tiles of their
//    own (six chains of dependent products a warp, not two), joined as
//    (lo hi + hi lo) + hi hi. Its epilogue applies the activation and stores
//    the hidden chunk split once: hi and lo in two float32 buffers (64 x 32
//    each), which every warp of the second product reads without splitting
//    again.
//  * The second: each warp owns O2 / 8 output columns of all 64 points (4 x
//    O2 / 64 m16n8 tiles, 64 float32 accumulators a thread at O2 = 256),
//    summed over the chunks in registers, a chunk's 32 channels in a tile of
//    their own, and stored straight from the fragments as 8-byte stores, a
//    warp filling whole 32-byte sectors.
//  * Reruns are bit-equal: no atomics, a fixed order of accumulation.
// The ragged last tile is masked here; N is not padded on the host.
//
// Prediction (before the first run on the card; PERF.md): at M = 4,
// K 256, S 64, O2 256, 768 products a warp a tile at the chain's ~8 clocks
// each, plus the x tile's load, which no product hides (~4,600 clocks at a
// 132nd of 3.35 TB/s): 0.28-0.35 ms against the SIMT kernel's 1.292 and
// cuBLAS's 0.569; its error against the exact plain version ~2-5e-6 x
// max |ref|.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.44-0.46 ms at
// that shape (cuBLAS 0.56), 3.4e-6 from the exact plain version (5.4e-7 of
// max |ref|), 2.4e-6 from fused_pair_3xtf32_plain; faster than cuBLAS at
// every pair shape but K 256 / O2 128 (0.38 against 0.37). What holds it
// (clock marks, nnc_tpu_torch/tools/mma_probe.py section 9): the first
// product, ~40% of a tile at ~14 clocks a product a sub-partition, its warps
// splitting 8 operands for 6 products; the x tile's copies and their wait
// ~20%. Tried and dropped: x split once into hi and lo in shared memory
// with 16-byte A loads and two m-tiles a warp (0.60 ms: twice the
// shared-memory traffic of the first product), a persistent kernel that
// brings the next tile's x in by bulk copies (0.47 ms at K 256).
// Before: nerf_mlp.cuh's SIMT layer of float32 FMAs (__ldg weights at every
// k step), 1.292 ms at that shape (PERF.md).
#include "nerf_mlp_mma.cuh"

namespace {

using nerf::kThreads;
using nerf::mma::cp_async16;
using nerf::mma::cp_async_commit;
using nerf::mma::cp_async_wait;
using nerf::mma::mma_tf32;
using nerf::mma::mma_tf32_first;
using nerf::mma::split_tf32;

constexpr int kTile = 64;     // points a CTA
constexpr int kSC = 32;       // hidden channels a chunk (one sum group)
constexpr int kLdWa = kSC + 8;    // row strides, in floats
constexpr int kLdH = kSC + 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Offsets (floats) into the dynamic shared memory for depth K and width O2.
struct Layout {
  int kp, ld_x, x, wa, wb, hh, hl, floats;
  __host__ __device__ Layout(int K, int O2) {
    kp = (K + kSC - 1) / kSC * kSC;
    ld_x = kp + 4;
    x = 0;
    wa = x + kTile * ld_x;
    wb = wa + kp * kLdWa;
    hh = wb + kSC * (O2 + 8);
    hl = hh + kTile * kLdH;
    floats = hl + kTile * kLdH;
  }
};

template <int S, int O2, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tp_pair_kernel(const float* __restrict__ x, int K,
                   const float* __restrict__ wa, const float* __restrict__ ba,
                   const float* __restrict__ wb, float* __restrict__ out,
                   int n) {
  constexpr int kChunks = S / kSC;
  constexpr int kLdWb = O2 + 8;
  constexpr int NT2 = O2 / 64;   // second product: n-tiles a warp
  static_assert(S % kSC == 0 && O2 % 64 == 0, "tiling");
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, O2);
  float* xs = smem + L.x;
  float* wsa = smem + L.wa;
  float* wsb = smem + L.wb;
  float* hh = smem + L.hh;
  float* hl = smem + L.hl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = n - base < kTile ? static_cast<int>(n - base) : kTile;
  nerf::mma::prof_begin();

  auto stage_a = [&](int c) {   // Wa[:, c SC .. + SC) -> wsa
    for (int i = tid; i < K * (kSC / 4); i += kThreads) {
      const int r = i / (kSC / 4);
      const int q = i - r * (kSC / 4);
      cp_async16(wsa + r * kLdWa + 4 * q,
                 wa + static_cast<size_t>(r) * S + c * kSC + 4 * q);
    }
    cp_async_commit();
  };
  auto stage_b = [&](int c) {   // Wb[c SC .. + SC, :] -> wsb
    for (int i = tid; i < kSC * (O2 / 4); i += kThreads) {
      const int r = i / (O2 / 4);
      const int q = i - r * (O2 / 4);
      cp_async16(wsb + r * kLdWb + 4 * q,
                 wb + static_cast<size_t>(c * kSC + r) * O2 + 4 * q);
    }
    cp_async_commit();
  };

  // the tile of x, its padding columns, and the zero rows of Wa past K
  const float* xt = x + base * K;
  if (K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int kv = K / 4;
    for (int i = tid; i < kTile * kv; i += kThreads) {
      const int r = i / kv;
      float* d = xs + r * L.ld_x + 4 * (i - r * kv);
      if (r < rows)
        cp_async16(d, xt + 4 * i);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < kTile * K; i += kThreads) {
      const int r = i / K;
      float* d = xs + r * L.ld_x + (i - r * K);
      if (r < rows)
        cp_async4(d, xt + i);
      else
        *d = 0.f;
    }
  }
  const int pad = L.kp - K;
  for (int i = tid; i < kTile * pad; i += kThreads)
    xs[(i / pad) * L.ld_x + K + i % pad] = 0.f;
  for (int i = tid; i < pad * kSC; i += kThreads)
    wsa[(K + i / kSC) * kLdWa + i % kSC] = 0.f;
  stage_a(0);   // one group: x and Wa[0]
  NNC_PROF(0);

  float acc[4][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // first product: m-tile m1, n-tiles n1 and n1 + 8 of the chunk
  const int m1 = warp >> 1;
  const int n1 = 16 * (warp & 1);
  const float* xa = xs + (16 * m1 + g) * L.ld_x + t;
  const float* wab = wsa + t * kLdWa + n1 + g;
  // second product: this warp's output columns n2 .. n2 + O2 / 8
  const int n2 = warp * (O2 / 8);
  const float* hha = hh + g * kLdH + t;
  const float* hla = hl + g * kLdH + t;
  const float* wbb = wsb + t * kLdWb + n2 + g;

#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    stage_b(c);
    cp_async_wait<1>();   // x and Wa[c] (this thread's copies)
    __syncthreads();
    NNC_PROF(1);

    // h = act(x Wa[:, c] + ba[c]) -> hh, hl (split once)
    {
      float h[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float b0 = __ldg(ba + c * kSC + n1 + 8 * nt + 2 * t);
        const float b1 = __ldg(ba + c * kSC + n1 + 8 * nt + 2 * t + 1);
        h[nt][0] = b0;
        h[nt][1] = b1;
        h[nt][2] = b0;
        h[nt][3] = b1;
      }
#pragma unroll 1
      for (int k0 = 0; k0 < L.kp; k0 += kSC) {
        // the group's three kinds of product in three tiles: six chains of
        // dependent products a warp instead of two
        float pa[2][4], pb[2][4], pc[2][4];
#pragma unroll
        for (int ks = 0; ks < kSC / 8; ++ks) {
          const int k = k0 + 8 * ks;
          uint32_t ah[4], al[4];
          split_tf32(xa[k], ah[0], al[0]);
          split_tf32(xa[8 * L.ld_x + k], ah[1], al[1]);
          split_tf32(xa[k + 4], ah[2], al[2]);
          split_tf32(xa[8 * L.ld_x + k + 4], ah[3], al[3]);
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            split_tf32(wab[k * kLdWa + 8 * nt], bh[nt][0], bl[nt][0]);
            split_tf32(wab[(k + 4) * kLdWa + 8 * nt], bh[nt][1], bl[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (ks == 0) {
              mma_tf32_first(pa[nt], al, bh[nt]);
              mma_tf32_first(pb[nt], ah, bl[nt]);
              mma_tf32_first(pc[nt], ah, bh[nt]);
            } else {
              mma_tf32(pa[nt], al, bh[nt]);
              mma_tf32(pb[nt], ah, bl[nt]);
              mma_tf32(pc[nt], ah, bh[nt]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            h[nt][i] += (pa[nt][i] + pb[nt][i]) + pc[nt][i];
      }
      NNC_PROF(2);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(RELU ? fmaxf(h[nt][i], 0.f) : h[nt][i], hi[i], lo[i]);
        const int o = (16 * m1 + g) * kLdH + n1 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(hh + o) =
            make_float2(__uint_as_float(hi[0]), __uint_as_float(hi[1]));
        *reinterpret_cast<float2*>(hh + o + 8 * kLdH) =
            make_float2(__uint_as_float(hi[2]), __uint_as_float(hi[3]));
        *reinterpret_cast<float2*>(hl + o) =
            make_float2(__uint_as_float(lo[0]), __uint_as_float(lo[1]));
        *reinterpret_cast<float2*>(hl + o + 8 * kLdH) =
            make_float2(__uint_as_float(lo[2]), __uint_as_float(lo[3]));
      }
    }
    NNC_PROF(3);
    cp_async_wait<0>();   // Wb[c]
    __syncthreads();
    NNC_PROF(4);
    if (c + 1 < kChunks) stage_a(c + 1);   // Wa is free: lands during the
                                           // second product

    // acc += h Wb[c, :], the chunk's 32 channels in a tile of their own
    {
      float part[4][NT2][4];
#pragma unroll
      for (int ks = 0; ks < kSC / 8; ++ks) {
        const int k = 8 * ks;
        uint32_t bh[NT2][2], bl[NT2][2];
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          split_tf32(wbb[k * kLdWb + 8 * nt], bh[nt][0], bl[nt][0]);
          split_tf32(wbb[(k + 4) * kLdWb + 8 * nt], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int o = 16 * mt * kLdH + k;
          const uint32_t ah[4] = {
              __float_as_uint(hha[o]), __float_as_uint(hha[o + 8 * kLdH]),
              __float_as_uint(hha[o + 4]),
              __float_as_uint(hha[o + 8 * kLdH + 4])};
          const uint32_t al[4] = {
              __float_as_uint(hla[o]), __float_as_uint(hla[o + 8 * kLdH]),
              __float_as_uint(hla[o + 4]),
              __float_as_uint(hla[o + 8 * kLdH + 4])};
#pragma unroll
          for (int nt = 0; nt < NT2; ++nt) {
            if (ks == 0)
              mma_tf32_first(part[mt][nt], al, bh[nt]);
            else
              mma_tf32(part[mt][nt], al, bh[nt]);
            mma_tf32(part[mt][nt], ah, bl[nt]);
            mma_tf32(part[mt][nt], ah, bh[nt]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    }
    NNC_PROF(5);
    if (c + 1 < kChunks) __syncthreads();   // hh, hl and Wb are free
    NNC_PROF(6);
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
      const int col = n2 + 8 * nt + 2 * t;
      if (r < rows)
        *reinterpret_cast<float2*>(out + (base + r) * O2 + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(out + (base + r + 8) * O2 + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  NNC_PROF(7);
  nerf::mma::prof_end();
}

template <int S, int O2, bool RELU>
int launch(const float* x, int k, const float* wa, const float* ba,
           const float* wb, float* out, int n, cudaStream_t stream) {
  const int smem = Layout(k, O2).floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tp_pair_kernel<S, O2, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int grid = (n + kTile - 1) / kTile;
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

#ifdef NNC_MMA_PROFILE
// Where a tile's clocks go (thread 0 of every CTA, nnc_tpu_torch/tools/
// mma_probe.py section 9): reads the sums of the launches so far and zeroes
// them.
extern "C" int nnc_mma_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// x: (n, k); wa: (k, s); ba: (s,); wb: (s, o2); out: (n, o2), all contiguous
// float32, wa and wb 16-byte aligned. Compiled shapes: 1 <= k <= 256; s in
// {32, 64, 128, 256}; (o2, relu_mid) = (256, 1) or (128, 0). Any other
// returns cudaErrorInvalidValue.
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
