// K-B3 in bf16: positional encoding + the NeRF MLP from raw points, operands
// rounded to bf16, sums and logits float32, every wide product a warpgroup
// product (wgmma) on the tensor cores.
//
// Replaces the Pallas kernel _kernel_pts / _fused_call_pts
// (nnc_tpu/ops/mlp_pallas.py:238, :280) as it runs when
// config.compute_dtype is bfloat16 (mlp_pallas.py:398: weights packed in
// bf16, _mlp_body on a bf16 embedding). The rounding points are those of
// nerf_mlp_bf16.cuh, all to nearest even: the embedding after sincosf in
// float32, relu(sum + bias) of every layer, `feature` (no relu), the view
// layer's output; biases, sums and logits float32.
//
// Bound on the H100: operations, 1.19 MFLOP a point against 24 bytes of
// input and 16 of output, at the tensor cores' dense bf16 peak of 989
// TFLOP/s (H100 SXM data sheet, 700 W): 262,144 points cannot take less than
// 0.316 ms. The mma.sync chain this kernel replaced (nerf_mlp_bf16.cuh,
// which K-B2 bf16 and K-B5 bf16 still run) took 0.907 ms: mma.sync bf16
// issues once every 6.0 clocks a sub-partition (PERF.md), which puts a floor
// of ~0.50 ms under any chain of it. wgmma m64n256k16 runs at 128 clocks an
// SM, 4,096 FLOP a clock, the card's full rate (mma_probe.py section 10: 936
// TFLOP/s over the card with two warpgroups a CTA; NVIDIA H100 80GB HBM3,
// 700 W).
//
// Design (nerf_mlp_wgmma.cuh holds the chain):
//  * Persistent CTAs of 256 threads, one an SM (mlp_from_points.cuh's
//    launch_persistent), walking tiles of 128 points. The two warpgroups
//    own 64 points each across the whole width of every layer: a 64 x 256
//    float32 accumulator (128 registers a thread; 64 for the view layer),
//    started from the bias. A layer is wgmma m64n256k16 over its depth / 16
//    k steps (the view layer m64n128k16), A and B both from shared memory.
//  * A warpgroup reads and writes only its own 64 rows of activations, so
//    nothing in the chain waits at a CTA-wide barrier: a layer's epilogue
//    syncs the warpgroup alone (bar.sync 1 + group, 128) after
//    wgmma.wait_group 0, and again after its stores. The two groups drift
//    apart, and one's epilogue runs while the other's products run.
//  * A from shared memory: a group's activations (64 x 256 bf16, 32 KB) and
//    its embedding block (64 x 64 bf16, 8 KB), K-major with the 128-byte
//    swizzle. The block holds posenc(x) (63 channels + 1 zero) until the
//    skip layer has read it, then posenc(d) (27 + 5 zero), written in the
//    skip layer's epilogue, for the view layer. The epilogue writes
//    bf16(relu(d)) from the fragments (warp w: rows 16 w + g and 16 w + g +
//    8, columns 8 j + 2 t, + 1) through the swizzle (4-byte stores,
//    conflict-free: the eight rows g of a store put chunk j ^ g in eight
//    bank groups), then fence.proxy.async.shared::cta, because the generic
//    proxy wrote what the async proxy reads next. The skip layer takes one
//    slab on posenc(x), then four on h; the view layer two on `feature` (128
//    depth rows each) and one on posenc(d).
//  * The embedding: each warp encodes its own 16 points; a lane holds three
//    of their 96 coordinates, loaded a tile ahead, and each item takes its
//    coordinate by __shfl_sync from the lane that holds it.
//  * B from shared memory, pre-swizzled: mlp_fused.repack_bf16_wgmma lays
//    each of the 37 slabs out as the exact image a descriptor reads (64
//    depth rows x 256 channels, or 128 x 128 for the view layer; 32 KB),
//    made once per model and cached (PACKS, "bf16_wgmma"). Each slab lands
//    with one 1-D cp.async.bulk, no tensor map, in slab_ring.cuh's ring of
//    four stages: a full mbarrier a stage, and a count of the warps done
//    with it; all eight warps acquire and release every slab, and the last
//    to release a stage refills it. A warpgroup commits a slab's products
//    as one group, then waits for the slab before it (wgmma.wait_group 1)
//    and releases that one: two slabs held at most, and a group may run
//    up to three slabs ahead of the other.
//  * Producer: none of its own. The refill is one elected thread's
//    expect_tx and bulk copy, issued by whichever warp releases a stage
//    last, as in K-B4 and K-B1 bf16. A third warpgroup would take 128
//    threads' registers (setmaxnreg 40) to issue 37 copies a tile and cap
//    the consumers at 232 registers; with 256 threads each may have 255.
//  * Heads from the fragments: alpha (256 -> 1) in pts_linears.7's epilogue
//    on the rounded h, rgb (128 -> 3) on the view layer's rounded output;
//    the four lanes of a row hold all its columns, and two __shfl_xor over t
//    finish the sums in a fixed order. Reruns are bit-equal (no atomics).
//  * The sums run in another order than the mma.sync chain's, so raw is not
//    bit-equal to it; it is held to the plain bf16 version in units of the
//    bf16-to-float32 distance (chip_smoke.py phase 14).
//
// Shared memory (worked out before the code, then as built): the ring 4 x
// 32 KB = 128 KB and its barriers and counts (48 bytes), activations 2 x 32
// KB, embeddings 2 x 8 KB, pack_weights_bf16's tail (biases, heads; 12,544
// bytes, copied once a CTA): 227,328 bytes with the 1,024-byte alignment
// of each operand (nerf_mlp_wgmma.cuh's Smem) of the 232,448 a block may
// have, one CTA an SM. The first design gave posenc(d) a block of its own
// (8 KB a group) and read the biases from device memory; the block went to
// the tail. The logits leave from the heads' registers.
//
// L2, the risk: a tile reads all 37 slabs, 1,212,416 bytes, 9.5 KB a point:
// 2.48 GB from L2 for 262,144 points. At 0.45 ms that would be 5.5 TB/s.
//
// Predicted before the first run (step 0 of the design: mma_probe.py
// section 5 on the mma.sync kernel, a 128-point tile 115,779 clocks,
// products 71.2%, epilogue stores 8.3%, embedding 6.5%, heads 7.6%; section
// 10, wgmma at 128 clocks a product): a tile's products take 37,120 clocks
// of the SM's tensor cores; each group adds ~20,000 clocks of its own
// (embedding ~7,500, ten epilogues ~10,000, heads and barriers), which the
// other group's products hide in part: ~45,000-50,000 clocks a tile, 16
// tiles an SM, 0.43-0.48 ms at ~1.7 GHz, unless L2 holds it back (6 TB/s
// would be needed at that pace): 0.45-0.55 ms against 0.907, 57-70% of the
// bound, with the full-barrier waits 5-20% of a tile. Raw within the
// bf16-to-float32 distance's bars at every size, reruns bit-equal.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/mma_probe.py sections 5
// and 11, tools/kernel_compare.py, chip_smoke.py phase 14):
//  * First run (the coordinates read by each item, the biases from device
//    memory): 0.600-0.608 ms, 238 registers, no spills; raw at 0.057 /
//    0.53 of the bf16-to-float32 distance (rms / max), reruns bit-equal. A
//    tile 76,643 clocks by warpgroup 0's marks: embedding 18.0%, bias loads
//    and full-barrier waits 17.6%, products issued 15.0%, wait_group 29.6%,
//    epilogue 12.0%, barriers 5.1%, heads 2.6%.
//  * As shipped (coordinates a tile ahead, passed round by shuffles; biases
//    and heads in shared memory; posenc(d) into the posenc(x) block): 228
//    registers; 0.553-0.561 ms; a tile 69,229 clocks: embedding 17.6%,
//    full-barrier waits 11.1%, products issued 15.7%, wait_group 28.6%,
//    epilogue 11.6%, the bias into the accumulators 7.6%, barriers 5.3%,
//    heads 2.5%. Parent and change in one call (kernel_compare.py, two
//    repeats each): 0.910 / 0.906 and 0.902 / 0.902 ms on the mma.sync
//    chain against 0.560 / 0.560 and 0.561 / 0.560.
//  * L2 (mma_probe.py section 11): the kernel 0.5494-0.5513 ms in turns with
//    a build whose ring copies no slab after its first four (raw wrong),
//    0.5462-0.5473; waiting for a slab 7,712 clocks a tile against 8,226.
//    The full-barrier waits (11%) are one warpgroup waiting for the other
//    to release a stage, not the bytes from L2, so a cluster of two with
//    multicast slabs, which would halve those bytes, was not built.
//  * Tried and slower than the shipped design, each in one call with it
//    (throwaway builds, not kept): A from registers (the epilogue's
//    fragments as the next layer's A: no activation stores and no barriers,
//    but wgmma with A in registers holds its warp at the issue); the
//    accumulators started at zero and the bias added in the epilogue; three
//    stages; the biases laid out for 16-byte loads (four lanes 256 bytes
//    apart: one bank); the next tile's posenc(x) built in a second
//    embedding block, in the products' shadow (255 registers, spills) or in
//    the epilogues; the embedding loop unrolled.
//  * The prediction (0.45-0.55 ms) missed by a little: each warpgroup's own
//    serial work (embedding, epilogues, barriers, bias) is ~38,000 clocks a
//    tile against ~18,500 of products, and the ring (one layer of slabs)
//    lets one group lead the other by three slabs only, so that while one
//    embeds, the other's products stop after three slabs.
#include "mlp_from_points.cuh"
#include "nerf_mlp_wgmma.cuh"

namespace {

using nerf::wg::Smem;

// P: pack_weights_bf16's buffer (its tail: biases, heads); W: the slabs of
// repack_bf16_wgmma. Tiles of 128 points, tile = blockIdx.x, + gridDim.x...
__global__ void __launch_bounds__(nerf::kThreads, 1)
mlp_from_points_bf16_kernel(const float* __restrict__ P,
                            const float* __restrict__ W,
                            const float* __restrict__ pts,
                            const float* __restrict__ dirs,
                            float* __restrict__ out, int n, int tiles) {
  namespace wg = nerf::wg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  if (wg::smem_u32(smem_raw) % 1024) __trap();
  const int group = threadIdx.x >> 7;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  nerf::mma::prof_begin();
  wg::Ring ring{&s.ring, W, mine * wg::kSlabs, 0};
  if (threadIdx.x == 0) ring.start();
  for (int i = threadIdx.x; i < wg::kTail; i += nerf::kThreads)
    s.tail[i] = __ldg(P + nerf::bf16::kOffBias + i);
  __syncthreads();
  // a tile's coordinates (c), and the next tile's (cn), loaded while the
  // tile runs: a warp's 16 points, three values a lane
  float c[3], cn[3] = {0.f, 0.f, 0.f};
  const long long first = group * wg::kGroupPoints;
  const long long stride = gridDim.x * static_cast<long long>(wg::kPoints);
  wg::load_coords(c, pts, dirs, blockIdx.x * static_cast<long long>(
                                    wg::kPoints) + first, n);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * wg::kPoints + first;
    wg::embed_pts(s.emb[group], c, group);
    if (tile + static_cast<int>(gridDim.x) < tiles)
      wg::load_coords(cn, pts, dirs, base + stride, n);
    wg::mlp(s, ring, group, c, out, base, n);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = cn[k];
  }
  nerf::mma::prof_end();
}

}  // namespace

#ifdef NNC_MMA_PROFILE
extern "C" int nnc_mma_profile(unsigned long long* out) {
  return nerf::mma::read_profile(out);
}
#endif

// Length of repack_bf16_wgmma's buffer, in 32-bit words.
extern "C" int nnc_bf16_wgmma_size() {
  return nerf::wg::kSlabs * nerf::ring::kSlabFloats;
}

// params: the buffer of pack_weights_bf16; wg: its slabs as
// repack_bf16_wgmma lays them out, 16-byte aligned; pts, dirs: (n, 3); out:
// (n, 4) [rgb logits, sigma].
extern "C" int nnc_mlp_from_points_bf16(const float* params, const void* wg,
                                        const float* pts, const float* dirs,
                                        float* out, int n, void* stream) {
  return nerf::launch_persistent<nerf::wg::kPoints>(
      mlp_from_points_bf16_kernel, static_cast<int>(sizeof(Smem)), n, stream,
      params, static_cast<const float*>(wg), pts, dirs, out);
}
