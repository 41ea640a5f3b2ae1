// K-B5: the NeRF MLP on embeddings computed outside the kernel, float32.
//
// Replaces the Pallas kernel _kernel / _fused_call
// (nnc_tpu/ops/mlp_pallas.py:191, :248), reached through fused_nerf_mlp
// (mlp_pallas.py:416), the drop-in for nerf.apply_mlp on the flagship
// architecture: the renderer's route for a fused MLP whose positional
// encoding is made outside (renderer.py:96-106).
//
// Bound on the H100: operations, as for K-B3 (mlp_from_points.cu): 1.19
// MFLOP a point against 376 bytes (the float32 embeddings in, the raw
// logits out), every float32 product three TF32 products on the tensor
// cores, whose dense TF32 peak of 495 TFLOP/s (H100 SXM data sheet, 700 W)
// makes 165 TFLOP/s float32-equivalent: 262,144 points cannot take less
// than 1.89 ms; their bytes alone take 0.03 ms.
//
// Design: K-B3 with another input stage. The persistent kernel of
// mlp_from_points.cuh (mlp_embedded_kernel) walks tiles of 64 points over
// the 3xTF32 chain of nerf_mlp_mma.cuh, the weights streamed through its
// cp.async ring from the buffer of pack_weights_mma (the one K-B3 reads). In
// place of Chain::embed's sincosf, load_embedded_tile reads the tile's
// float32 embeddings with coalesced 4-byte loads (rows of 252 and 108 bytes
// are not 16-byte aligned) into s.emb, pts at channels 0..62 and views at
// 64..90; channels 63 and 91..95 stay the zeros that Chain::begin wrote.
// The TPU kernel's (N, 128) packed input is not carried over. The ragged
// last tile is masked here; N is not padded on the host. Reruns are
// bit-equal. Before, K-B5 ran a SIMT chain of float32 FMAs (one
// non-persistent CTA a tile, weights re-read through L1/L2 at every k step):
// 14.1 ms at 262,144 points (PERF.md).
#include "mlp_from_points.cuh"

// pts_emb: (n, 63); views_emb: (n, 27); out: (n, 4) [rgb logits, sigma];
// params: the weights as pack_weights_mma lays them out, 16-byte aligned.
extern "C" int nnc_mlp_embedded(const float* params, const float* pts_emb,
                                const float* views_emb, float* out, int n,
                                void* stream) {
  return nerf::launch_mlp_embedded<nerf::mma::Chain>(params, pts_emb,
                                                     views_emb, out, n,
                                                     stream);
}
