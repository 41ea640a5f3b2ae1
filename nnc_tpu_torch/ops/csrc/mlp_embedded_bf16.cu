// K-B5 in bf16: the NeRF MLP on embeddings computed outside the kernel,
// operands rounded to bf16, sums and logits float32.
//
// Replaces the Pallas kernel _kernel / _fused_call
// (nnc_tpu/ops/mlp_pallas.py:191, :248) as it runs when config.compute_dtype
// is bfloat16 (mlp_pallas.py:425-444: the embeddings cast to bf16 at
// :430-431, the weights packed in bf16, _mlp_body on the bf16 embedding).
//
// Bound on the H100: operations, 1.19 MFLOP a point against 376 bytes (the
// float32 embeddings in, the raw logits out), at the tensor cores' dense bf16
// peak of 989 TFLOP/s (H100 SXM data sheet, 700 W): 262,144 points cannot
// take less than 0.316 ms; their bytes alone take 0.03 ms.
//
// Design: K-B3 bf16 (mlp_from_points_bf16.cu) with another input stage. The
// persistent kernel of mlp_from_points.cuh (mlp_embedded_kernel) walks tiles
// of 16 NNC_BF16_MT points (128) over the chain of nerf_mlp_bf16.cuh, the
// weights streamed through nerf_mlp_mma.cuh's cp.async ring from the buffer of
// pack_weights_bf16 (the one K-B3 bf16 reads). In place of Chain::embed's
// sincosf, load_embedded_tile reads the tile's float32 embeddings with
// coalesced 4-byte loads (rows of 252 and 108 bytes are not 16-byte aligned)
// and rounds each once to bf16 into s.emb, pts at channels 0..62 and views
// at 64..90; channels 63 and 91..95 stay the zeros that Chain::begin wrote.
// The TPU kernel's (N, 128) packed input is not carried over. The ragged
// last tile is masked here; N is not padded on the host. Reruns are
// bit-equal.
#include "mlp_from_points.cuh"
#include "nerf_mlp_bf16.cuh"

// pts_emb: (n, 63); views_emb: (n, 27); out: (n, 4) [rgb logits, sigma];
// params: the weights as pack_weights_bf16 lays them out.
extern "C" int nnc_mlp_embedded_bf16(const float* params,
                                     const float* pts_emb,
                                     const float* views_emb, float* out,
                                     int n, void* stream) {
  return nerf::launch_mlp_embedded<nerf::bf16::Chain<NNC_BF16_MT>>(
      params, pts_emb, views_emb, out, n, stream);
}
