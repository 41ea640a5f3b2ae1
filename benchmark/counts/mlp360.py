"""mip-NeRF 360's two MLPs in an LSA step: their operations forward and
backward, the bytes K-B7 has to move, and the names of the device kernels
that compute their layers.

A ray of a step runs the proposal MLP on 2 x 64 points and the NeRF MLP on
32. A point's forward is its MLP's multiply-adds: the proposal MLP's
325,888 (504 x 256, 3 x 256 x 256, the density's 256), the NeRF MLP's
8,672,000 (504 x 1024, 3 x 1024 x 1024, the skip layer's 1528 x 1024, 3 x
1024 x 1024, the density's and the bottleneck's 1024 x 257, the view
layer's 283 x 128, the rgb head's 128 x 3). The backward forms no weight
gradient: it takes the inputs' gradients of the layers fed by other
layers, every layer's rows but the encodings' (the first layer's 504, the
skip layer's 504, the view layer's 27).

K-B7 reads the product and writes the activation (8 bytes an element of a
layer's output) forward, and reads the output's gradient and the product
and writes the product's gradient (12 bytes; 8 for each MLP's first layer,
whose input needs no gradient) backward, float32, once; its column sums'
workspace, under 0.2% more, is left out.
"""

# the kernels of the two MLPs' layers: cuBLAS's float32 GEMMs (the xmma and
# CUTLASS SIMT sgemm kernels, a gemv for the narrow heads, a split-K
# reduction where cuBLAS takes one) and K-B7
GEMM_KERNELS = ("gemm", "gemv", "splitKreduce")
KB7_KERNELS = ("lsa_epilogue",)
# the port's float32 ceiling: a float32 product as three TF32 products
# (peaks.json's 495 TFLOP/s dense TF32 over 3), as the K-B1 rooflines read
PEAK_FLOPS = 495e12 / 3


def dims(net: dict, mlp: str) -> dict:
    """{layer: (in, out)} of the proposal ("prop") or NeRF ("nerf") MLP, in
    creation order."""
    enc = 2 * 21 * (net["max_deg_point"] - net["min_deg_point"])
    views = 3 + 6 * net["deg_view"]
    depth, width = net[mlp + "_depth"], net[mlp + "_width"]
    out, d_in = {}, enc
    for i in range(depth):
        out[f"trunk{i}"] = (d_in, width)
        skip = i % net["skip_layer"] == 0 and i > 0
        d_in = width + (enc if skip else 0)
    out["density"] = (d_in, 1)
    if mlp == "nerf":
        out["bottleneck"] = (d_in, net["bottleneck_width"])
        out["view"] = (net["bottleneck_width"] + views,
                       net["net_width_viewdirs"])
        out["rgb"] = (net["net_width_viewdirs"], 3)
    return out


def forward_macs(net: dict, mlp: str) -> int:
    return sum(i * o for i, o in dims(net, mlp).values())


def backward_macs(net: dict, mlp: str) -> int:
    enc = 2 * 21 * (net["max_deg_point"] - net["min_deg_point"])
    views = 3 + 6 * net["deg_view"]
    skip = f"trunk{net['skip_layer'] + 1}"
    total = 0
    for name, (i, o) in dims(net, mlp).items():
        if name == "trunk0":
            continue
        fed = i - (enc if name == skip else views if name == "view" else 0)
        total += fed * o
    return total


def points_a_ray(sampling: dict) -> dict:
    return {"prop": 2 * sampling["num_prop_samples"],
            "nerf": sampling["num_nerf_samples"]}


def step_flops(net: dict, sampling: dict, rays: int) -> int:
    """FLOP of both MLPs, forward and backward, in a step of ``rays``."""
    return sum(2 * rays * n * (forward_macs(net, mlp) + backward_macs(net, mlp))
               for mlp, n in points_a_ray(sampling).items())


def kb7_bytes(net: dict, sampling: dict, rays: int) -> int:
    """The bytes K-B7 moves in a step of ``rays``."""
    total = 0
    for mlp, n in points_a_ray(sampling).items():
        for name, (_i, o) in dims(net, mlp).items():
            back = 8 if name == "trunk0" else 12
            total += 4 * rays * n * o * (2 + back // 4)
    return total
