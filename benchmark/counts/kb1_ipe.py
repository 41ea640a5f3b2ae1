"""K-B1's IPE instantiation (mip-NeRF), the training MLP pair of an LSA
step on frusta: its operations and the bytes it has to move, for the
points of a window; and the names of its device kernels.

A point's forward is mip-NeRF's MLP: 610,304 multiply-adds (96 x 256 of
the first layer, 4 x 256 x 256, 352 x 256 of the skip layer, 2 x 256 x
256, the density's 256, the bottleneck's 256 x 256, the view layer's 283
x 128, the rgb layer's 128 x 3). Its backward without weight gradients
takes the inputs' gradients of the layers fed by other layers: every
layer's rows but the encodings' (the first layer's 96, the skip layer's 96
and the view layer's 27): 557,696."""
from benchmark.drivers.lsa_mip import dense_dims

KERNELS = ("mlp_train_fwd_ipe", "mlp_train_bwd")

# a point's bytes that the pair reads or writes once, float32: the forward
# reads the frustum (mean and variance, 6 floats) and its view direction
# (3) and writes raw (4); the backward reads them again with raw's gradient
# (4). The kept activations are the design's, not the algorithm's.
BYTES_A_POINT = 4 * (9 + 4 + 9 + 4)


def forward_macs(net: dict) -> int:
    return sum(i * o for i, o in dense_dims(net).values())


def backward_macs(net: dict) -> int:
    ipe = 2 * 3 * (net["max_deg_point"] - net["min_deg_point"])
    views = 3 + 2 * 3 * net["deg_view"]
    dims = dense_dims(net)
    skip = f"Dense_{net['skip_layer'] + 1}"
    view = f"Dense_{net['net_depth'] + 2}"
    total = 0
    for name, (i, o) in dims.items():
        if name == "Dense_0":
            continue
        fed = i - (ipe if name == skip else views if name == view else 0)
        total += fed * o
    return total


def train_flops(net: dict) -> int:
    """FLOP a point of an LSA step: forward and backward."""
    return 2 * (forward_macs(net) + backward_macs(net))


def operations(net: dict, points: int) -> int:
    return points * train_flops(net)


def bytes_moved(net: dict, points: int) -> int:
    return points * BYTES_A_POINT
