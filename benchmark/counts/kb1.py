"""K-B1, the training MLP pair (forward, backward without dW) of an LSA
step: its operations and the bytes it has to move, for the points of a
window; and the names of its device kernels."""
from benchmark.counts import model

KERNELS = ("mlp_train_fwd", "mlp_train_bwd")

# a point's bytes that the pair reads or writes once, float32: the forward
# reads the point and its view direction (6 floats) and writes raw (4);
# the backward reads both again with raw's gradient (4) and writes nothing
# a point (the scales' gradients are per channel). Activations kept for the
# backward are the design's, not the algorithm's, and do not count.
BYTES_A_POINT = 4 * (6 + 4 + 6 + 4)


def operations(net: dict, points: int) -> int:
    return points * model.train_flops(net)


def bytes_moved(net: dict, points: int) -> int:
    return points * BYTES_A_POINT
