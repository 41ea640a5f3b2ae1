"""Operations of the NeRF MLP a point, from the configuration's widths:
the multiply-adds of its forward pass, and of the backward pass that LSA
takes (the inputs' gradients of every layer fed by another layer, no
weight gradient: the skip's and the view branch's encodings and the first
layer's input need none)."""
from benchmark.scene import layer_dims


def forward_macs(net: dict) -> int:
    """Multiply-adds a point of one forward pass."""
    return sum(i * o for i, o in layer_dims(net).values())


def backward_macs(net: dict) -> int:
    """Multiply-adds a point of the backward pass without weight gradients:
    only the rows of each layer's input that another layer produced."""
    in_pts = 3 + 3 * 2 * net["multires"]
    in_views = 3 + 3 * 2 * net["multires_views"]
    total = 0
    for name, (i, o) in layer_dims(net).items():
        if name == "pts_linears.0":
            continue
        fed = i
        if name.startswith("pts_linears.") and \
                int(name.split(".")[1]) - 1 in net["skips"]:
            fed -= in_pts
        if name == "views_linears.0":
            fed -= in_views
        total += fed * o
    return total


def forward_flops(net: dict) -> int:
    return 2 * forward_macs(net)


def train_flops(net: dict) -> int:
    """FLOP a point of an LSA step: forward and backward."""
    return 2 * (forward_macs(net) + backward_macs(net))
