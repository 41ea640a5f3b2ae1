"""K-B2, the fused render pass (posenc, the MLP, compositing with early
termination): its operations and bytes for the points the rays need, and
the names of its device kernels (float32 and bf16 bodies)."""
from benchmark.counts import model

KERNELS = ("render_pass_kernel", "render_queue_kernel")

# a ray's float32 inputs: origin, direction, view direction, and a sample's
# z and dist; its outputs: rgb, acc, depth
RAY_BYTES = 4 * (9 + 5)
SAMPLE_BYTES = 4 * 2


def operations(net: dict, points: int) -> int:
    return points * model.forward_flops(net)


def bytes_moved(rays: int, samples: int) -> int:
    return rays * RAY_BYTES + samples * SAMPLE_BYTES
