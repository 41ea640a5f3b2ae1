"""Posenc + NeRF MLP from raw points: kernel K-B3 and its plain version.

Counterpart of ``fused_nerf_mlp_from_points`` in ``nnc_tpu/ops/mlp_pallas.py``.
Only the flagship architecture (D=8, W=256, skip=(4,), viewdirs, 63/27
posenc) has a kernel; :func:`fused_nerf_mlp_from_points` runs the plain MLP
for any other, as the reference does (mlp_pallas.py:391-395).

The kernel (``csrc/mlp_from_points.cu``) reads the weights packed by
:func:`pack_weights`: one float32 buffer, layers in ``nerf.layer_names``
order, each W in (in, out) row-major then its bias, padded to a multiple of
64 floats, with LSA scales folded in. The plain version reads the same
buffer, so the CPU tests check the layout the kernel reads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import nerf
from . import _build
from .posenc import positional_encoding

FLAGSHIP = nerf.NeRFConfig()
_SEG = 64            # layer segments are padded to a multiple of 64 floats
PLAIN_CHUNK = 1 << 18  # points per plain-version MLP call (bounds memory)


def supports(config: nerf.NeRFConfig) -> bool:
    return (config.D == 8 and config.W == 256 and config.skips == (4,)
            and config.use_viewdirs and config.input_ch == 63
            and config.input_ch_views == 27)


def _segments(config: nerf.NeRFConfig):
    """[(name, din, dout, offset)] of the packed buffer, and its size."""
    out, off = [], 0
    for name, (din, dout) in nerf._layer_dims(config).items():
        out.append((name, din, dout, off))
        off += -(-(din * dout + dout) // _SEG) * _SEG
    return out, off


PARAMS_SIZE = _segments(FLAGSHIP)[1]


def pack_weights(model: nerf.NeRF) -> torch.Tensor:
    """The flagship model's weights as the kernels read them (LSA folded)."""
    if not supports(model.config):
        raise ValueError(f"no fused kernel for {model.config}")
    segs, size = _segments(model.config)
    ends = [off for *_, off in segs[1:]] + [size]
    parts = []
    with torch.no_grad():
        for layer, end, (_name, _din, _dout, off) in zip(
                model.layers().values(), ends, segs):
            w = layer.effective_weight().t().reshape(-1).float()
            b = layer.bias.float()
            parts += [w, b, w.new_zeros(end - off - w.numel() - b.numel())]
        return torch.cat(parts)


def unpack_weights(packed: torch.Tensor):
    """{layer name: (w (in, out), b (out,))} views into a packed buffer."""
    segs, size = _segments(FLAGSHIP)
    if packed.shape != (size,):
        raise ValueError(f"packed weights must have shape ({size},), "
                         f"got {tuple(packed.shape)}")
    return {name: (packed[off:off + din * dout].view(din, dout),
                   packed[off + din * dout:off + din * dout + dout])
            for name, din, dout, off in segs}


def _mlp_packed(L, pe, ve):
    """The flagship MLP on embedded points, weights from unpack_weights."""
    h = pe
    for i in range(8):
        w, b = L[f"pts_linears.{i}"]
        h = F.relu(torch.addmm(b, h, w))
        if i == 4:
            h = torch.cat([pe, h], dim=-1)
    alpha = torch.addmm(L["alpha_linear"][1], h, L["alpha_linear"][0])
    feature = torch.addmm(L["feature_linear"][1], h, L["feature_linear"][0])
    w, b = L["views_linears.0"]
    h = F.relu(torch.addmm(b, torch.cat([feature, ve], dim=-1), w))
    rgb = torch.addmm(L["rgb_linear"][1], h, L["rgb_linear"][0])
    return torch.cat([rgb, alpha], dim=-1)


def fused_nerf_mlp_from_points_plain(packed, pts, dirs):
    """Plain PyTorch version of K-B3: pts, dirs (N, 3) -> raw (N, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L = unpack_weights(packed)
    outs = []
    for start in range(0, pts.shape[0], PLAIN_CHUNK):
        p = pts[start:start + PLAIN_CHUNK]
        d = dirs[start:start + PLAIN_CHUNK]
        outs.append(_mlp_packed(L, positional_encoding(p, 10),
                                positional_encoding(d, 4)))
    if not outs:
        return pts.new_zeros((0, 4))
    return torch.cat(outs)


def _check(name, t, shape):
    if t.dtype != torch.float32 or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected contiguous float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def mlp_from_points(packed, pts, dirs):
    """K-B3 wrapper: raw (N, 4) for points and view directions (N, 3).

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    n = pts.shape[0]
    _check("packed", packed, (PARAMS_SIZE,))
    _check("pts", pts, (n, 3))
    _check("dirs", dirs, (n, 3))
    if not (packed.device == pts.device == dirs.device):
        raise ValueError("packed, pts and dirs must be on one device")
    if pts.device.type == "cpu":
        return fused_nerf_mlp_from_points_plain(packed, pts, dirs)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    lib = _build.lib()
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("mlp_from_points")
        _build.check(lib.nnc_mlp_from_points(
            packed.data_ptr(), pts.data_ptr(), dirs.data_ptr(),
            out.data_ptr(), n, stream), "mlp_from_points")
    return out


def fused_nerf_mlp_from_points(model: nerf.NeRF, pts, viewdirs):
    """posenc + MLP from raw points. pts: (..., 3); viewdirs broadcastable
    to pts. Returns raw (..., 4) float32."""
    vd = torch.broadcast_to(viewdirs, pts.shape)
    if not supports(model.config):
        return nerf.apply_mlp(model, positional_encoding(pts, 10),
                              positional_encoding(vd, 4))
    lead = pts.shape[:-1]
    raw = mlp_from_points(pack_weights(model),
                          pts.reshape(-1, 3).float().contiguous(),
                          vd.reshape(-1, 3).float().contiguous())
    return raw.reshape(*lead, 4)
