"""The inference NeRF MLP as one kernel per point tile: K-B3 (posenc + MLP
from raw points), K-B4 (the same in int8 x int8 -> int32 products) and K-B5
(the MLP on embeddings computed outside), each with its plain version.

Counterpart of ``nnc_tpu/ops/mlp_pallas.py`` (``fused_nerf_mlp_from_points``,
``fused_nerf_mlp_int8_from_points``, ``fused_nerf_mlp``). Only the flagship
architecture (D=8, W=256, skip=(4,), viewdirs, 63/27 posenc) has kernels; the
three entry points run the plain MLP for any other, as the reference does
(mlp_pallas.py:361-365, 391-395, 421-422).

Every float32 plain version reads the weights packed by
:func:`pack_weights`: one float32 buffer, layers in ``nerf.layer_names``
order, each W in (in, out) row-major then its bias, padded to a multiple of
64 floats, with LSA scales folded in. K-B3 (``csrc/mlp_from_points.cu``),
K-B5 (``csrc/mlp_embedded.cu``) and K-B2 (``csrc/render_pass.cu``) run
their products on the tensor cores as three TF32 products each
(``csrc/nerf_mlp_mma.cuh``) and read the same values in the order the
``mma.sync`` fragments want them, :func:`pack_weights_mma` /
:func:`repack_mma`; :func:`tf32_round`, :func:`matmul_3xtf32_plain` and
:func:`mlp_3xtf32_plain` model that arithmetic in plain PyTorch. The int8
kernel (``csrc/mlp_int8_from_points.cu``: ``mma.sync`` s8 products)
reads :func:`pack_weights_int8`'s values in fragment order,
:func:`pack_weights_int8_mma` / :func:`repack_int8_mma`. The plain versions
read :func:`pack_weights`' and :func:`pack_weights_int8`'s buffers, and
:func:`unpack_weights_mma` / :func:`unpack_weights_int8_mma` read the
fragment orders back, so the CPU tests check the layouts the kernels read.
A model with ``config.compute_dtype == torch.bfloat16`` takes
the bf16 variant of K-B3 (``csrc/mlp_from_points_bf16.cu`` on
``csrc/nerf_mlp_wgmma.cuh``: warpgroup ``wgmma`` bf16 products, float32
sums), which reads the biases and heads of :func:`pack_weights_bf16`'s buffer
and its slabs laid out as shared-memory images, :func:`repack_bf16_wgmma`;
its plain version is :func:`fused_nerf_mlp_from_points_bf16_plain`. Such a
model's K-B5 takes its bf16 variant (``csrc/mlp_embedded_bf16.cu``: the
``mma.sync`` bf16 chain of ``csrc/nerf_mlp_bf16.cuh``, which K-B2 bf16 runs
too, with the embedding loaded from device memory and rounded once), on
:func:`pack_weights_bf16`'s buffer; its plain version is
:func:`fused_nerf_mlp_bf16_plain`. K-B4
quantizes from the float32 weights whatever ``compute_dtype``, as the
reference's does.

Packing folds and copies every weight, so the model-level entry points take
their buffers from :data:`PACKS`, one cache for all of them (and for the
tensor-parallel entry, ``ops/mlp_tp_fused.py``).
"""
from __future__ import annotations

import weakref

import numpy as np
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

# K-B4 quantizes the activations that enter each product with one scale per
# block of this many consecutive points (the kernel's tile). The TPU kernel's
# block is its half tile of 1,024 points, zero rows of padding included
# (mlp_pallas.py:120, 315-319, 374-376); the block is the kernel's, not part
# of the function, and the plain version takes it as a parameter.
INT8_ACT_BLOCK = 64

# The 14 int8 weight blocks in the reference's order (mlp_pallas.py:328-329):
# (key, layer, first row, rows, out). The skip and the view layers are two
# blocks each, one per concatenated input.
INT8_BLOCKS = (
    ("w0", "pts_linears.0", 0, 63, 256),
    ("w1", "pts_linears.1", 0, 256, 256),
    ("w2", "pts_linears.2", 0, 256, 256),
    ("w3", "pts_linears.3", 0, 256, 256),
    ("w4", "pts_linears.4", 0, 256, 256),
    ("w5a", "pts_linears.5", 0, 63, 256),
    ("w5b", "pts_linears.5", 63, 256, 256),
    ("w6", "pts_linears.6", 0, 256, 256),
    ("w7", "pts_linears.7", 0, 256, 256),
    ("wf", "feature_linear", 0, 256, 256),
    ("wa", "alpha_linear", 0, 256, 1),
    ("wva", "views_linears.0", 0, 256, 128),
    ("wvb", "views_linears.0", 256, 27, 128),
    ("wr", "rgb_linear", 0, 128, 3),
)
# the 12 bias rows in the reference's order (mlp_pallas.py:330-331)
INT8_BIASES = tuple((f"b{i}", f"pts_linears.{i}", 256) for i in range(8)) + (
    ("bf", "feature_linear", 256), ("ba", "alpha_linear", 1),
    ("bv", "views_linears.0", 128), ("br", "rgb_linear", 3))
# bytes of the packed int8 weights: rows padded to a multiple of 4
INT8_WQ_SIZE = sum(-(-rows // 4) * 4 * out for *_, rows, out in INT8_BLOCKS)
INT8_SCALES_SIZE = sum(out for *_, out in INT8_BLOCKS)
INT8_BIASES_SIZE = sum(n for *_, n in INT8_BIASES)


class PackCache:
    """What a packing function made of a model, kept until the model changes.

    An entry belongs to a model (held weakly) and a ``kind`` (which packing),
    and stays valid while every weight, bias and LSA scale of the model is
    the same tensor object, at the same version (``Tensor._version``, which
    every in-place update bumps: an optimizer step, ``load_state_dict``,
    ``copy_``), on the same device and storage (``module.to`` swaps
    ``.data`` without a new version). The entry keeps those tensors alive,
    so no other tensor can take their place in memory unnoticed. The cached
    buffers are shared between calls: read them, never write them."""

    def __init__(self):
        self._entries = weakref.WeakKeyDictionary()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _state(model: nerf.NeRF):
        return [None if t is None
                else (t, t._version, t.device, t.data_ptr())
                for layer in model.layers().values()
                for t in (layer.weight, layer.bias, layer.weight_scaling)]

    @staticmethod
    def _same(a, b):
        return len(a) == len(b) and all(
            (x is None and y is None) or
            (x is not None and y is not None and x[0] is y[0]
             and x[1:] == y[1:]) for x, y in zip(a, b))

    def get(self, model: nerf.NeRF, kind, pack):
        """``pack(model)``, computed on a miss and remembered under
        ``kind`` (hashable)."""
        state = self._state(model)
        entries = self._entries.setdefault(model, {})
        entry = entries.get(kind)
        if entry is not None and self._same(entry[0], state):
            self.hits += 1
            return entry[1]
        self.misses += 1
        value = pack(model)
        entries[kind] = (state, value)
        return value


PACKS = PackCache()


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


def _mlp_packed(L, pe, ve, addmm=torch.addmm):
    """The flagship MLP (any width) on embedded points, weights from
    unpack_weights; ``addmm(b, x, w)`` computes the ten wide layers, the two
    small heads are always exact float32."""
    h = pe
    for i in range(8):
        w, b = L[f"pts_linears.{i}"]
        h = F.relu(addmm(b, h, w))
        if i == 4:
            h = torch.cat([pe, h], dim=-1)
    alpha = torch.addmm(L["alpha_linear"][1], h, L["alpha_linear"][0])
    feature = addmm(L["feature_linear"][1], h, L["feature_linear"][0])
    w, b = L["views_linears.0"]
    h = F.relu(addmm(b, torch.cat([feature, ve], dim=-1), w))
    rgb = torch.addmm(L["rgb_linear"][1], h, L["rgb_linear"][0])
    return torch.cat([rgb, alpha], dim=-1)


# --- the tensor-core chain of K-B3 / K-B5 / K-B2: its packing and arithmetic -
# csrc/nerf_mlp_mma.cuh. Eight warps each own 8 * NT output channels of a
# layer (NT n-tiles of mma.sync m16n8k8; NT = 4 for 256 outputs, 2 for the
# view layer's 128). Lane 4 g + t of warp w reads, for k step ks and n-tile
# nt, b0 = W[row(ks, t, 0), col] and b1 = W[row(ks, t, 1), col] with
# row(ks, t, r) = 16 (ks // 2) + 4 t + 2 (ks % 2) + r and
# col = 8 NT w + 8 nt + g: the channels of a k step are taken in the order in
# which one 16-byte load of the point-major activations delivers them. The
# buffer's order is [slab][warp][k step][n-tile pair][lane][nt % 2][r].
MMA_SLAB = 8192   # floats per slab of the weight ring (32 KB)
# (layer, first row, rows, rows padded to whole k steps with zeros) of each
# run of k steps, in the order the chain consumes them; every run starts on
# a slab boundary
MMA_RUNS = (
    [("pts_linears.0", 0, 63, 64)]
    + [(f"pts_linears.{i}", 0, 256, 256) for i in (1, 2, 3, 4)]
    + [("pts_linears.5", 0, 63, 64), ("pts_linears.5", 63, 256, 256)]
    + [(f"pts_linears.{i}", 0, 256, 256) for i in (6, 7)]
    + [("feature_linear", 0, 256, 256), ("views_linears.0", 0, 256, 256),
       ("views_linears.0", 256, 27, 32)])
# after the slabs: biases of the ten tensor-core layers, then the two heads
# (alpha w 256, b 1 + 3 pad; rgb w (128, 3) row-major, b 3 + 1 pad)
_MMA_BIASES = tuple(f"pts_linears.{i}" for i in range(8)) + (
    "feature_linear", "views_linears.0")


def fragment_index(base, ld, rows, padded, n_out, pad):
    """Where a run of k steps finds its values: for B (rows, n_out) stored
    row-major at ``base`` with row stride ``ld``, the index of every float of
    the run's slabs, in the order [slab][warp][k step of the slab][n-tile
    pair][lane][nt % 2][r]; ``pad`` for the zero rows rows..padded."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    nt_n = n_out // 64
    per_slab = 16 // nt_n             # k steps in a slab
    ks = np.arange(-(-padded // (8 * per_slab)) * per_slab)
    # [ks][warp][q][lane][nt2][r]; rows past the run are zero padding
    row = (16 * (ks // 2) + 2 * (ks % 2))[:, None, None, None, None, None] \
        + (4 * t)[None, None, None, :, None, None] \
        + np.arange(2)[None, None, None, None, None, :]
    col = (8 * nt_n * np.arange(8))[None, :, None, None, None, None] \
        + (16 * np.arange(nt_n // 2))[None, None, :, None, None, None] \
        + (8 * np.arange(2))[None, None, None, None, :, None] \
        + g[None, None, None, :, None, None]
    idx = np.where(row < rows, base + row * ld + col, pad)
    # -> [slab][warp][k step of the slab][q][lane][nt2][r]
    return idx.reshape(-1, per_slab, 8, nt_n // 2, 32, 2, 2) \
        .transpose(0, 2, 1, 3, 4, 5, 6).reshape(-1)


def _mma_index():
    """For every float of the fragment-ordered buffer, the index of its value
    in pack_weights' buffer, or PARAMS_SIZE where it is zero padding."""
    segs = {name: (din, dout, off) for name, din, dout, off
            in _segments(FLAGSHIP)[0]}
    parts = []
    for name, row0, rows, padded in MMA_RUNS:
        _din, dout, off = segs[name]
        parts.append(fragment_index(off + row0 * dout, dout, rows, padded,
                                    dout, PARAMS_SIZE))
    for name in _MMA_BIASES:
        din, dout, off = segs[name]
        parts.append(off + din * dout + np.arange(dout))
    for name in ("alpha_linear", "rgb_linear"):
        din, dout, off = segs[name]
        parts += [off + np.arange(din * dout + dout),
                  np.full(-dout % 4, PARAMS_SIZE)]
    idx = np.concatenate(parts)
    return np.concatenate([idx, np.full(-idx.size % _SEG, PARAMS_SIZE)]) \
        .astype(np.int64)


MMA_INDEX = _mma_index()
MMA_PARAMS_SIZE = MMA_INDEX.size
MMA_SLABS = 73    # 2.39 MB of the buffer; then 3,080 floats of biases, heads
_mma_index_on = {}   # device -> MMA_INDEX as a tensor there


def repack_mma(packed: torch.Tensor) -> torch.Tensor:
    """The buffer of :func:`pack_weights` in the order K-B3, K-B2 and K-B5
    read it (one gather; zero rows pad the depths 63 and 27 to whole k
    steps)."""
    _check("packed", packed, (PARAMS_SIZE,))
    index = _mma_index_on.get(packed.device)
    if index is None:
        index = _mma_index_on[packed.device] = \
            torch.from_numpy(MMA_INDEX).to(packed.device)
    return torch.cat([packed, packed.new_zeros(1)])[index]


def pack_weights_mma(model: nerf.NeRF) -> torch.Tensor:
    """The flagship model's weights as K-B3, K-B2 and K-B5 read them (LSA
    folded): :func:`repack_mma` of the model's cached :func:`pack_weights`
    buffer."""
    return repack_mma(PACKS.get(model, "float32", pack_weights))


def packed_mma_for(model: nerf.NeRF, device):
    """The model's cached :func:`pack_weights_mma` buffer where the kernels
    will launch (a CUDA device), None where the plain versions run."""
    if torch.device(device).type != "cuda":
        return None
    return PACKS.get(model, "float32_mma", pack_weights_mma)


def unpack_weights_mma(packed_mma: torch.Tensor):
    """{layer name: (w (in, out), b (out,))} read back from a buffer of
    :func:`repack_mma`, as :func:`unpack_weights` gives them."""
    _check("packed_mma", packed_mma, (MMA_PARAMS_SIZE,))
    index = torch.from_numpy(MMA_INDEX).to(packed_mma.device)
    flat = packed_mma.new_zeros(PARAMS_SIZE + 1)
    flat[index] = packed_mma
    return unpack_weights(flat[:PARAMS_SIZE])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero, by integer operations on the
    float32 bits. Infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x cut to TF32: the low 13 mantissa bits cleared, which is how the
    tensor core reads a float32 register given to it as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) as the kernel splits an operand: hi = x rounded to TF32,
    lo = the exact rest x - hi as the tensor core reads it (cut to TF32).
    |x - (hi + lo)| <= 2^-21 |x|."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def matmul_3xtf32_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the tensor-core chain computes it: both operands split by
    :func:`split_tf32`, and the three products lo * hi, hi * lo, hi * hi
    summed in float32, the small ones first (lo * lo is dropped). Every
    TF32 x TF32 product is exact in float32; only the order of the float32
    sums differs from the kernel's."""
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
    return (xl @ wh + xh @ wl) + xh @ wh


def mlp_3xtf32_plain(L, pe, ve):
    """The MLP (weights as :func:`unpack_weights` gives them, any width) on
    embedded points with the ten wide layers' products as
    :func:`matmul_3xtf32_plain` and the two heads in float32: the arithmetic
    of ``csrc/nerf_mlp_mma.cuh``."""
    return _mlp_packed(
        L, pe, ve, addmm=lambda b, x, w: b + matmul_3xtf32_plain(x, w))


# --- the bf16 chain of K-B3 / K-B2: its packing and its arithmetic -----------
# csrc/nerf_mlp_bf16.cuh. The same ownership as above (eight warps, 8 * NT
# output channels each) over mma.sync m16n8k16: a k step is 16 channels, a
# 32-bit word holds two bf16 values of consecutive rows, the lower row in
# the low half. Lane 4 g + t of warp w reads, for k step ks and n-tile nt,
# the words b0 = W[row .. row + 1, col] at row = 16 ks + 2 t and b1 at
# row = 16 ks + 2 t + 8, col = 8 NT w + 8 nt + g. The buffer is int32: its
# order is [slab][warp][k step][n-tile pair][lane][nt % 2][r] words, then as
# float32 bit patterns the biases and the heads of the float32 layout above
# (the heads' weights rounded to bf16 and widened again).
BF16_SLABS = 37   # of 8,192 words (32 KB): 64 rows at 256 outputs, 128 at 128


def fragment_index_k16(base, ld, rows, padded, n_out, pad):
    """:func:`fragment_index` for ``mma.sync`` m16n8k16 on 16-bit values:
    for B (rows, n_out) stored row-major at ``base`` with row stride ``ld``,
    the index of every value of the run's slabs, in the order [slab][warp]
    [k step of the slab][n-tile pair][lane][nt % 2][r][j], value j of word r
    being row 16 ks + 2 t + 8 r + j; ``pad`` for the zero rows
    rows..padded and for the rest of the run's last slab."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    nt_n = n_out // 64
    per_slab = 16 // nt_n             # k steps in a slab
    ks = np.arange(-(-padded // (16 * per_slab)) * per_slab)
    # [ks][warp][q][lane][nt2][r][j]
    ax = lambda a, i: np.asarray(a).reshape([-1 if k == i else 1
                                            for k in range(7)])
    row = ax(16 * ks, 0) + ax(2 * t, 3) + ax(8 * np.arange(2), 5) \
        + ax(np.arange(2), 6)
    col = ax(8 * nt_n * np.arange(8), 1) + ax(16 * np.arange(nt_n // 2), 2) \
        + ax(8 * np.arange(2), 4) + ax(g, 3)
    idx = np.where(row < rows, base + row * ld + col, pad)
    # -> [slab][warp][k step of the slab][q][lane][nt2][r][j]
    return idx.reshape(-1, per_slab, 8, nt_n // 2, 32, 2, 2, 2) \
        .transpose(0, 2, 1, 3, 4, 5, 6, 7).reshape(-1)


def _bf16_index():
    """(index of every bf16 value of the slabs, index of every float32 word
    after them) into pack_weights' buffer, PARAMS_SIZE where it is zero
    padding."""
    segs = {name: (din, dout, off) for name, din, dout, off
            in _segments(FLAGSHIP)[0]}
    parts = []
    for name, row0, rows, padded in MMA_RUNS:
        _din, dout, off = segs[name]
        parts.append(fragment_index_k16(off + row0 * dout, dout, rows, padded,
                                        dout, PARAMS_SIZE))
    slabs = np.concatenate(parts).astype(np.int64)
    tail = MMA_INDEX[MMA_SLABS * MMA_SLAB:]
    size = slabs.size // 2 + tail.size
    tail = np.concatenate([tail, np.full(-size % _SEG, PARAMS_SIZE)])
    return slabs, tail.astype(np.int64)


BF16_SLAB_INDEX, BF16_TAIL_INDEX = _bf16_index()
BF16_PARAMS_SIZE = BF16_SLAB_INDEX.size // 2 + BF16_TAIL_INDEX.size
_bf16_index_on = {}   # device -> (BF16_SLAB_INDEX, BF16_TAIL_INDEX) there
bf16_round = nerf.bf16_round


def _bf16_indices(device):
    index = _bf16_index_on.get(device)
    if index is None:
        index = _bf16_index_on[device] = tuple(
            torch.from_numpy(i).to(device)
            for i in (BF16_SLAB_INDEX, BF16_TAIL_INDEX))
    return index


def repack_bf16(packed: torch.Tensor) -> torch.Tensor:
    """The buffer of :func:`pack_weights` (LSA already folded, float32) as
    the bf16 kernels read it: int32 (BF16_PARAMS_SIZE,). Every weight is
    rounded to bf16 (nearest even); the slabs hold them two to a word in the
    fragments' order, the tail holds the float32 biases and the two heads'
    rounded weights as float32 bit patterns."""
    _check("packed", packed, (PARAMS_SIZE,))
    slab_index, tail_index = _bf16_indices(packed.device)
    segs, _size = _segments(FLAGSHIP)
    is_bias = torch.zeros(PARAMS_SIZE + 1, dtype=torch.bool,
                          device=packed.device)
    for _name, din, dout, off in segs:
        is_bias[off + din * dout:off + din * dout + dout] = True
    src = torch.cat([packed, packed.new_zeros(1)])
    rounded = src.to(torch.bfloat16)
    slabs = rounded[slab_index].view(torch.int32)
    tail = torch.where(is_bias, src, rounded.float())[tail_index] \
        .view(torch.int32)
    return torch.cat([slabs, tail])


def pack_weights_bf16(model: nerf.NeRF) -> torch.Tensor:
    """The flagship model's weights as the bf16 kernels read them:
    ``bf16(ls * W)``, the values of the reference's ``_pack_weights(params,
    ls, bfloat16)`` (mlp_pallas.py:49-96), and float32 biases;
    :func:`repack_bf16` of the model's cached :func:`pack_weights` buffer."""
    return repack_bf16(PACKS.get(model, "float32", pack_weights))


def packed_bf16_for(model: nerf.NeRF) -> torch.Tensor:
    """The model's cached :func:`pack_weights_bf16` buffer."""
    return PACKS.get(model, "bf16_mma", pack_weights_bf16)


def unpack_weights_bf16(packed_bf16: torch.Tensor):
    """{layer name: (w (in, out), b (out,))} read back from a buffer of
    :func:`repack_bf16`, float32 tensors whose weights hold bf16 values."""
    _check("packed_bf16", packed_bf16, (BF16_PARAMS_SIZE,), torch.int32)
    slab_index, tail_index = _bf16_indices(packed_bf16.device)
    n_slab = BF16_SLAB_INDEX.size // 2
    flat = torch.zeros(PARAMS_SIZE + 1, device=packed_bf16.device)
    flat[slab_index] = packed_bf16[:n_slab].view(torch.bfloat16).float()
    flat[tail_index] = packed_bf16[n_slab:].view(torch.float32)
    return unpack_weights(flat[:PARAMS_SIZE])


# --- K-B3 bf16's wgmma chain: its weight slabs -------------------------------
# csrc/nerf_mlp_wgmma.cuh. The 37 slabs of MMA_RUNS again, each now the exact
# shared-memory image that a wgmma descriptor reads as operand B: K-major
# (the slab's depth rows of one output channel contiguous), 64 values of the
# depth to a 128-byte row, eight rows to a 1,024-byte atom whose 16-byte
# chunk c of row r lies at chunk c ^ r (the 128-byte swizzle), and the next
# 64 values of the depth one block of n_out rows further. A 256-wide layer's
# slab holds 64 depth rows x 256 channels, a view layer's 128 x 128 (two
# blocks); both 32 KB, which one bulk copy brings into a ring stage as they
# are. The buffer holds the slabs alone: the biases and heads stay in
# pack_weights_bf16's tail.
WG_SLAB_ROWS = {256: 64, 128: 128}   # depth rows of a slab, by n_out


def wgmma_positions(n_out, depth):
    """Where the 128-byte-swizzled K-major image of a (depth, n_out) operand
    holds value (k, n), in 16-bit values: an int64 array (depth, n_out).
    depth is a multiple of 64."""
    k = np.arange(depth)[:, None]
    n = np.arange(n_out)[None, :]
    byte = (k >> 6) * n_out * 128 + n * 128 \
        + ((((k >> 3) & 7) ^ (n & 7)) << 4) + (k & 7) * 2
    return (byte // 2).astype(np.int64)


def wgmma_image(w: torch.Tensor) -> torch.Tensor:
    """w (depth, n_out) as the image :func:`wgmma_positions` describes: a
    flat tensor of w's type."""
    depth, n_out = w.shape
    pos = torch.from_numpy(wgmma_positions(n_out, depth).reshape(-1))
    out = w.new_zeros(depth * n_out)
    out[pos.to(w.device)] = w.reshape(-1)
    return out


def _wgmma_index():
    """For every 16-bit value of the wgmma slabs, the index of its bf16 value
    among the slab part of repack_bf16's buffer, or BF16_SLAB_INDEX.size (a
    zero appended) where it is zero padding."""
    segs = {name: (din, dout, off) for name, din, dout, off
            in _segments(FLAGSHIP)[0]}
    inv = np.full(PARAMS_SIZE + 1, BF16_SLAB_INDEX.size, dtype=np.int64)
    real = BF16_SLAB_INDEX < PARAMS_SIZE
    inv[BF16_SLAB_INDEX[real]] = np.nonzero(real)[0]
    parts = []
    for name, row0, rows, padded in MMA_RUNS:
        _din, dout, off = segs[name]
        per = WG_SLAB_ROWS[dout]
        pos = wgmma_positions(dout, per).reshape(-1)
        for first in range(0, padded, per):
            k = first + np.arange(per)[:, None]
            n = np.arange(dout)[None, :]
            src = np.where(k < rows, off + (row0 + k) * dout + n, PARAMS_SIZE)
            slab = np.empty(per * dout, dtype=np.int64)
            slab[pos] = inv[src].reshape(-1)
            parts.append(slab)
    return np.concatenate(parts)


WG_INDEX = _wgmma_index()
WG_SIZE = WG_INDEX.size // 2   # int32 words: 37 slabs of 8,192
_wg_index_on = {}   # device -> WG_INDEX as a tensor there


def repack_bf16_wgmma(packed_bf16: torch.Tensor) -> torch.Tensor:
    """The slabs of a :func:`repack_bf16` buffer as K-B3 bf16's wgmma chain
    reads them: int32 (WG_SIZE,), one gather where the buffer lies."""
    _check("packed_bf16", packed_bf16, (BF16_PARAMS_SIZE,), torch.int32)
    index = _wg_index_on.get(packed_bf16.device)
    if index is None:
        index = _wg_index_on[packed_bf16.device] = \
            torch.from_numpy(WG_INDEX).to(packed_bf16.device)
    n_slab = BF16_SLAB_INDEX.size // 2
    src = packed_bf16[:n_slab].view(torch.bfloat16)
    src = torch.cat([src, src.new_zeros(1)])
    return src[index].view(torch.int32)


def packed_wg_for(model: nerf.NeRF) -> torch.Tensor:
    """The model's cached :func:`repack_bf16_wgmma` buffer."""
    return PACKS.get(model, "bf16_wgmma",
                     lambda m: repack_bf16_wgmma(packed_bf16_for(m)))

def mlp_bf16_plain(L, pe, ve):
    """The MLP (weights as :func:`unpack_weights_bf16` gives them, any
    width) on float32 embeddings as the bf16 chain computes it
    (``_mlp_body``, mlp_pallas.py:162-188): the embeddings and every layer's
    output after its ReLU rounded to bf16, ``feature`` rounded without one,
    products of bf16 values (exact in float32) summed in float32, float32
    biases, the logits float32. Rounding commutes with the ReLU."""
    return _mlp_packed(
        L, bf16_round(pe), bf16_round(ve),
        addmm=lambda b, x, w: bf16_round(torch.addmm(b, x, w)))


def pack_weights_int8(model: nerf.NeRF):
    """The flagship model's weights as K-B4 reads them: ``(wq, scales,
    biases)``, three flat tensors.

    Counterpart of ``_pack_weights_int8`` (mlp_pallas.py:99-113): LSA scales
    folded in, then every block of :data:`INT8_BLOCKS` quantized per output
    column, ``s_o = max|w[:, o]| / 127``, ``q = clip(round(w / s_o), +-127)``,
    a zero column staying zero. ``wq`` (int8) holds the blocks one after the
    other, each with its rows padded with zeros to a multiple of 4 and laid
    out as (rows / 4, out, 4): four consecutive inputs of one output column
    share a 32-bit word, the operand of ``__dp4a``. ``scales`` (float32)
    holds the 14 rows of ``s_o``, ``biases`` (float32) the 12 bias rows of
    :data:`INT8_BIASES`. The TPU layout's 128-row blocks and 128-lane output
    columns are not carried over."""
    if not supports(model.config):
        raise ValueError(f"no fused kernel for {model.config}")
    layers = model.layers()
    wq, scales = [], []
    with torch.no_grad():
        for _key, name, row0, rows, _out in INT8_BLOCKS:
            w = layers[name].effective_weight().t().float()[row0:row0 + rows]
            s = _div(w.abs().amax(dim=0), 127.0)
            q = torch.where(s > 0, torch.round(w / torch.where(s > 0, s, 1.0)),
                            0.0)
            q = torch.clamp(q, -127, 127).to(torch.int8)
            q = F.pad(q, (0, 0, 0, -rows % 4))
            wq.append(q.reshape(-1, 4, q.shape[1]).permute(0, 2, 1)
                      .reshape(-1))
            scales.append(s)
        biases = [layers[name].bias.float() for _key, name, _n in INT8_BIASES]
        return torch.cat(wq), torch.cat(scales), torch.cat(biases)


def unpack_weights_int8(wq, scales, biases):
    """``({key: (q (rows, out) int8, s (out,))}, {key: b})`` read back from
    the buffers of :func:`pack_weights_int8`."""
    for name, t, dtype, size in (("wq", wq, torch.int8, INT8_WQ_SIZE),
                                 ("scales", scales, torch.float32,
                                  INT8_SCALES_SIZE),
                                 ("biases", biases, torch.float32,
                                  INT8_BIASES_SIZE)):
        if t.dtype != dtype or tuple(t.shape) != (size,):
            raise ValueError(f"{name}: expected {dtype} ({size},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    blocks, off, soff = {}, 0, 0
    for key, _name, _row0, rows, out in INT8_BLOCKS:
        k4 = -(-rows // 4)
        q = wq[off:off + k4 * 4 * out].view(k4, out, 4).permute(0, 2, 1) \
            .reshape(k4 * 4, out)[:rows]
        blocks[key] = (q, scales[soff:soff + out])
        off += k4 * 4 * out
        soff += out
    rows_b, boff = {}, 0
    for key, _name, n in INT8_BIASES:
        rows_b[key] = biases[boff:boff + n]
        boff += n
    return blocks, rows_b


# --- K-B4 on the tensor cores: its fragment order -----------------------------
# csrc/mlp_int8_from_points.cu: mma.sync m16n8k32 on s8 operands, the bf16
# chain's ownership (eight warps, 8 * NT output channels each) with a k step
# of 32 channels: a 32-bit word holds four int8 weights of consecutive rows
# of one column, the lowest row in the low byte. Lane 4 g + t of warp w
# reads, for k step ks and n-tile nt, b0 = W[32 ks + 4 t .. + 3, col] and
# b1 = W[32 ks + 16 + 4 t .. + 3, col] at col = 8 NT w + 8 nt + g. The
# buffer is int32: the slabs (8,192 words, 32 KB; 4 k steps of a 256-wide
# block, 8 of the 128-wide ones) in the order [slab][warp][k step][n-tile
# pair][lane][nt % 2][r] words; then the heads' weights one int32 each
# (alpha's 256; rgb's (128, 4), the fourth column zero); then
# pack_weights_int8's scales and biases as float32 bit patterns.
# (block, rows padded to whole k steps) in the order the kernel streams
# them: the skip's and the view layer's large product before their small one
INT8_MMA_RUNS = (("w0", 64), ("w1", 256), ("w2", 256), ("w3", 256),
                 ("w4", 256), ("w5b", 256), ("w5a", 64), ("w6", 256),
                 ("w7", 256), ("wf", 256), ("wva", 256), ("wvb", 32))
INT8_MMA_SLABS = 20


def _int8_block_at():
    """{block key: (its first byte in pack_weights_int8's wq, rows, out)}."""
    at, off = {}, 0
    for key, _name, _row0, rows, out in INT8_BLOCKS:
        at[key] = (off, rows, out)
        off += -(-rows // 4) * 4 * out
    return at


_INT8_BLOCK_AT = _int8_block_at()


def _int8_byte(key, row, col):
    """Where pack_weights_int8's wq holds block ``key``'s weight (row, col):
    blocks laid out as (rows / 4, out, 4)."""
    off, _rows, out = _INT8_BLOCK_AT[key]
    return off + 4 * ((row // 4) * out + col) + row % 4


def fragment_index_k32(key, padded):
    """For block ``key`` of pack_weights_int8 (``padded`` rows: its depth
    in whole k steps of 32), the index into wq of every byte of its run of
    slabs, in the order [slab][warp][k step of the slab][n-tile pair][lane]
    [nt % 2][r][j], byte j of word r being row 32 ks + 4 t + 16 r + j;
    INT8_WQ_SIZE for zero padding (rows past the block's and the rest of
    the run's last slab)."""
    _off, rows, n_out = _INT8_BLOCK_AT[key]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    nt_n = n_out // 64
    per_slab = 16 // nt_n             # k steps in a slab
    ks = np.arange(-(-padded // (32 * per_slab)) * per_slab)
    ax = lambda a, i: np.asarray(a).reshape([-1 if k == i else 1
                                            for k in range(7)])
    # [ks][warp][q][lane][nt2][r][j]
    row = ax(32 * ks, 0) + ax(4 * t, 3) + ax(16 * np.arange(2), 5) \
        + ax(np.arange(4), 6)
    col = ax(8 * nt_n * np.arange(8), 1) + ax(16 * np.arange(nt_n // 2), 2) \
        + ax(8 * np.arange(2), 4) + ax(g, 3)
    row, col = np.broadcast_arrays(row, col)
    idx = np.where(row < rows, _int8_byte(key, np.minimum(row, rows - 1), col),
                   INT8_WQ_SIZE)
    # -> [slab][warp][k step of the slab][q][lane][nt2][r][j]
    return idx.reshape(-1, per_slab, 8, nt_n // 2, 32, 2, 2, 4) \
        .transpose(0, 2, 1, 3, 4, 5, 6, 7).reshape(-1)


INT8_MMA_INDEX = np.concatenate(
    [fragment_index_k32(key, padded) for key, padded in INT8_MMA_RUNS]
).astype(np.int64)
assert INT8_MMA_INDEX.size == INT8_MMA_SLABS * 4 * MMA_SLAB
# the heads' int8 weights, one int32 each: alpha (256,), rgb (128, 4)
INT8_MMA_HEADS = np.concatenate([
    _int8_byte("wa", np.arange(256), 0),
    np.where(np.arange(4)[None, :] < 3,
             _int8_byte("wr", np.arange(128)[:, None],
                        np.minimum(np.arange(4), 2)[None, :]),
             INT8_WQ_SIZE).reshape(-1)]).astype(np.int64)
_INT8_MMA_USED = INT8_MMA_INDEX.size // 4 + INT8_MMA_HEADS.size \
    + INT8_SCALES_SIZE + INT8_BIASES_SIZE
INT8_MMA_SIZE = -(-_INT8_MMA_USED // _SEG) * _SEG
_int8_mma_index_on = {}   # device -> (INT8_MMA_INDEX, INT8_MMA_HEADS) there


def _int8_mma_indices(device):
    index = _int8_mma_index_on.get(device)
    if index is None:
        index = _int8_mma_index_on[device] = tuple(
            torch.from_numpy(i).to(device)
            for i in (INT8_MMA_INDEX, INT8_MMA_HEADS))
    return index


def repack_int8_mma(wq, scales, biases) -> torch.Tensor:
    """The three buffers of :func:`pack_weights_int8` as K-B4 reads them:
    one int32 (INT8_MMA_SIZE,) buffer, the weights in the fragment order of
    ``mma.sync`` m16n8k32 (one gather), the heads' weights widened to int32,
    the scales and biases as their float32 bits."""
    _check_int8(wq, scales, biases)
    slab_index, head_index = _int8_mma_indices(wq.device)
    src = torch.cat([wq, wq.new_zeros(1)])
    tail = [src[head_index].int(), scales.view(torch.int32),
            biases.view(torch.int32)]
    tail.append(tail[0].new_zeros(INT8_MMA_SIZE - _INT8_MMA_USED))
    return torch.cat([src[slab_index].view(torch.int32), *tail])


def unpack_weights_int8_mma(packed: torch.Tensor):
    """``(wq, scales, biases)`` of :func:`pack_weights_int8` read back from a
    buffer of :func:`repack_int8_mma`."""
    _check("packed_s8", packed, (INT8_MMA_SIZE,), torch.int32)
    slab_index, head_index = _int8_mma_indices(packed.device)
    n_slab = INT8_MMA_INDEX.size // 4
    wq = torch.zeros(INT8_WQ_SIZE + 1, dtype=torch.int8, device=packed.device)
    wq[slab_index] = packed[:n_slab].view(torch.int8)
    heads = packed[n_slab:n_slab + head_index.numel()]
    wq[head_index] = heads.to(torch.int8)
    rest = packed[n_slab + head_index.numel():]
    return (wq[:INT8_WQ_SIZE],
            rest[:INT8_SCALES_SIZE].view(torch.float32).clone(),
            rest[INT8_SCALES_SIZE:INT8_SCALES_SIZE + INT8_BIASES_SIZE]
            .view(torch.float32).clone())


def pack_weights_int8_mma(model: nerf.NeRF) -> torch.Tensor:
    """The flagship model's int8 weights as K-B4 reads them:
    :func:`repack_int8_mma` of the model's cached :func:`pack_weights_int8`
    buffers."""
    return repack_int8_mma(*PACKS.get(model, "int8", pack_weights_int8))


def _div(a, b):
    """a / b as one correctly rounded float32 division, whichever of the two
    is the scalar. (``tensor / scalar`` may multiply by the scalar's
    reciprocal on the card, and ``scalar / tensor`` does so everywhere: one
    more rounding than the kernel's and the reference's division.)"""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def _qdense(xq, m, block):
    """One quantized product of K-B4: xq (B, block, K) float32 holding the
    integers of the quantized activations, m (B, 1, 1) their block's scale.
    Every partial sum is an integer below 319 * 127^2 < 2^24, which float32
    holds exactly, so the float32 product is the exact int32 one in any
    order of summation."""
    q, s = block
    return (xq @ q.float()) * (s * _div(m, 127.0))


def _quantize(x):
    """Dynamic symmetric int8 quantization of x (B, block, K) with one scale
    per block (mlp_pallas.py:120-121): returns (integers as float32, m)."""
    m = x.abs().amax(dim=(1, 2), keepdim=True) + 1e-12
    return torch.clamp(torch.round(x * _div(127.0, m)), -127, 127), m


def _mlp_int8_blocks(W, B, pe, ve):
    """``_mlp_body_int8`` (mlp_pallas.py:127-147) on (B, block, 63 / 27)
    embeddings: the float32 steps in the reference's order."""
    emb, m_e = _quantize(torch.cat([pe, ve], dim=-1))
    pq, vq = emb[..., :63], emb[..., 63:]
    h = F.relu(_qdense(pq, m_e, W["w0"]) + B["b0"])
    for i in (1, 2, 3, 4):
        hq, m = _quantize(h)
        h = F.relu(_qdense(hq, m, W[f"w{i}"]) + B[f"b{i}"])
    hq, m = _quantize(h)
    h = F.relu(_qdense(pq, m_e, W["w5a"]) + _qdense(hq, m, W["w5b"])
               + B["b5"])
    for i in (6, 7):
        hq, m = _quantize(h)
        h = F.relu(_qdense(hq, m, W[f"w{i}"]) + B[f"b{i}"])
    hq, m = _quantize(h)
    alpha = _qdense(hq, m, W["wa"]) + B["ba"]
    fq, m_f = _quantize(_qdense(hq, m, W["wf"]) + B["bf"])
    v = F.relu(_qdense(fq, m_f, W["wva"]) + _qdense(vq, m_e, W["wvb"])
               + B["bv"])
    vq2, m_v = _quantize(v)
    rgb = _qdense(vq2, m_v, W["wr"]) + B["br"]
    return torch.cat([rgb, alpha], dim=-1)


def fused_nerf_mlp_int8_from_points_plain(wq, scales, biases, pts, dirs,
                                          packed_s8=None,
                                          block=INT8_ACT_BLOCK):
    """Plain PyTorch version of K-B4: pts, dirs (N, 3) -> raw (N, 4).

    Activations are quantized per ``block`` consecutive points (a last,
    shorter block holds the remaining points alone); the integer products
    are exact (see :func:`_qdense`). ``packed_s8``, the kernel's buffer, is
    ignored: the signature is the wrapper's, so the two swap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    W, B = unpack_weights_int8(wq, scales, biases)
    n = pts.shape[0]
    outs = []
    chunk = max(PLAIN_CHUNK // block, 1) * block
    for start in range(0, n, chunk):
        p, d = pts[start:start + chunk], dirs[start:start + chunk]
        pe, ve = positional_encoding(p, 10), positional_encoding(d, 4)
        full = p.shape[0] // block * block
        for lo, hi, b in ((0, full, block), (full, p.shape[0],
                                             p.shape[0] - full)):
            if hi > lo:
                outs.append(_mlp_int8_blocks(
                    W, B, pe[lo:hi].reshape(-1, b, 63),
                    ve[lo:hi].reshape(-1, b, 27)).reshape(-1, 4))
    if not outs:
        return pts.new_zeros((0, 4))
    return torch.cat(outs)


def _chunked(fn, a, b):
    """``fn(a_rows, b_rows) -> (rows, 4)`` over ``PLAIN_CHUNK`` rows of
    ``a`` and ``b`` at a time, concatenated to (N, 4)."""
    outs = [fn(a[start:start + PLAIN_CHUNK], b[start:start + PLAIN_CHUNK])
            for start in range(0, a.shape[0], PLAIN_CHUNK)]
    return torch.cat(outs) if outs else a.new_zeros((0, 4))


def fused_nerf_mlp_plain(packed, pts_emb, views_emb):
    """Plain PyTorch version of K-B5: pts_emb (N, 63), views_emb (N, 27) ->
    raw (N, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L = unpack_weights(packed)
    return _chunked(lambda pe, ve: _mlp_packed(L, pe, ve), pts_emb, views_emb)


def fused_nerf_mlp_from_points_plain(packed, pts, dirs):
    """Plain PyTorch version of K-B3: pts, dirs (N, 3) -> raw (N, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L = unpack_weights(packed)
    return _chunked(lambda p, d: _mlp_packed(L, positional_encoding(p, 10),
                                             positional_encoding(d, 4)),
                    pts, dirs)


def fused_nerf_mlp_bf16_plain(packed_bf16, pts_emb, views_emb):
    """Plain PyTorch version of K-B5 in bf16: float32 pts_emb (N, 63),
    views_emb (N, 27) -> raw (N, 4) float32, the embeddings rounded once
    (:func:`mlp_bf16_plain`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L = unpack_weights_bf16(packed_bf16)
    return _chunked(lambda pe, ve: mlp_bf16_plain(L, pe, ve),
                    pts_emb, views_emb)


def fused_nerf_mlp_from_points_bf16_plain(packed_bf16, pts, dirs):
    """Plain PyTorch version of K-B3 in bf16: pts, dirs (N, 3) -> raw
    (N, 4). The positional encoding is computed in float32 and rounded once
    (:func:`mlp_bf16_plain`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L = unpack_weights_bf16(packed_bf16)
    return _chunked(lambda p, d: mlp_bf16_plain(L, positional_encoding(p, 10),
                                                positional_encoding(d, 4)),
                    pts, dirs)


def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected contiguous {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _check_mma(packed, packed_mma):
    """The fragment-ordered buffer K-B3, K-B5 and K-B2 launch with:
    ``packed_mma`` checked (``cp.async`` copies it 16 bytes at a time), or
    made from ``packed`` if None. For a CPU ``packed``, whose plain versions
    read ``packed`` alone, a buffer given is checked for its size and None
    is returned."""
    if not packed.is_cuda:
        if packed_mma is not None:
            _check("packed_mma", packed_mma, (MMA_PARAMS_SIZE,))
        return None
    if packed_mma is None:
        packed_mma = repack_mma(packed)
    _check("packed_mma", packed_mma, (MMA_PARAMS_SIZE,))
    if packed_mma.device != packed.device or packed_mma.data_ptr() % 16:
        raise ValueError("packed_mma must lie on packed's device, 16-byte "
                         "aligned")
    return packed_mma


def _mma_weights(packed, packed_mma):
    """``kernel_weights`` of :func:`_run` for the 3xTF32 kernels."""
    buf = _check_mma(packed, packed_mma)
    return None if buf is None else (buf,)


def _run(name, plain, weights, inputs, kernel_weights=None):
    """Shared body of the kernel wrappers. ``inputs``: {label: (tensor
    (N, width), width)}, float32. The plain version (on ``weights``) for CPU
    tensors, the kernel ``nnc_<name>`` (on ``kernel_weights`` if given, else
    ``weights``) for CUDA tensors, an error for any other device.
    Returns raw (N, 4)."""
    tensors = [t for t, _width in inputs.values()]
    n = tensors[0].shape[0]
    for label, (t, width) in inputs.items():
        _check(label, t, (n, width))
    device = tensors[0].device
    if any(t.device != device for t in (*weights, *tensors)):
        raise ValueError(f"{name}: weights and inputs must be on one device")
    if device.type == "cpu":
        return plain(*weights, *tensors)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _build.lib()
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch(name)
        _build.check(getattr(lib, "nnc_" + name)(
            *(t.data_ptr() for t in (*(kernel_weights or weights), *tensors)),
            out.data_ptr(), n,
            stream), name)
    return out


def mlp_from_points(packed, pts, dirs, packed_mma=None):
    """K-B3 wrapper: raw (N, 4) for points and view directions (N, 3).

    CUDA tensors launch the kernel, which reads ``packed_mma``
    (:func:`repack_mma` of ``packed``, made here if not given); CPU tensors
    take the plain version on ``packed`` (a ``packed_mma`` given is checked
    for its size)."""
    _check("packed", packed, (PARAMS_SIZE,))
    return _run("mlp_from_points", fused_nerf_mlp_from_points_plain,
                (packed,), {"pts": (pts, 3), "dirs": (dirs, 3)},
                kernel_weights=_mma_weights(packed, packed_mma))


def _check_bf16(packed_bf16):
    """The buffer the bf16 kernels launch with (``cp.async`` copies it 16
    bytes at a time)."""
    _check("packed_bf16", packed_bf16, (BF16_PARAMS_SIZE,), torch.int32)
    if packed_bf16.is_cuda and packed_bf16.data_ptr() % 16:
        raise ValueError("packed_bf16 must be 16-byte aligned")
    return packed_bf16


def mlp_from_points_bf16(packed_bf16, pts, dirs, packed_wg=None):
    """K-B3 wrapper, bf16: raw (N, 4) float32 for float32 points and view
    directions (N, 3), the weights as :func:`pack_weights_bf16` gives them.

    CUDA tensors launch the kernel, which reads the biases and heads from
    ``packed_bf16`` and the slabs from ``packed_wg``
    (:func:`repack_bf16_wgmma` of ``packed_bf16``). Made here if not given,
    it is gathered anew at every call (1.2 MB): a caller that launches more
    than once passes it, as :func:`fused_nerf_mlp_from_points` does from
    ``PACKS``. CPU tensors take the plain version (a ``packed_wg`` given is
    checked all the same)."""
    _check_bf16(packed_bf16)
    if packed_wg is None and packed_bf16.is_cuda:
        packed_wg = repack_bf16_wgmma(packed_bf16)
    if packed_wg is not None:
        _check("packed_wg", packed_wg, (WG_SIZE,), torch.int32)
        if packed_wg.device != packed_bf16.device or \
                (packed_wg.is_cuda and packed_wg.data_ptr() % 16):
            raise ValueError("packed_wg must lie on packed_bf16's device, "
                             "16-byte aligned")
    kernel_weights = (packed_bf16, packed_wg) if packed_bf16.is_cuda \
        else None
    return _run("mlp_from_points_bf16", fused_nerf_mlp_from_points_bf16_plain,
                (packed_bf16,), {"pts": (pts, 3), "dirs": (dirs, 3)},
                kernel_weights=kernel_weights)


def _check_int8(wq, scales, biases):
    """The three buffers of :func:`pack_weights_int8`, checked."""
    _check("wq", wq, (INT8_WQ_SIZE,), torch.int8)
    _check("scales", scales, (INT8_SCALES_SIZE,))
    _check("biases", biases, (INT8_BIASES_SIZE,))


def mlp_int8_from_points(wq, scales, biases, pts, dirs, packed_s8=None):
    """K-B4 wrapper: raw (N, 4) for points and view directions (N, 3), the
    weights as :func:`pack_weights_int8` gives them; activations quantized
    per :data:`INT8_ACT_BLOCK` points.

    CUDA tensors launch the kernel, which reads ``packed_s8``
    (:func:`repack_int8_mma` of the three buffers). Made here if not given,
    it is gathered anew at every call (~650 KB): a caller that launches more
    than once passes it, as :func:`fused_nerf_mlp_int8_from_points` does
    from ``PACKS``. CPU tensors take the plain version."""
    _check_int8(wq, scales, biases)
    kernel_weights = None
    if wq.is_cuda:
        if packed_s8 is None:
            packed_s8 = repack_int8_mma(wq, scales, biases)
        _check("packed_s8", packed_s8, (INT8_MMA_SIZE,), torch.int32)
        if packed_s8.device != wq.device or packed_s8.data_ptr() % 16:
            raise ValueError("packed_s8 must lie on wq's device, 16-byte "
                             "aligned")
        kernel_weights = (packed_s8,)
    return _run("mlp_int8_from_points", fused_nerf_mlp_int8_from_points_plain,
                (wq, scales, biases), {"pts": (pts, 3), "dirs": (dirs, 3)},
                kernel_weights=kernel_weights)


def mlp_embedded(packed, pts_emb, views_emb, packed_mma=None):
    """K-B5 wrapper: raw (N, 4) for embedded points (N, 63) and embedded view
    directions (N, 27).

    CUDA tensors launch the kernel, which reads ``packed_mma``
    (:func:`repack_mma` of ``packed``, made here if not given); CPU tensors
    take the plain version on ``packed`` (a ``packed_mma`` given is checked
    for its size)."""
    _check("packed", packed, (PARAMS_SIZE,))
    return _run("mlp_embedded", fused_nerf_mlp_plain, (packed,),
                {"pts_emb": (pts_emb, 63), "views_emb": (views_emb, 27)},
                kernel_weights=_mma_weights(packed, packed_mma))


def mlp_embedded_bf16(packed_bf16, pts_emb, views_emb):
    """K-B5 wrapper, bf16: raw (N, 4) float32 for float32 embedded points
    (N, 63) and view directions (N, 27), the weights as
    :func:`pack_weights_bf16` gives them.

    CUDA tensors launch the kernel, which copies a tile's rows of both
    embeddings as one bulk copy each and so needs them 16-byte aligned (a
    view that starts at a row that is a multiple of 4 is); CPU tensors take
    the plain version."""
    if pts_emb.is_cuda and (pts_emb.data_ptr() % 16 or
                            views_emb.data_ptr() % 16):
        raise ValueError("mlp_embedded_bf16: pts_emb and views_emb must be "
                         "16-byte aligned")
    return _run("mlp_embedded_bf16", fused_nerf_mlp_bf16_plain,
                (_check_bf16(packed_bf16),),
                {"pts_emb": (pts_emb, 63), "views_emb": (views_emb, 27)})


def fused_nerf_mlp_from_points(model: nerf.NeRF, pts, viewdirs):
    """posenc + MLP from raw points. pts: (..., 3); viewdirs broadcastable
    to pts. Returns raw (..., 4) float32. ``model.config.compute_dtype``
    picks the float32 or the bf16 variant of K-B3."""
    vd = torch.broadcast_to(viewdirs, pts.shape)
    if not supports(model.config):
        return nerf.apply_mlp(model, positional_encoding(pts, 10),
                              positional_encoding(vd, 4))
    lead = pts.shape[:-1]
    flat = (pts.reshape(-1, 3).float().contiguous(),
            vd.reshape(-1, 3).float().contiguous())
    if model.config.compute_dtype == torch.bfloat16:
        raw = mlp_from_points_bf16(
            packed_bf16_for(model), *flat,
            packed_wg=packed_wg_for(model) if pts.is_cuda else None)
    else:
        raw = mlp_from_points(PACKS.get(model, "float32", pack_weights),
                              *flat,
                              packed_mma=packed_mma_for(model, pts.device))
    return raw.reshape(*lead, 4)


def fused_nerf_mlp_int8_from_points(model: nerf.NeRF, pts, viewdirs):
    """int8 variant of :func:`fused_nerf_mlp_from_points`: per-channel int8
    weights, activations quantized at run time per block of points, int32
    sums. pts: (..., 3); viewdirs broadcastable to pts. Returns raw (..., 4)
    float32. The weights are quantized from float32 whatever
    ``model.config.compute_dtype`` (mlp_pallas.py:378)."""
    vd = torch.broadcast_to(viewdirs, pts.shape)
    if not supports(model.config):
        return nerf.apply_mlp(model, positional_encoding(pts, 10),
                              positional_encoding(vd, 4))
    lead = pts.shape[:-1]
    packed_s8 = PACKS.get(model, "int8_mma", pack_weights_int8_mma) \
        if pts.is_cuda else None
    raw = mlp_int8_from_points(*PACKS.get(model, "int8", pack_weights_int8),
                               pts.reshape(-1, 3).float().contiguous(),
                               vd.reshape(-1, 3).float().contiguous(),
                               packed_s8=packed_s8)
    return raw.reshape(*lead, 4)


def fused_nerf_mlp(model: nerf.NeRF, pts_emb, views_emb):
    """Drop-in for ``nerf.apply_mlp`` on the flagship config (inference
    only). pts_emb: (..., 63); views_emb: (..., 27). Returns raw (..., 4)
    float32. ``model.config.compute_dtype`` picks the float32 or the bf16
    variant of K-B5."""
    if not supports(model.config):
        return nerf.apply_mlp(model, pts_emb, views_emb)
    lead = pts_emb.shape[:-1]
    flat = (pts_emb.reshape(-1, 63).float().contiguous(),
            views_emb.reshape(-1, 27).float().contiguous())
    if model.config.compute_dtype == torch.bfloat16:
        # the kernel needs 16-byte-aligned embeddings: copy a view that is not
        flat = tuple(t.clone() if t.is_cuda and t.data_ptr() % 16 else t
                     for t in flat)
        raw = mlp_embedded_bf16(packed_bf16_for(model), *flat)
    else:
        raw = mlp_embedded(PACKS.get(model, "float32", pack_weights), *flat,
                           packed_mma=packed_mma_for(model, pts_emb.device))
    return raw.reshape(*lead, 4)
