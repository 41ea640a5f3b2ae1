"""Tensor-parallel fused NeRF MLP: the width-split variant, with K-B6.

Counterpart of ``nnc_tpu/ops/mlp_tp_pallas.py``. Megatron-style pairing over
a ``model`` mesh axis of size M: each shard holds a COLUMN shard of the even
layers (w0, w2, w4, w6, wf) and a ROW shard of the odd layers behind them
(w1, w3, w5b, w7, wva). One kernel, K-B6 (``csrc/mlp_tp_pair.cu``), computes
``act(x @ Wcol + bcol) @ Wrow`` per shard, the hidden activation never
leaving the CTA, and a ``psum`` over the shards reassembles the full-width
activation between pairs (5 psums per MLP evaluation). The small irregular
pieces (skip input w5a, view input wvb, alpha and rgb heads) run replicated
in plain torch, as the reference runs them outside its Pallas kernel
(mlp_tp_pallas.py:123-134).

The reference's 128-wide packed embedding and 128-wide output heads are its
kernel's layout, not the function's: here the embeddings are ``(N, 63)`` and
``(N, 27)`` as the caller has them and the heads are (256, 1) and (128, 3).
The sum over the shards runs in another order than the dense sum over 256
channels, so the result equals the dense MLP's to a tolerance (rtol 1e-4,
atol 1e-5 in the tests), never bit for bit.

A model with ``config.compute_dtype == torch.bfloat16`` runs the reference's
bf16 forward (mlp_tp_pallas.py:108-135 with ``cdt`` bfloat16): the weights
``bf16(ls * W)`` (``shard_tp_weights(..., torch.bfloat16)`` holds them as
``torch.bfloat16`` tensors, the biases float32), each pair's input rounded to
bf16 and its hidden tile rounded after the activation, in K-B6's bf16 variant
(``csrc/mlp_tp_pair_bf16.cu``: ``mma.sync`` bf16, float32 sums); the psum'd
partials, ``relu(psum + b)`` and the replicated products' sums float32. The
replicated pieces multiply the rounded embeddings (or the rounded ``h7`` /
``v``) by their bf16 weights, which :func:`place_tp_weights` keeps as float32
tensors holding bf16 values: a float32 product of bf16 values is exact, as
``preferred_element_type=f32`` is, where ``torch.mm`` of two bf16 tensors on
the card would round its result to bf16.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import parallel
from ..models import nerf
from . import _build, mlp_fused
from .mlp_fused import PACKS, _check, bf16_round, supports

# column-sharded layer -> (its bias, the row-sharded layer behind it)
_PAIRS = {"w0": ("b0", "w1"), "w2": ("b2", "w3"), "w4": ("b4", "w5b"),
          "w6": ("b6", "w7"), "wf": ("bf", "wva")}
_LAYER = {"w0": "pts_linears.0", "w2": "pts_linears.2", "w4": "pts_linears.4",
          "w6": "pts_linears.6", "wf": "feature_linear",
          "w1": "pts_linears.1", "w3": "pts_linears.3", "w7": "pts_linears.7"}
# what the kernel is compiled for (csrc/mlp_tp_pair.cu)
KERNEL_S = (32, 64, 128, 256)
KERNEL_HEADS = ((256, True), (128, False))   # (O2, relu_mid)
KERNEL_MAX_K = 256
KERNEL_K_BF16 = (63, 256)   # csrc/mlp_tp_pair_bf16.cu: the forward's depths


def shard_tp_weights(model: nerf.NeRF, n_shards: int,
                     dtype: torch.dtype = torch.float32):
    """``(shards, reps)`` of the flagship model for M = ``n_shards``, LSA
    scales folded in (float32), on the model's device; every weight then in
    ``dtype`` (float32 or bfloat16, rounded to nearest even), every bias
    float32, as the reference's ``shard_tp_weights(params, ls, M, dtype)``.

    ``shards``: stacks over the shard axis 0: the column shards
    ``w0 (M, 63, S)``, ``w2 / w4 / w6 / wf (M, 256, S)`` with their biases
    ``b0 / b2 / b4 / b6 / bf (M, S)``, and the row shards
    ``w1 / w3 / w5b / w7 (M, S, 256)``, ``wva (M, S, 128)``; S = 256 / M.
    ``reps``: the replicated remainder ``w5a (63, 256)``, ``wvb (27, 128)``,
    ``wa (256, 1)``, ``wr (128, 3)`` and ``b1, b3, b5, b7 (256,)``,
    ``ba (1,)``, ``bv (128,)``, ``br (3,)``."""
    if not supports(model.config):
        raise ValueError(f"TP fused path: flagship architecture only, got "
                         f"{model.config}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"TP weights are float32 or bfloat16, not {dtype}")
    m = int(n_shards)
    if m < 1 or 256 % m:
        raise ValueError(f"{m} shards do not divide the hidden width 256")
    s = 256 // m
    layers = model.layers()
    with torch.no_grad():
        w = {name: layer.effective_weight().t().float().to(dtype)
             for name, layer in layers.items()}           # (in, out)
        b = {name: layer.bias.float().clone() for name, layer in layers.items()}
        full = {key: w[name] for key, name in _LAYER.items()}
        full["w5b"] = w["pts_linears.5"][63:]
        full["wva"] = w["views_linears.0"][:256]
        bias = {"b0": b["pts_linears.0"], "b2": b["pts_linears.2"],
                "b4": b["pts_linears.4"], "b6": b["pts_linears.6"],
                "bf": b["feature_linear"]}
        shards = {}
        for wc, (bk, wr) in _PAIRS.items():
            k = full[wc].shape[0]
            shards[wc] = full[wc].reshape(k, m, s).permute(1, 0, 2) \
                .contiguous()                               # (M, K, S)
            shards[bk] = bias[bk].reshape(m, s)
            shards[wr] = full[wr].reshape(m, s, -1).contiguous()  # (M,S,O2)
        reps = {"w5a": w["pts_linears.5"][:63].contiguous(),
                "wvb": w["views_linears.0"][256:].contiguous(),
                "wa": w["alpha_linear"].contiguous(),
                "wr": w["rgb_linear"].contiguous(),
                "b1": b["pts_linears.1"], "b3": b["pts_linears.3"],
                "b5": b["pts_linears.5"], "b7": b["pts_linears.7"],
                "ba": b["alpha_linear"], "bv": b["views_linears.0"],
                "br": b["rgb_linear"]}
    return shards, reps


def fused_pair_plain(x, wa, ba, wb, relu_mid: bool = True):
    """Plain PyTorch version of K-B6: ``act(x @ wa + ba) @ wb``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = torch.addmm(ba, x, wa)
    return torch.mm(F.relu(h) if relu_mid else h, wb)


def fused_pair_3xtf32_plain(x, wa, ba, wb, relu_mid: bool = True):
    """The arithmetic of K-B6 (``csrc/mlp_tp_pair.cu``) in plain PyTorch:
    ``act(x @ wa + ba) @ wb`` with every product as
    :func:`mlp_fused.matmul_3xtf32_plain` and the kernel's sums in two
    levels: 32 channels (of K for the first product, of S for the second)
    sum in a tile of their own, which joins the running sum in float32, in
    channel order; the first sum starts from the bias, the second from
    zero. A model of the kernel's arithmetic, not a fast path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mm = mlp_fused.matmul_3xtf32_plain
    h = ba.expand(x.shape[0], -1)
    for k0 in range(0, x.shape[1], 32):
        h = h + mm(x[:, k0:k0 + 32], wa[k0:k0 + 32])
    h = F.relu(h) if relu_mid else h
    out = torch.zeros(x.shape[0], wb.shape[1], dtype=x.dtype,
                      device=x.device)
    for s0 in range(0, h.shape[1], 32):
        out = out + mm(h[:, s0:s0 + 32], wb[s0:s0 + 32])
    return out


def fused_pair_bf16_plain(x, wa, ba, wb, relu_mid: bool = True):
    """Plain PyTorch version of K-B6 in bf16: ``bf16(act(bf16(x) @ wa +
    ba)) @ wb`` (mlp_tp_pallas.py:69-74) for float32 x and ba, bf16 wa and
    wb: products of bf16 values (exact in float32) summed in float32, the
    hidden tile rounded after the activation, a float32 result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = torch.addmm(ba, bf16_round(x), wa.float())
    return torch.mm(bf16_round(F.relu(h) if relu_mid else h), wb.float())


def _pair_call(name, plain, x, wa, ba, wb, relu_mid, wdtype):
    """Shared body of the two K-B6 wrappers: checks, the plain version for
    CPU tensors, the kernel ``nnc_<name>`` for CUDA tensors."""
    n, k = x.shape
    s, o2 = wb.shape
    _check("x", x, (n, k))
    _check("wa", wa, (k, s), wdtype)
    _check("ba", ba, (s,))
    _check("wb", wb, (s, o2), wdtype)
    device = x.device
    if any(t.device != device for t in (wa, ba, wb)):
        raise ValueError(f"{name}: weights and input must be on one device")
    if device.type == "cpu":
        return plain(x, wa, ba, wb, relu_mid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    ks = KERNEL_K_BF16 if wdtype == torch.bfloat16 else \
        range(1, KERNEL_MAX_K + 1)
    if k not in ks or s not in KERNEL_S or \
            (o2, bool(relu_mid)) not in KERNEL_HEADS:
        raise ValueError(f"{name}: no kernel for K={k}, S={s}, O2={o2}, "
                         f"relu_mid={relu_mid}")
    if wa.data_ptr() % 16 or wb.data_ptr() % 16:
        raise ValueError(f"{name}: wa and wb must be 16-byte aligned")
    if wdtype == torch.bfloat16 and k % 4 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned for K = 256")
    lib = _build.lib()
    out = torch.empty((n, o2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch(name)
        _build.check(getattr(lib, "nnc_" + name)(
            x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(),
            out.data_ptr(), n, k, s, o2, int(bool(relu_mid)), stream), name)
    return out


def fused_pair(x, wa, ba, wb, relu_mid: bool = True):
    """K-B6 wrapper: one shard's fused column + row pair, a partial sum.

    x (N, K), wa (K, S), ba (S,), wb (S, O2) -> (N, O2), contiguous float32
    on one device. CUDA tensors launch the kernel (3xTF32 products on the
    tensor cores, :func:`fused_pair_3xtf32_plain`'s arithmetic), which is
    compiled for K <= 256, S in {32, 64, 128, 256} and (O2, relu_mid) =
    (256, True) or (128, False), and needs wa and wb 16-byte aligned; CPU
    tensors take the plain version."""
    return _pair_call("mlp_tp_pair", fused_pair_plain, x, wa, ba, wb,
                      relu_mid, torch.float32)


def fused_pair_bf16(x, wa, ba, wb, relu_mid: bool = True):
    """K-B6 wrapper, bf16: x (N, K) and ba (S,) float32, wa (K, S) and
    wb (S, O2) torch.bfloat16 -> (N, O2) float32 partial sums of
    :func:`fused_pair_bf16_plain`'s function. CUDA tensors launch the
    kernel, which is compiled for K in {63, 256}, S in {32, 64, 128, 256}
    and (O2, relu_mid) = (256, True) or (128, False), and needs wa, wb and
    (for K = 256, read as float4) x 16-byte aligned; CPU tensors take the
    plain version."""
    return _pair_call("mlp_tp_pair_bf16", fused_pair_bf16_plain, x, wa, ba,
                      wb, relu_mid, torch.bfloat16)


Shard = Tuple[torch.device, Dict[str, torch.Tensor]]


def _tp_forward(embs: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]],
                shards: Sequence[Shard],
                reps: Dict[torch.device, Dict[str, torch.Tensor]],
                psum: Optional[Callable] = None):
    """The TP forward over every shard of the group, in lockstep.

    ``embs``: per distinct device the replicated ``(pts_emb (N, 63),
    views_emb (N, 27))``; ``shards``: per shard its device and its slice of
    :func:`shard_tp_weights`'s stacks; ``reps``: per distinct device the
    replicated remainder. Five pair calls per shard, a ``psum`` after each;
    the replicated pieces run once per distinct device. ``psum(parts,
    devices) -> {device: sum}`` defaults to :func:`parallel.psum`; a caller
    that times one shard's compute alone passes one shard and the identity.
    bf16 shards (:func:`place_tp_weights` with torch.bfloat16) run the bf16
    forward: the embeddings rounded once, the pairs through
    :func:`fused_pair_bf16`, ``h7`` and ``v`` rounded before their heads.
    Returns raw (N, 4) on the first shard's device."""
    psum = psum or parallel.psum
    devices = [d for d, _sh in shards]
    bf16 = shards[0][1]["w0"].dtype == torch.bfloat16
    fused = fused_pair_bf16 if bf16 else fused_pair
    rnd = bf16_round if bf16 else (lambda t: t)
    if bf16:
        torch.backends.cuda.matmul.allow_tf32 = False

    def pair(xs, wc, relu=True):
        bk, wr = _PAIRS[wc]
        return psum([fused(xs[d], sh[wc], sh[bk], sh[wr], relu)
                     for d, sh in shards], devices)

    def each(fn, *per_device):
        return {d: fn(reps[d], *(t[d] for t in per_device))
                for d in per_device[0]}

    pe = {d: rnd(e[0]) for d, e in embs.items()}
    ve = {d: rnd(e[1]) for d, e in embs.items()}
    h1 = each(lambda r, t: F.relu(t + r["b1"]), pair(pe, "w0"))
    h3 = each(lambda r, t: F.relu(t + r["b3"]), pair(h1, "w2"))
    h5 = each(lambda r, t, p: F.relu(t + torch.mm(p, r["w5a"]) + r["b5"]),
              pair(h3, "w4"), pe)
    h7 = each(lambda r, t: F.relu(t + r["b7"]), pair(h5, "w6"))
    v = each(lambda r, t, e: F.relu(t + torch.mm(e, r["wvb"]) + r["bv"]),
             pair(h7, "wf", relu=False), ve)
    first = devices[0]
    r = reps[first]
    alpha = torch.addmm(r["ba"], rnd(h7[first]), r["wa"])
    rgb = torch.addmm(r["br"], rnd(v[first]), r["wr"])
    return torch.cat([rgb, alpha], dim=-1)


def place_tp_weights(model: nerf.NeRF, devices: Sequence[torch.device],
                     dtype: torch.dtype = torch.float32):
    """``(shards, reps)`` as :func:`_tp_forward` takes them: shard i of
    M = len(devices) on ``devices[i]``, the remainder on each distinct one,
    weights in ``dtype``. In bf16 the shards keep :func:`shard_tp_weights`'
    bf16 tensors (K-B6 bf16's operands) and the remainder's weights become
    float32 tensors holding the same bf16 values."""
    stacks, reps = shard_tp_weights(model, len(devices), dtype)
    shards = [(d, {k: v[i].to(d) for k, v in stacks.items()})
              for i, d in enumerate(devices)]
    return shards, {d: {k: v.to(d).float() for k, v in reps.items()}
                    for d in dict.fromkeys(devices)}


def fused_nerf_mlp_tp(model: nerf.NeRF, pts_emb, views_emb,
                      mesh: parallel.Mesh):
    """Width-split tensor-parallel fused MLP over ``mesh``'s 'model' axis.

    The contract of ``mlp_fused.fused_nerf_mlp`` (flagship architecture
    only; (..., 63) / (..., 27) embeddings -> raw (..., 4) float32, on the
    first model device). The weights shard by width over the 'model' group;
    the point batch is replicated over it (a 'data' axis, if the mesh has
    one, is for the caller to split the batch over: every data row would
    compute the same here, so only the first one does).
    ``model.config.compute_dtype`` picks the float32 or the bf16 forward."""
    if not supports(model.config):
        raise ValueError(f"TP fused path: flagship architecture only, got "
                         f"{model.config}")
    if "model" not in mesh.axis_names:
        raise ValueError(f"the mesh has no 'model' axis: {mesh}")
    devices = mesh.axis_devices("model")
    dtype = model.config.compute_dtype
    kind = "tp_bf16" if dtype == torch.bfloat16 else "tp"
    shards, reps = PACKS.get(model, (kind, tuple(devices)),
                             lambda m: place_tp_weights(m, devices, dtype))
    lead = pts_emb.shape[:-1]
    pe = pts_emb.reshape(-1, 63).float().contiguous()
    ve = views_emb.reshape(-1, 27).float().contiguous()
    embs = {d: (pe.to(d), ve.to(d)) for d in dict.fromkeys(devices)}
    return _tp_forward(embs, shards, reps).reshape(*lead, 4)
