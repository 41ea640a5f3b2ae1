"""K-B3 bf16's warpgroup chain (ops/csrc/nerf_mlp_wgmma.cuh) as far as the CPU
reaches it: the weight slabs that ``mlp_fused.repack_bf16_wgmma`` lays out as
the shared-memory images a ``wgmma`` descriptor reads, the wrapper's checks
of that buffer, and the CPU route of the wrapper; the slabs' values against
the JAX package's bf16 packing (``mlp_pallas._pack_weights``) bit for bit.

The swizzle is checked against a model of its own, written from the
hardware's rule rather than from the packing's index arithmetic: in a
K-major operand with the 128-byte swizzle, the byte at shared address a
holds the byte of the unswizzled image at a ^ (((a >> 7) & 7) << 4), the
16-byte chunk index (address bits 4-6) XOR the row within the 8-row atom
(bits 7-9), every atom 1,024-byte aligned. Unswizzled, a slab is blocks of
64 depth rows, each block n_out rows (output channels) of 128 bytes.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused

SLAB_BYTES = 32768


@pytest.fixture(scope="module")
def net():
    """Activated full-width weights from a seed with LSA scales 1 +- 0.05:
    the JAX pytrees and the port's bf16 model of them."""
    cfg32 = jnerf.NeRFConfig()
    params = jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(3), cfg32), 3)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(103)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(
        params, tnerf.NeRFConfig(compute_dtype=torch.bfloat16), ls=ls)
    jparams = jax.tree.map(jnp.asarray, params)
    jls = {k: jnp.asarray(v) for k, v in ls.items()}
    return cfg32, jparams, jls, model


def _unswizzle(slab_words, n_out):
    """One 32 KB slab of the wgmma buffer (int32 words) read back as the
    (depth, n_out) matrix of bf16 bit patterns it holds, by the address-bit
    model of the module docstring."""
    phys = slab_words.astype(np.int32).view(np.uint8)
    a = np.arange(SLAB_BYTES)
    logical = np.empty_like(phys)
    logical[a ^ (((a >> 7) & 7) << 4)] = phys
    vals = logical.view(np.uint16)           # [block][n][64 of the depth]
    blocks = vals.size // (n_out * 64)
    return vals.reshape(blocks, n_out, 64).transpose(0, 2, 1) \
        .reshape(blocks * 64, n_out)


def _bits(a):
    """float32 values that are bf16 values -> their bf16 bit patterns."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32)
    assert not (u & 0xFFFF).any(), "not a bf16 value"
    return (u >> 16).astype(np.uint16)


def _run_slabs():
    """[(run, first depth row of the slab within the run, slab index)] of
    the 37 slabs, in MMA_RUNS' order."""
    out, slab = [], 0
    for run in mlp_fused.MMA_RUNS:
        name, _row0, _rows, padded = run
        n_out = 128 if name == "views_linears.0" else 256
        per = mlp_fused.WG_SLAB_ROWS[n_out]
        for first in range(0, padded, per):
            out.append((run, first, slab))
            slab += 1
    return out


def test_wgmma_buffer_shape_and_slab_schedule():
    slabs = _run_slabs()
    assert len(slabs) == mlp_fused.BF16_SLABS == 37
    assert mlp_fused.WG_SIZE * 4 == 37 * SLAB_BYTES == 1_212_416
    assert mlp_fused.WG_INDEX.size == 2 * mlp_fused.WG_SIZE
    # every bf16 weight of the slabs exactly once; the rest is zero padding:
    # pts_linears.0's and the skip's 64th row, views' rows 27..127
    pad = mlp_fused.BF16_SLAB_INDEX.size
    real = mlp_fused.WG_INDEX[mlp_fused.WG_INDEX != pad]
    assert real.size == np.unique(real).size == 595_844 - 2_436 - 256 - 384
    assert (mlp_fused.WG_INDEX == pad).sum() == 256 + 256 + 101 * 128


@pytest.mark.parametrize("n_out,depth", [(256, 64), (128, 128), (256, 256),
                                         (64, 64)])
def test_wgmma_positions_follow_the_address_bits(n_out, depth):
    """wgmma_positions against the swizzle's rule on the address bits."""
    pos = mlp_fused.wgmma_positions(n_out, depth)
    k = np.arange(depth)[:, None]
    n = np.arange(n_out)[None, :]
    logical = (k // 64) * n_out * 128 + n * 128 + (k % 64) * 2
    phys = logical ^ (((logical >> 7) & 7) << 4)
    np.testing.assert_array_equal(2 * pos, phys)
    assert np.unique(pos).size == pos.size == depth * n_out


def test_wgmma_image_of_a_matrix_unswizzles_to_it():
    rng = np.random.default_rng(5)
    for depth, n_out in ((64, 256), (128, 128)):
        w = torch.from_numpy(rng.standard_normal((depth, n_out))
                             .astype(np.float32)).to(torch.bfloat16)
        img = mlp_fused.wgmma_image(w).view(torch.int32).numpy()
        got = _unswizzle(img, n_out)
        np.testing.assert_array_equal(got, w.view(torch.int16).numpy()
                                      .view(np.uint16))


@pytest.mark.parametrize("run", range(len(mlp_fused.MMA_RUNS)))
def test_wgmma_slabs_unswizzle_to_the_bf16_weights(net, run):
    """Every slab of a run, un-swizzled by the independent model, holds
    unpack_weights_bf16's bf16 weights of its depth rows in slab order, the
    padded depth rows zero; and they are the reference's bf16(ls * W)
    (mlp_pallas._pack_weights) bit for bit."""
    _cfg32, jparams, jls, model = net
    buf = mlp_fused.packed_bf16_for(model)
    wg = mlp_fused.repack_bf16_wgmma(buf)
    assert wg.dtype == torch.int32 and wg.shape == (mlp_fused.WG_SIZE,)
    words = wg.numpy()
    L = mlp_fused.unpack_weights_bf16(buf)
    packed_j, _b = mlp_pallas._pack_weights(jparams, jls, jnp.bfloat16)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    ref = {"pts_linears.0": f32(packed_j["w0"])[:63],
           **{f"pts_linears.{i}": f32(packed_j[f"w{i}"])
              for i in (1, 2, 3, 4, 6, 7)},
           "pts_linears.5": np.concatenate([f32(packed_j["w5a"])[:63],
                                            f32(packed_j["w5b"])]),
           "feature_linear": f32(packed_j["wf"]),
           "views_linears.0": np.concatenate([f32(packed_j["wva"]),
                                              f32(packed_j["wvb"])[64:91]])}
    want_run = mlp_fused.MMA_RUNS[run]
    name, row0, rows, padded = want_run
    n_out = 128 if name == "views_linears.0" else 256
    per = mlp_fused.WG_SLAB_ROWS[n_out]
    w = L[name][0].numpy()
    assert _bits(w).tobytes() == _bits(ref[name]).tobytes()
    seen = 0
    for r, first, slab in _run_slabs():
        if r != want_run:
            continue
        seen += 1
        got = _unswizzle(words[slab * 8192:(slab + 1) * 8192], n_out)
        want = np.zeros((per, n_out), dtype=np.uint16)
        take = max(0, min(per, rows - first))
        want[:take] = _bits(w[row0 + first:row0 + first + take])
        np.testing.assert_array_equal(got, want, f"{name} slab {slab}")
    assert seen == -(-padded // per)


def test_wgmma_wrapper_checks_packed_wg(net):
    model = net[-1]
    buf = mlp_fused.packed_bf16_for(model)
    wg = mlp_fused.repack_bf16_wgmma(buf)
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.uniform(-2, 2, (50, 3)).astype(np.float32))
    vd = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    bad = [wg[:-1], wg[:-8192], wg.float(), wg.view(torch.int16),
           torch.cat([wg, wg])[::2], wg[None],
           torch.empty(mlp_fused.WG_SIZE, dtype=torch.int32, device="meta")]
    for b in bad:
        with pytest.raises(ValueError):
            mlp_fused.mlp_from_points_bf16(buf, pts, vd, packed_wg=b)
    with pytest.raises(ValueError):   # the slabs' buffer is no bf16 buffer
        mlp_fused.mlp_from_points_bf16(wg, pts, vd)
    with pytest.raises(ValueError):
        mlp_fused.repack_bf16_wgmma(buf[:-1])
    with pytest.raises(ValueError):
        mlp_fused.repack_bf16_wgmma(buf.float())


def test_wgmma_cpu_route_takes_the_plain_version(net):
    """CPU tensors take the plain bf16 version whether or not packed_wg is
    given, launch nothing, and the model-level entry makes no wgmma buffer
    for them."""
    model = net[-1]
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.uniform(-2, 2, (70, 3)).astype(np.float32))
    vd = torch.from_numpy(rng.standard_normal((70, 3)).astype(np.float32))
    buf = mlp_fused.packed_bf16_for(model)
    want = mlp_fused.fused_nerf_mlp_from_points_bf16_plain(buf, pts, vd)
    before = _build.launch_counts()
    assert torch.equal(mlp_fused.mlp_from_points_bf16(buf, pts, vd), want)
    assert torch.equal(mlp_fused.mlp_from_points_bf16(
        buf, pts, vd, packed_wg=mlp_fused.repack_bf16_wgmma(buf)), want)
    misses = mlp_fused.PACKS.misses
    got = mlp_fused.fused_nerf_mlp_from_points(model, pts[None], vd[None])
    assert torch.equal(got[0], want)
    assert mlp_fused.PACKS.misses == misses   # bf16_mma cached, no wgmma
    assert _build.launch_counts() == before


def test_wgmma_buffer_is_cached_per_model(net):
    model = net[-1]
    a = mlp_fused.packed_wg_for(model)
    assert a is mlp_fused.packed_wg_for(model)
    assert torch.equal(a, mlp_fused.repack_bf16_wgmma(
        mlp_fused.packed_bf16_for(model)))

