"""K-B5 and K-B6 of nnc_tpu_torch in bf16, and the bf16 tensor-parallel
forward, against the JAX package with ``compute_dtype=jnp.bfloat16`` (CPU;
the Pallas kernels run their bf16 bodies in interpret mode, JAX's meshes
over the 8 virtual CPU devices of tests/conftest.py).

A bf16 result is held to the reference's bf16 result in units of the
reference's own bf16-to-float32 distance on the same network and inputs
(tests/test_torch_port_bf16.py): rms error <= 1/8 of the distance's rms and
max error <= 1/2 of its max. What is exact is held exactly: the sharded bf16
weights, and the wrappers' CPU route (the plain versions' bits).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu import parallel as jparallel
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas, mlp_tp_pallas
from nnc_tpu_torch import parallel as tparallel
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused, mlp_tp_fused
from nnc_tpu_torch.tools import tp_mlp_bench

BF16_J = jnp.bfloat16
BF16_T = torch.bfloat16
CPU = dict(devices=["cpu"])


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_within_bf16_distance(got, want_bf16, want_f32, what=""):
    err, dist = got - want_bf16, want_bf16 - want_f32
    assert _rms(dist) > 0, what
    assert _rms(err) <= _rms(dist) / 8, (what, _rms(err), _rms(dist))
    assert np.abs(err).max() <= np.abs(dist).max() / 2, \
        (what, np.abs(err).max(), np.abs(dist).max())


def _flagship(seed, with_ls):
    """Activated full-width weights (and LSA scales 1 +- 0.05) as the JAX
    pytrees and the port's bf16 model of them."""
    params = jax.tree.map(np.asarray, jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(seed), jnerf.NeRFConfig()), seed))
    ls = None
    if with_ls:
        rng = np.random.default_rng(seed + 100)
        ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
              .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(
        params, tnerf.NeRFConfig(compute_dtype=BF16_T), ls=ls)
    jls = None if ls is None else {k: jnp.asarray(v) for k, v in ls.items()}
    return jax.tree.map(jnp.asarray, params), jls, model


@pytest.fixture(scope="module")
def flagship():
    return _flagship(0, True)


def _embeddings(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 63)).astype(np.float32),
            rng.standard_normal((n, 27)).astype(np.float32))


CFG16 = jnerf.NeRFConfig(compute_dtype=BF16_J)


def _dense32(jparams, jls, pe, ve):
    """The reference's float32 MLP on the same network and embeddings: the
    far end of the bf16-to-float32 distance (its fused and tensor-parallel
    forms equal it to float32 rounding)."""
    return np.asarray(jnerf.apply_mlp(jparams, jnp.asarray(pe),
                                      jnp.asarray(ve), jnerf.NeRFConfig(),
                                      ls=jls))


# K-B5 ------------------------------------------------------------------------
@pytest.mark.parametrize("with_ls", [True, False], ids=["ls", "no-ls"])
def test_fused_nerf_mlp_bf16_matches_pallas(with_ls):
    """The model-level K-B5 of a bf16 model against the reference's Pallas
    kernel in its bf16 body, 700 points (no multiple of its 2,048 tile)."""
    jparams, jls, model = _flagship(3, with_ls)
    pe, ve = _embeddings(700, 4)
    want16 = np.asarray(mlp_pallas.fused_nerf_mlp(
        jparams, jls, jnp.asarray(pe), jnp.asarray(ve), CFG16))
    want32 = _dense32(jparams, jls, pe, ve)
    with torch.no_grad():
        got = mlp_fused.fused_nerf_mlp(model, torch.from_numpy(pe),
                                       torch.from_numpy(ve))
    assert got.dtype == torch.float32 and got.shape == (700, 4)
    _assert_within_bf16_distance(got.numpy(), want16, want32)


def test_fused_nerf_mlp_bf16_cpu_route_is_the_plain_version(flagship):
    """On CPU tensors the wrapper gives the bits of the plain bf16 version on
    packed_bf16_for(model), a PACKS entry that the second call hits; no
    kernel is counted."""
    *_, model = flagship
    pe, ve = (torch.from_numpy(a) for a in _embeddings(300, 5))
    before = _build.launch_counts()
    with torch.no_grad():
        got = mlp_fused.fused_nerf_mlp(model, pe.reshape(3, 100, 63),
                                       ve.reshape(3, 100, 27))
        hits, misses = mlp_fused.PACKS.hits, mlp_fused.PACKS.misses
        buf = mlp_fused.packed_bf16_for(model)
        assert (mlp_fused.PACKS.hits, mlp_fused.PACKS.misses) == \
            (hits + 1, misses)
        want = mlp_fused.fused_nerf_mlp_bf16_plain(buf, pe, ve)
        again = mlp_fused.mlp_embedded_bf16(buf, pe, ve)
    assert got.shape == (3, 100, 4)
    assert torch.equal(got.reshape(300, 4), want) and torch.equal(again, want)
    assert torch.equal(buf, mlp_fused.pack_weights_bf16(model))
    assert _build.launch_counts() == before
    assert "bf16_mma" in mlp_fused.PACKS._entries[model]
    # the plain version computes the dense plain bf16 MLP of the model; the
    # two reach BLAS with operands of other shapes (packed (in, out) weights
    # against torch's (out, in)), whose float32 sums MKL orders otherwise:
    # held in units of the bf16-to-float32 distance, not bit for bit
    with torch.no_grad():
        dense = tnerf.apply_mlp(model, pe, ve)
        plain32 = mlp_fused.fused_nerf_mlp_plain(
            mlp_fused.pack_weights(model), pe, ve)
    _assert_within_bf16_distance(dense.numpy(), want.numpy(),
                                 plain32.numpy())


def test_fused_nerf_mlp_bf16_plain_chunks_and_empty(flagship, monkeypatch):
    """The plain version in PLAIN_CHUNK pieces computes what one piece does
    (MKL sums in an order that follows the operands' shapes, so the bars are
    the bf16 distance's), and takes no points."""
    *_, model = flagship
    pe, ve = (torch.from_numpy(a) for a in _embeddings(300, 6))
    buf = mlp_fused.packed_bf16_for(model)
    whole = mlp_fused.fused_nerf_mlp_bf16_plain(buf, pe, ve)
    plain32 = mlp_fused.fused_nerf_mlp_plain(mlp_fused.pack_weights(model),
                                             pe, ve)
    monkeypatch.setattr(mlp_fused, "PLAIN_CHUNK", 128)
    _assert_within_bf16_distance(
        mlp_fused.fused_nerf_mlp_bf16_plain(buf, pe, ve).numpy(),
        whole.numpy(), plain32.numpy())
    empty = mlp_fused.fused_nerf_mlp_bf16_plain(buf, pe[:0], ve[:0])
    assert empty.shape == (0, 4) and empty.dtype == torch.float32
    with pytest.raises(ValueError, match="int32"):
        mlp_fused.mlp_embedded_bf16(buf.float(), pe, ve)


def test_int8_route_ignores_compute_dtype():
    """K-B4 quantizes from the float32 weights whatever compute_dtype, as
    the reference's does."""
    model = tnerf.init_params(tnerf.NeRFConfig(compute_dtype=BF16_T),
                              torch.Generator().manual_seed(0))
    f32 = tnerf.init_params(tnerf.NeRFConfig(),
                            torch.Generator().manual_seed(0))
    pts = torch.linspace(-1, 1, 12).reshape(4, 3)
    with torch.no_grad():
        raw = mlp_fused.fused_nerf_mlp_int8_from_points(model, pts, pts + 1.0)
        raw32 = mlp_fused.fused_nerf_mlp_int8_from_points(f32, pts, pts + 1.0)
    assert raw.shape == (4, 4) and torch.equal(raw, raw32)


# K-B6 ------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 4])
def test_shard_tp_weights_bf16_match_reference(flagship, m):
    """bf16(ls * W) shard for shard, bit for bit, the biases float32, the
    reference's TPU padding stripped."""
    jparams, jls, model = flagship
    want_sh, want_rep = mlp_tp_pallas.shard_tp_weights(jparams, jls, m,
                                                       BF16_J)
    shards, reps = mlp_tp_fused.shard_tp_weights(model, m, BF16_T)
    assert set(shards) == set(want_sh) and set(reps) == set(want_rep)
    bits = lambda a: np.asarray(a, np.float32).view(np.uint32)
    for key, got in shards.items():
        want = want_sh[key]
        assert got.dtype == (torch.float32 if key.startswith("b")
                             else BF16_T), key
        if key == "w0":
            assert not bits(want[:, 63:]).any()  # the packed input's padding
            want = want[:, :63]
        elif key.startswith("b"):
            want = want[:, 0]                    # (M, 1, S) -> (M, S)
        np.testing.assert_array_equal(bits(got.float()), bits(want),
                                      err_msg=key)
    strip = {"w5a": lambda w: w[:63], "wvb": lambda w: w[64:91],
             "wa": lambda w: w[:, 3:4], "wr": lambda w: w[:, :3],
             "ba": lambda b: b[0, 3:4], "br": lambda b: b[0, :3]}
    for key, got in reps.items():
        want = want_rep[key]
        want = strip[key](want) if key in strip else want[0]
        np.testing.assert_array_equal(bits(got.float()), bits(want),
                                      err_msg=key)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mlp_tp_fused.shard_tp_weights(model, m, torch.float16)


def _pair_operands(k, s, o2, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2048, k)).astype(np.float32),
            (rng.standard_normal((k, s)) / np.sqrt(k)).astype(np.float32),
            rng.standard_normal(s).astype(np.float32),
            (rng.standard_normal((s, o2)) / np.sqrt(s)).astype(np.float32))


@pytest.mark.parametrize("k,s,o2,relu_mid", [(63, 64, 256, True),
                                             (256, 64, 256, True),
                                             (256, 64, 128, False)])
def test_fused_pair_bf16_plain_matches_pallas(k, s, o2, relu_mid):
    """The forward's pair shapes at M = 4, N = 2,048, against the Pallas
    pair kernel on bf16 operands (its hidden tile rounded to bf16), in units
    of its distance from the float32 pair of the unrounded operands."""
    x, wa, ba, wb = _pair_operands(k, s, o2, k + o2 + 1)
    j = jnp.asarray
    want16 = np.asarray(mlp_tp_pallas.fused_pair(
        j(x).astype(BF16_J), j(wa).astype(BF16_J), j(ba)[None],
        j(wb).astype(BF16_J), relu_mid=relu_mid, interpret=True))
    want32 = np.asarray(mlp_tp_pallas.fused_pair(
        j(x), j(wa), j(ba)[None], j(wb), relu_mid=relu_mid, interpret=True))
    t = torch.from_numpy
    args = (t(x), t(wa).bfloat16(), t(ba), t(wb).bfloat16(), relu_mid)
    before = _build.launch_counts()
    got = mlp_tp_fused.fused_pair_bf16(*args)
    assert _build.launch_counts() == before    # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (2048, o2)
    assert torch.equal(got, mlp_tp_fused.fused_pair_bf16_plain(*args))
    _assert_within_bf16_distance(got.numpy(), want16, want32)


def test_fused_pair_bf16_refuses_float32_weights_and_other_devices():
    x, wa, ba, wb = (torch.from_numpy(a) for a in
                     _pair_operands(63, 64, 256, 0))
    with pytest.raises(ValueError, match="bfloat16"):
        mlp_tp_fused.fused_pair_bf16(x, wa, ba, wb)
    with pytest.raises(ValueError, match="float32"):
        mlp_tp_fused.fused_pair(x, wa.bfloat16(), ba, wb.bfloat16())
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (x, wa.bfloat16(), ba, wb.bfloat16())]
    with pytest.raises(ValueError, match="device"):
        mlp_tp_fused.fused_pair_bf16(*meta)


@pytest.mark.parametrize("m", [2, 4])
def test_fused_nerf_mlp_tp_bf16_matches_reference_and_dense(flagship, m):
    """The bf16 TP forward on a CPU mesh of M against the reference's on a
    'model' mesh of M JAX devices, and against the dense plain bf16 MLP."""
    jparams, jls, model = flagship
    pe, ve = _embeddings(1500, 10 + m)
    jmesh = jparallel.make_mesh(m, ("model",))
    want16 = np.asarray(mlp_tp_pallas.fused_nerf_mlp_tp(
        jparams, jls, jnp.asarray(pe), jnp.asarray(ve), CFG16, jmesh))
    want32 = _dense32(jparams, jls, pe, ve)
    mesh = tparallel.make_mesh(m, ("model",), **CPU)
    t = torch.from_numpy
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(model, t(pe), t(ve), mesh)
        dense = tnerf.apply_mlp(model, t(pe), t(ve))
    assert got.shape == (1500, 4)
    _assert_within_bf16_distance(got.numpy(), want16, want32, "reference")
    _assert_within_bf16_distance(got.numpy(), dense.numpy(), want32, "dense")


def test_tp_bf16_placement_and_cache(flagship):
    """place_tp_weights in bf16: the shards' weights bf16 tensors (K-B6
    bf16's operands), biases float32, the replicated weights float32 tensors
    holding the same bf16 values; fused_nerf_mlp_tp caches them under their
    own kind beside the float32 placement of a float32 model."""
    *_, model = flagship
    devices = [torch.device("cpu")] * 2
    shards, reps = mlp_tp_fused.place_tp_weights(model, devices, BF16_T)
    stacks, rep16 = mlp_tp_fused.shard_tp_weights(model, 2, BF16_T)
    for i, (d, sh) in enumerate(shards):
        for key, v in sh.items():
            assert v.dtype == stacks[key].dtype and torch.equal(v,
                                                                stacks[key][i])
    (cpu_reps,) = reps.values()
    for key, v in cpu_reps.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, rep16[key].float())
        assert torch.equal(v, mlp_fused.bf16_round(v)) or key.startswith("b")
    mesh = tparallel.make_mesh(2, ("model",), **CPU)
    pe, ve = (torch.from_numpy(a) for a in _embeddings(40, 7))
    with torch.no_grad():
        first = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
        hits, misses = mlp_fused.PACKS.hits, mlp_fused.PACKS.misses
        again = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
    assert (mlp_fused.PACKS.hits, mlp_fused.PACKS.misses) == \
        (hits + 1, misses)
    assert torch.equal(first, again)
    kinds = set(mlp_fused.PACKS._entries[model])
    assert ("tp_bf16", tuple(devices)) in kinds
    assert ("tp", tuple(devices)) not in kinds


# the tool --------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tp_mlp_bench_runs_on_cpu(dtype, capsys):
    out = tp_mlp_bench.main(["3000", "--device", "cpu", "--dtype", dtype])
    text = capsys.readouterr().out
    assert out["n"] == 3000 and out["dtype"] == dtype
    assert set(out["shard_ms"]) == {1, 2, 4}
    assert all(ms > 0 for ms in (out["kb5_ms"], *out["shard_ms"].values()))
    assert out["launches"] == {}          # CPU: the plain versions
    assert "K-B5 over the full width" in text and "TP shard M=4" in text
    assert "LOSES" not in text and "verdict" not in text


def test_tp_mlp_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp_mlp_bench.main(["64"])
