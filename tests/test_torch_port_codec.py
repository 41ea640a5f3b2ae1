"""nnc_tpu_torch's own codec stack against nnc_tpu's.

The port keeps its own copy of the NNR codec (``compression``, ``core``,
``coder``, ``hls``) and of the checkpoint and file-format helpers. For the
same parameters and arguments it must write the bytes ``nnc_tpu`` writes,
each package must decode the other's streams, and the port must decode every
committed golden bitstream to its stored expectation. Its CABAC library is
built under ``build/nnc_tpu_torch/``, apart from ``nnc_tpu``'s.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import golden_cases
from nnc_tpu import compression as ref_compression
from nnc_tpu_torch import coder, compression, hls
from nnc_tpu_torch.coder import cabac
from nnc_tpu_torch.core import approximator, model as nnr_model
from nnc_tpu_torch.framework import torch_io
from nnc_tpu_torch.hls import syntax
from nnc_tpu_torch.utils import ckpt
from nnc_tpu_torch.utils.logging import img2mse, mse2psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", golden_cases.GOLDEN_DIR_NAME)


def _nerf_shaped():
    """A small NeRF-shaped wrapper dict (model. / model_fine.) with
    ``weight_scaling`` companions on every matrix."""
    rng = np.random.default_rng(7)
    d = {}
    for prefix in ("model.", "model_fine."):
        dims = {"pts_linears.0": (63, 16), "pts_linears.1": (16, 16),
                "alpha_linear": (16, 1), "feature_linear": (16, 16),
                "views_linears.0": (16 + 27, 8), "rgb_linear": (8, 3)}
        for name, (din, dout) in dims.items():
            d[f"{prefix}{name}.weight"] = rng.normal(
                0, 0.1, (dout, din)).astype(np.float32)
            d[f"{prefix}{name}.weight_scaling"] = (
                1 + rng.normal(0, 0.02, (dout,))).astype(np.float32)
            d[f"{prefix}{name}.bias"] = rng.normal(
                0, 0.01, (dout,)).astype(np.float32)
    return d, dict(qp=-22, block_id_and_param_type=golden_cases._block_map(d))


CASES = dict(golden_cases.CODEC_CASES, nerf_lsa=_nerf_shaped)


def _assert_same(a, b):
    assert list(a.keys()) == list(b.keys())
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_compress_writes_the_reference_bytes(name):
    d, kwargs = CASES[name]()
    kw = dict(bitstream_path=None, verbose=False, return_bitstream=True,
              **kwargs)
    bs = compression.compress(dict(d), **kw)
    ref = ref_compression.compress(dict(d), **kw)
    assert bs == ref, (name, len(bs), len(ref))
    # each package decodes the other's stream to the same arrays
    own = compression.decompress(ref, verbose=False)
    theirs = ref_compression.decompress(bs, verbose=False)
    _assert_same(own, theirs)
    assert any(k.endswith("weight") or k == "w" for k in own)
    if name in golden_cases.CODEC_CASES:
        with open(os.path.join(GOLDEN_DIR, f"{name}.nnc"), "rb") as f:
            assert bs == f.read(), name


def _golden_npz_cases():
    out = []
    for sub in ("", "v1"):
        vdir = os.path.join(GOLDEN_DIR, sub)
        out += [os.path.join(sub, f[:-4]) for f in sorted(os.listdir(vdir))
                if f.endswith(".nnc") and f[:-4] != "full_oob_ipp0"
                and os.path.exists(os.path.join(vdir,
                                                f[:-4] + ".expected.npz"))]
    return out


@pytest.mark.parametrize("case", _golden_npz_cases())
def test_port_decodes_golden_bitstream(case):
    rec = compression.decompress(os.path.join(GOLDEN_DIR, case + ".nnc"),
                                 verbose=False)
    expected = np.load(os.path.join(GOLDEN_DIR, case + ".expected.npz"))
    assert set(rec.keys()) == set(expected.files)
    for k in expected.files:
        assert np.array_equal(rec[k], expected[k]), (case, k)


@pytest.mark.parametrize("sub", ["", "v1"])
def test_port_decodes_golden_unit_stream(sub):
    """The MPS / LPS performance-map stream (no NDUs)."""
    with open(os.path.join(GOLDEN_DIR, sub, "mps_lps_perfmaps.nnc"),
              "rb") as f:
        model_info, _ad = coder.decode(f.read())
    with open(os.path.join(GOLDEN_DIR, sub,
                           "mps_lps_perfmaps.expected.json")) as f:
        expected = json.load(f)
    surfaced = {"flags": model_info["performance_map_flags"],
                "maps": model_info["performance_maps"]}
    assert json.loads(json.dumps(surfaced, sort_keys=True)) == \
        json.loads(json.dumps(expected, sort_keys=True))


def test_port_writes_and_decodes_golden_oob_stream():
    """Fully out-of-band NDU headers: golden_cases.encode_oob_case rebuilt
    on the port's modules gives the committed bytes and tensors."""
    d = golden_cases._mlp_dict(909, layers=2, width=24, in_dim=16)
    mdl = nnr_model.NNRModel(d)
    params = mdl.init_model_from_dict(d)
    model_info = mdl.model_info
    model_info["topology_storage_format"] = \
        hls.TopologyStorageFormat.NNR_TPL_PYT
    approx_data = approximator.init_approx_data(params, model_info, 2, 0)
    ap_info = approximator.ApproxInfo(
        approx_data, model_info, "uniform", 0, -24, False, False, 10, 0.0)
    ad_enc = approximator.approx(ap_info.approx_info, model_info,
                                 approx_data, verbose=False)
    oob = coder.compile_ndu_oob(tensor_dims=True,
                                cabac_unary_length_minus1=10,
                                compressed_parameter_types=0)
    bs = bytes(coder.encode(
        {"cabac_unary_length_minus1": 10, "param_opt_flag": 0}, model_info,
        ad_enc, ndu_oob=oob))
    with open(os.path.join(GOLDEN_DIR, "full_oob_ipp0.nnc"), "rb") as f:
        golden = f.read()
    assert bs == golden
    ext = {"parameter_dimensions": dict(model_info["parameter_dimensions"]),
           "cabac_unary_length_minus1": 10}
    _info, ad = coder.decode(golden, model_info=ext, ndu_oob=oob)
    expected = np.load(os.path.join(GOLDEN_DIR, "full_oob_ipp0.expected.npz"))
    assert set(ad["parameters"].keys()) == set(expected.files)
    for k in expected.files:
        assert np.array_equal(ad["parameters"][k], expected[k]), k


def test_format_version_and_future_version_rejected():
    with open(os.path.join(GOLDEN_DIR, "FORMAT_VERSION")) as f:
        assert int(f.read().strip()) == hls.FORMAT_VERSION
    h = coder.compile_start_unit(0)
    h["nnc_tpu_format_version"] = hls.FORMAT_VERSION + 1
    with pytest.raises(ValueError, match="format version"):
        coder.decode(bytes(syntax.encode_unit(h)))


def test_cabac_library_is_the_ports_own():
    """The port compiles native/deepcabac.cpp into build/nnc_tpu_torch/ and
    loads that file; importing and using the port alone loads neither
    nnc_tpu nor the library under native/."""
    want = os.path.join(REPO, "build", "nnc_tpu_torch", "libdeepcabac.so")
    assert cabac._LIB == want
    assert cabac._SRC == os.path.join(REPO, "native", "deepcabac.cpp")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nnc_tpu'] = None\n"
        "import numpy as np\n"
        "import nnc_tpu_torch\n"
        "d = {'w': np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)}\n"
        "bs = nnc_tpu_torch.compress(d, bitstream_path=None, qp=-20, "
        "verbose=False, return_bitstream=True)\n"
        "rec = nnc_tpu_torch.decompress(bs, verbose=False)\n"
        "assert np.abs(rec['w'] - d['w']).max() < 0.05\n"
        "libs = sorted({l.split()[-1] for l in open('/proc/self/maps') "
        "if 'libdeepcabac' in l})\n"
        "print(libs)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == repr([want])
    assert os.path.exists(want) and os.path.exists(want + ".hostkey")


def test_ckpt_and_torch_io_round_trip(tmp_path):
    """A tiny nerf-pytorch .tar through the port's ckpt and torch_io: wrapper
    dict -> .tar -> wrapper dict, the codec's model instance from the file,
    compress_model from the .tar, decompress_model to a .pt, and back to a
    .tar."""
    d, kwargs = _nerf_shaped()
    sd = {k: v for k, v in d.items() if not k.endswith("weight_scaling")}
    tar = str(tmp_path / "tiny.tar")
    ckpt.wrapper_dict_to_nerf_tar(sd, tar, global_step=7)
    back, step = ckpt.nerf_tar_to_wrapper_dict(tar)
    assert step == 7
    _assert_same({k: np.asarray(v) for k, v in back.items()},
                 {k: sd[k] for k in back})
    assert set(back) == set(sd)

    _mdl, params = torch_io.create_NNC_model_instance_from_file(tar)
    assert set(params) == set(sd)
    bs_path = str(tmp_path / "tiny.nnc")
    pt = str(tmp_path / "tiny.pt")
    compression.compress_model(tar, bitstream_path=bs_path, qp=-24,
                               verbose=False)
    ref = ref_compression.compress_model(
        tar, bitstream_path=str(tmp_path / "ref.nnc"), qp=-24, verbose=False,
        return_bitstream=True)
    with open(bs_path, "rb") as f:
        assert f.read() == ref
    rec = compression.decompress_model(bs_path, model_path=pt, verbose=False)
    assert set(rec) == set(sd)
    stepsize = 2.0 ** (-24 / 4.0)
    assert max(np.abs(rec[k] - sd[k]).max() for k in sd) <= stepsize
    saved = torch.load(pt, map_location="cpu")
    _assert_same({k: np.asarray(v) for k, v in saved.items()},
                 {k: rec[k] for k in saved})
    tar2 = str(tmp_path / "tiny_rec.tar")
    ckpt.convert_nerfwrapper_to_nerf_ckpt(pt, tar2)
    again, _ = ckpt.nerf_tar_to_wrapper_dict(tar2)
    _assert_same({k: np.asarray(v) for k, v in again.items()},
                 {k: rec[k] for k in again})


def test_img2mse_takes_tensors_and_arrays():
    rng = np.random.default_rng(0)
    a, b = rng.random((4, 5, 3), np.float32), rng.random((4, 5, 3), np.float32)
    want = float(np.mean((a - b) ** 2))
    assert abs(float(img2mse(a, b)) - want) < 1e-7
    got = img2mse(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.is_tensor(got) and abs(float(got) - want) < 1e-7
    assert abs(mse2psnr(float(got)) + 10 * np.log10(want)) < 1e-4
