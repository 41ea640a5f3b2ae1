"""nnc_tpu_torch imports no JAX and has no CPU fallback for CUDA work.

The machine with the card has no JAX: every module of the port, and
chip_smoke.py, must import with ``jax`` blocked. Where PyTorch sees no CUDA
device, asking the port for CUDA raises instead of computing on the CPU.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nnc_tpu_torch
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import mlp_fused
from nnc_tpu_torch.render import renderer
from nnc_tpu_torch.utils.device import require_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nnc_tpu_torch")


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import nnc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "nnc_tpu_torch.__path__, 'nnc_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "assert sys.modules['jax'] is None and loaded == ['jax'], loaded\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("forbidden", [
    "jax", "nnc_tpu.render", "nnc_tpu.ops", "nnc_tpu.models",
    "nnc_tpu.data.rays", "nnc_tpu.data.synthetic", "nnc_tpu.train",
    "nnc_tpu.framework.executer", "nnc_tpu.utils.platform", "compress_nerf"])
def test_no_jax_loading_imports(forbidden):
    paths = list(_sources()) + [os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        for mod in _imported_modules(path):
            assert not (mod == forbidden or mod.startswith(forbidden + ".")), \
                (path, mod)


def test_no_try_around_kernel_build_or_launch():
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        require_cuda()


def test_cuda_work_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = nerf.NeRF(nerf.NeRFConfig())
    rc = renderer.RenderConfig(n_samples=8, n_importance=0,
                               use_fused_mlp=True,
                               use_fused_compositing=True)
    rays = np.zeros((4, 3), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        renderer.render_image(model, None, rays, rays + 1, 2.0, 6.0, rc,
                              device="cuda")
    # the library default device is the card: no silent CPU run
    sd = nerf.params_to_state_dict(model, "model.")
    sd.update(nerf.params_to_state_dict(model, "model_fine."))
    scene = {"images": np.zeros((2, 4, 4, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        nnc_tpu_torch.compress_model(sd, bitstream_path=str(tmp_path / "b"),
                                     ioq=True, scene=scene, verbose=False)


def test_kernel_wrapper_refuses_other_devices():
    meta = torch.empty(mlp_fused.PARAMS_SIZE, device="meta")
    pts = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        mlp_fused.mlp_from_points(meta, pts, pts)
