"""nnc_tpu_torch imports no JAX, nothing of nnc_tpu, and has no CPU fallback
for CUDA work.

The port is a package of its own: every module of it, and chip_smoke.py,
must import with ``jax`` and ``nnc_tpu`` blocked. Where PyTorch sees no CUDA
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
        "sys.modules['nnc_tpu'] = None\n"
        "import nnc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "nnc_tpu_torch.__path__, 'nnc_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for n in ('parallel', 'parallel.multi_scene', 'ops.mlp_tp_fused',"
        " 'graft_entry', 'tools.bench_train_step', 'tools.tp_mlp_bench',"
        " 'render.occupancy', 'data.deepvoxels', 'data.linemod',"
        " 'train.classification', 'framework.torch_executer',"
        " 'framework.use_cases', 'data.imagenet',"
        " 'train.evaluation_nerf_mock', 'utils.profiling', 'utils.platform',"
        " 'tools.demo_synthetic', 'tools.merge_rd', 'tools.rd_sweep',"
        " 'tools.profile_codec', 'tools.render_video',"
        " 'tools.multi_scene', 'tools.render_work',"
        " 'tools.bench_render_v2', 'tools.tune_fast_mode',"
        " 'tools.profile_fast_frame', 'bench', 'utils.contenders',"
        " 'tools.bench_loops'):"
        " assert 'nnc_tpu_torch.' + n in names, n\n"
        "import chip_smoke\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "assert sys.modules['jax'] is None and loaded == ['jax'], loaded\n"
        "ref = sorted(m for m in sys.modules if m == 'nnc_tpu' or "
        "m.startswith('nnc_tpu.'))\n"
        "assert sys.modules['nnc_tpu'] is None and ref == ['nnc_tpu'], ref\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 72


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("forbidden", [
    "jax", "nnc_tpu", "nnc_tpu.render", "nnc_tpu.ops", "nnc_tpu.models",
    "nnc_tpu.data.rays", "nnc_tpu.data.synthetic", "nnc_tpu.train",
    "nnc_tpu.framework.executer", "nnc_tpu.utils.platform", "compress_nerf"])
def test_no_jax_loading_imports(forbidden):
    paths = list(_sources()) + [os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        for mod in _imported_modules(path):
            assert not (mod == forbidden or mod.startswith(forbidden + ".")), \
                (path, mod)


# The copied host-only files that hold a ``try``: each guards an optional
# package, a file or a value that may not parse. A file not named here may
# hold none, so a new module is checked by default.
TRY_ALLOWED = ("hls/syntax.py", "coder/cabac.py", "framework/torch_io.py",
               "utils/config_txt.py", "utils/video.py",
               "utils/contenders.py")
KERNEL_SIDE = {"ops", "render", "_build", "mlp_fused", "render_fused",
               "mlp_train_fused", "mlp_tp_fused", "renderer", "parallel",
               "multi_scene", "graft_entry"}


def _names_imported(tree):
    """Every dotted component that an import statement of ``tree`` names,
    relative or absolute, plus any way of importing by a string."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield from a.name.split(".")
        elif isinstance(node, ast.ImportFrom):
            yield from (node.module or "").split(".")
            for a in node.names:
                yield from a.name.split(".")
        elif isinstance(node, ast.Name) and node.id in ("importlib",
                                                        "__import__"):
            yield node.id
        elif isinstance(node, ast.Attribute) and node.attr == "import_module":
            yield "importlib"


def test_no_try_around_kernel_build_or_launch():
    seen = set()
    for path in _sources():
        rel = os.path.relpath(path, PKG).replace(os.sep, "/")
        tree = ast.parse(open(path).read(), path)
        if rel not in TRY_ALLOWED:
            assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
                path
            continue
        seen.add(rel)
        # such a file can reach no kernel: it imports nothing of the kernel
        # side, by statement or by string
        bad = (KERNEL_SIDE | {"importlib", "__import__"}) \
            & set(_names_imported(tree))
        assert not bad, (path, bad)
    assert seen == set(TRY_ALLOWED)
    # the tensor-parallel wrapper and the mesh modules are among the checked
    checked = {os.path.relpath(p, PKG).replace(os.sep, "/")
               for p in _sources()} - seen
    assert {"ops/mlp_tp_fused.py", "parallel/__init__.py",
            "parallel/multi_scene.py", "graft_entry.py",
            "ops/mlp_train_fused.py", "tools/bench_train_step.py",
            "tools/tp_mlp_bench.py"} <= checked


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
