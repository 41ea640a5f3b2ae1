"""NeRF model executer: the codec's callback for evaluating and testing.

Counterpart of ``nnc_tpu/framework/executer.py`` (reference:
framework/pytorch_model/__init__.py:922-1217). ``eval_model`` is IOQ's
render probe (one ray batch), ``test_model`` renders the test views, and
``tune_model`` trains the LSA scales (and, for fine-tuning, the biases)
against the dequantized weights by rendering training rays
(``train/lsa.py``), checkpointing and rendering the test views at every
i_save. With ``use_occupancy_renders`` the frame renders, and with
``use_occupancy_tuning`` the LSA loss, go through an occupancy grid built
from the fine network (``render/occupancy.py``) where the architecture has
the kernels (``mlp_fused.supports``); other architectures render and tune
exactly, as in the reference.

A scene's model tunes and renders on its ``lsa.route``. A mip-NeRF scene
(a ``mipnerf.MipRenderConfig``) has one network, the codec's ``model.*``
tensors; its MLP has no occupancy kernels, and a mesh is refused for it. A
mip-NeRF 360 scene (a ``mipnerf360.Mip360RenderConfig``) has two networks of
different shapes: the proposal MLP (``model.*``) and the NeRF MLP
(``model_fine.*``); it has no occupancy mode and no mesh either.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..core.model import ModelExecute
from ..data.rays import RayBatcher
from ..models import nerf
from ..ops import mlp_fused
from ..render import occupancy, renderer
from ..render.rays import get_rays_np, ndc_rays
from ..train import lsa
from ..utils.images import write_png
from ..utils.logging import mse2psnr, to8b
from ..utils.video import write_video
from .torch_io import save_to_torch_file

_CKPT = re.compile(r"ckpt_step(\d+)\.pt$")


class NeRFModelExecuter(ModelExecute):
    def __init__(self, scene, render_config: renderer.RenderConfig, *,
                 device, learning_rate=1e-4, epochs=2,
                 learning_rate_decay=0.1, n_iters=50000, i_save=10000,
                 n_rand=1024, seed=451, verbose=True, render_factor=0,
                 precrop_iters=0, precrop_frac=0.5, resume=False, mesh=None):
        lsa.route(render_config).refuse(mesh=mesh)
        self.resume = resume
        self.device = torch.device(device)
        # parallel.Mesh: LSA / fine-tuning steps run data-parallel over its
        # 'data' devices, the first of which must be ``device``
        self.mesh = mesh
        self.render_factor = int(render_factor)
        self.precrop_iters = int(precrop_iters)
        self.precrop_frac = float(precrop_frac)
        self.scene = scene
        self.rc = render_config
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.learning_rate_decay = learning_rate_decay
        self.n_iters = n_iters
        self.i_save = i_save
        self.n_rand = n_rand
        self.seed = seed
        self.verbose = verbose
        self.dataset_type = scene.get("dataset_type", "synthetic")

    # -- helpers ------------------------------------------------------------
    def _make_batcher(self):
        scene = self.scene
        base = RayBatcher(scene["images"], scene["poses"], scene["K"],
                          scene["i_train"], self.n_rand,
                          mode=scene.get("batching_mode", "image"),
                          seed=self.seed,
                          precrop_iters=self.precrop_iters,
                          precrop_frac=self.precrop_frac)
        if not scene.get("ndc", False):
            return base
        H, W, focal = scene["H"], scene["W"], float(scene["K"][0][0])
        device = self.device

        class NDCBatcher:
            def next_batch(_self):
                ro, rd, target = base.next_batch()
                vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
                ro_n, rd_n = ndc_rays(H, W, focal, 1.0,
                                      torch.as_tensor(ro, device=device),
                                      torch.as_tensor(rd, device=device))
                return ro_n, rd_n, vd.astype(np.float32), target

        return NDCBatcher()

    def _split_params(self, parameters):
        """(coarse, fine) modules on the device (``lsa.route``). Missing LSA
        scales stay absent: the reference's all-ones scales multiply exactly
        (tuning attaches them, lsa.trained_tensors)."""
        return lsa.route(self.rc).split_params(parameters, self.device)

    def _occupancy_grid(self, model_c, model_f, flag, **kw):
        """The grid of occupancy mode where ``rc``'s ``flag`` (read only
        where the architecture has the kernels) asks for one, from the fine
        network (the coarse one without a fine), else None (reference:
        executer.py:110-124, :253-270): over the NDC cube for NDC scenes,
        else over ``scene["aabb"]`` or (-2, 2)^3."""
        if lsa.route(self.rc).refusal is not None or \
                not mlp_fused.supports(self.rc.mlp) or \
                not getattr(self.rc, flag):
            return None
        if self.scene.get("ndc", False):
            aabb = ((-1.0,) * 3, (1.0,) * 3)
        else:
            aabb = self.scene.get("aabb", ((-2.0,) * 3, (2.0,) * 3))
        return occupancy.build_occupancy_grid(
            model_f if model_f is not None else model_c, lo=tuple(aabb[0]),
            hi=tuple(aabb[1]), **kw)

    def _render_poses(self, model_c, model_f, poses, savedir=None,
                      names=None, render_factor=0):
        """Render camera poses (``lsa.route``); returns (n, H, W, 3) numpy.
        With ``use_occupancy_renders`` one grid is built for the call and
        every pose renders through it (``occupancy.render_image_fast``).
        render_factor > 0 renders at (H//rf, W//rf) with focal/rf
        (reference: run_nerf.py:161-172)."""
        scene = self.scene
        H, W = scene["H"], scene["W"]
        K = np.asarray(scene["K"], np.float32)
        if render_factor:
            rf = int(render_factor)
            H, W = H // rf, W // rf
            K = K.copy()
            K[0, 0] /= rf; K[1, 1] /= rf; K[0, 2] /= rf; K[1, 2] /= rf
        is_ndc = bool(scene.get("ndc", False))
        render_view = lsa.route(self.rc, self._occupancy_grid(
            model_c, model_f, "use_occupancy_renders")).render_view
        rgbs = []
        for i, pose in enumerate(np.asarray(poses)):
            ro, rd = get_rays_np(H, W, K, pose[:3, :4])
            vd = None
            near, far = scene["near"], scene["far"]
            if is_ndc:
                vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
                ro, rd = ndc_rays(H, W, float(K[0][0]), 1.0,
                                  torch.as_tensor(ro, device=self.device),
                                  torch.as_tensor(rd, device=self.device))
                near, far = 0.0, 1.0
            rgb = render_view(model_c, model_f, ro, rd, near, far, vd,
                              self.device)
            rgbs.append(rgb)
            if savedir is not None:
                name = names[i] if names is not None else i
                write_png(os.path.join(savedir, f"{name:03d}.png"), to8b(rgb))
        return np.stack(rgbs)

    def _render_views(self, model_c, model_f, pose_indices, savedir=None):
        scene = self.scene
        rgbs = self._render_poses(model_c, model_f,
                                  scene["poses"][np.asarray(pose_indices)],
                                  savedir=savedir, names=pose_indices)
        psnrs = [mse2psnr(float(np.mean((rgbs[i] - scene["images"][vi]) ** 2)))
                 for i, vi in enumerate(pose_indices)]
        return rgbs, psnrs

    def _resume_point(self, basedir_save, model_c, model_f, biases=False):
        """The newest mid-tune checkpoint under ``basedir_save``: loads its
        scales, and with ``biases`` its fine-tuned biases, into the models;
        returns (its step, its optimizer state or None), or (0, None) when
        there is none."""
        rec_dir = os.path.join(basedir_save, "reconstructed")
        names = os.listdir(rec_dir) if os.path.isdir(rec_dir) else []
        steps = sorted(int(m.group(1)) for m in map(_CKPT.match, names) if m)
        if not steps:
            return 0, None
        latest = os.path.join(rec_dir, f"ckpt_step{steps[-1]}.pt")
        sd = torch.load(latest, map_location="cpu", weights_only=True)
        for prefix, model in (("model.", model_c), ("model_fine.", model_f)):
            if model is None:
                continue
            for name, layer in model.layers().items():
                ls = sd.get(prefix + name + ".weight_scaling")
                if ls is not None:
                    layer.weight_scaling = ls.reshape(-1, 1).to(self.device)
                if biases:
                    with torch.no_grad():
                        layer.bias.copy_(sd[prefix + name + ".bias"])
        opt_path = latest[:-3] + ".opt.pt"
        opt_state = torch.load(opt_path, map_location=self.device,
                               weights_only=True) \
            if os.path.exists(opt_path) else None
        if self.verbose:
            print(f"INFO: resuming LSA from step {steps[-1]} ({latest}"
                  f"{', with optimizer state' if opt_state else ''})")
        return steps[-1], opt_state

    def _save_hook(self, basedir_save):
        """save_hook for lsa.tune_lsa_scales: the checkpoint
        ``reconstructed/ckpt_step{N}.pt`` (the models' weights, biases and
        scales) with its optimizer state ``ckpt_step{N}.opt.pt``, the test
        views as PNGs in ``testset_step{N}/`` and the step videos in
        ``movies/`` (reference: run_nerf.py:781-794)."""
        scene = self.scene

        def save_hook(step, model_c, model_f, opt_state):
            sd = nerf.params_to_state_dict(model_c, "model.")
            if model_f is not None:
                sd.update(nerf.params_to_state_dict(model_f, "model_fine."))
            rec_dir = os.path.join(basedir_save, "reconstructed")
            os.makedirs(rec_dir, exist_ok=True)
            save_to_torch_file(sd, os.path.join(rec_dir,
                                                f"ckpt_step{step}.pt"))
            torch.save(opt_state,
                       os.path.join(rec_dir, f"ckpt_step{step}.opt.pt"))
            testdir = os.path.join(basedir_save, f"testset_step{step}")
            os.makedirs(testdir, exist_ok=True)
            rgbs, _ = self._render_views(model_c, model_f, scene["i_test"],
                                         savedir=testdir)
            moviedir = os.path.join(basedir_save, "movies")
            os.makedirs(moviedir, exist_ok=True)
            write_video(os.path.join(moviedir, f"step{step}_rgb"),
                        to8b(rgbs), fps=30, quality=8)
            rposes = scene.get("render_poses")
            if rposes is not None and len(rposes):
                frames = self._render_poses(model_c, model_f, rposes,
                                            render_factor=self.render_factor)
                write_video(os.path.join(moviedir, f"step{step}_spiral_rgb"),
                            to8b(frames), fps=30, quality=8)

        return save_hook

    # -- ModelExecute interface --------------------------------------------
    def tune_model(self, bitstream_path, parameters, param_types,
                   lsa_flag=True, ft_flag=False, verbose=False):
        """Tune the LSA scales (``lsa_flag``) and/or the biases
        (``ft_flag``) of the dequantized ``parameters``. Returns
        (lsa_params, ft_params): {"model[_fine].<layer>.weight_scaling":
        (out,)} and {"model[_fine].<layer>.bias": (out,)}, numpy."""
        model_c, model_f = self._split_params(parameters)
        scene = self.scene
        basedir_save = os.path.dirname(os.path.dirname(bitstream_path)) \
            if bitstream_path else None
        global_step0, opt_state0 = 0, None
        if self.resume and basedir_save:
            global_step0, opt_state0 = self._resume_point(
                basedir_save, model_c, model_f, biases=ft_flag)
        # occupancy tuning: one grid from the dequantized fine network; per-
        # ray selection needs no dilation for subsample blocks (dilate=1)
        occ_grid = self._occupancy_grid(model_c, model_f,
                                        "use_occupancy_tuning", dilate=1)
        ls_c, ls_f, _psnr, _loss, _step, biases = lsa.tune_lsa_scales(
            model_c, model_f, self._make_batcher(), self.rc, scene["near"],
            scene["far"], learning_rate=self.learning_rate,
            learning_rate_decay=self.learning_rate_decay,
            epochs=self.epochs, n_iters=self.n_iters, i_save=self.i_save,
            basedir_save=basedir_save, global_step0=global_step0,
            seed=self.seed, verbose=self.verbose or verbose,
            save_hook=self._save_hook(basedir_save) if basedir_save else None,
            tune_biases=ft_flag, tune_scales=lsa_flag,
            opt_state0=opt_state0, mesh=self.mesh, grid=occ_grid)

        as_np = lambda t: t.cpu().numpy()
        lsa_params, ft_params = {}, {}
        if lsa_flag:
            for prefix, ls in (("model.", ls_c), ("model_fine.", ls_f)):
                for name, v in ls.items():
                    lsa_params[prefix + name + ".weight_scaling"] = as_np(v)
        if ft_flag and biases is not None:
            # fine-tuning adjusts the bias companions against the quantized
            # weights (reference ft trains O_TYPES params, not weights:
            # pytorch_model/__init__.py:1129-1145, 1195-1203)
            for prefix, b in zip(("model.", "model_fine."), biases):
                for name, v in b.items():
                    ft_params[prefix + name + ".bias"] = as_np(v)
        return lsa_params, ft_params

    def test_model(self, parameters, verbose=False):
        """Render all test views; returns the mean PSNR."""
        model_c, model_f = self._split_params(parameters)
        _, psnrs = self._render_views(model_c, model_f, self.scene["i_test"])
        if verbose:
            print(f"test PSNR per view: {psnrs}")
        return float(np.mean(psnrs))

    def eval_model(self, parameters, verbose=False):
        """Cheap probe: PSNR over one ray batch (the batcher's first draw,
        the same for every call)."""
        model_c, model_f = self._split_params(parameters)
        scene = self.scene
        batch = self._make_batcher().next_batch()
        if len(batch) == 4:
            ro, rd, vd, target = batch
        else:
            ro, rd, target = batch
            vd = None
        rgb = lsa.route(self.rc).render_view(
            model_c, model_f, ro, rd, scene["near"], scene["far"], vd,
            self.device)
        mse = float(np.mean((rgb - target) ** 2))
        psnr = mse2psnr(mse)
        return psnr, psnr, mse

    def has_eval(self):
        return True

    def has_test(self):
        return True

    def has_tune_ft(self):
        return True

    def has_tune_lsa(self):
        return True
