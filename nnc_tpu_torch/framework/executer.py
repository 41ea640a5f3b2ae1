"""NeRF model executer: the codec's callback for evaluating and testing.

Counterpart of ``nnc_tpu/framework/executer.py`` (reference:
framework/pytorch_model/__init__.py:922-1217). ``eval_model`` is IOQ's
render probe (one ray batch), ``test_model`` renders the test views.
LSA / fine-tune tuning (``tune_model``) is not ported yet (ROADMAP B1).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from nnc_tpu.core.model import ModelExecute
from nnc_tpu.utils.logging import mse2psnr, to8b

from ..data.rays import RayBatcher
from ..models import nerf
from ..render import renderer
from ..render.rays import get_rays_np, ndc_rays


class NeRFModelExecuter(ModelExecute):
    def __init__(self, scene, render_config: renderer.RenderConfig, *,
                 device, learning_rate=1e-4, epochs=2,
                 learning_rate_decay=0.1, n_iters=50000, i_save=10000,
                 n_rand=1024, seed=451, verbose=True, render_factor=0,
                 precrop_iters=0, precrop_frac=0.5):
        renderer.check_supported(render_config)
        self.device = torch.device(device)
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
        """(coarse, fine) NeRF modules on the device. Missing LSA scales
        stay absent: the reference's all-ones scales multiply exactly."""
        cfg = self.rc.mlp
        return (nerf.params_from_state_dict(parameters, "model.", cfg,
                                            device=self.device),
                nerf.params_from_state_dict(parameters, "model_fine.", cfg,
                                            device=self.device))

    def _render_poses(self, model_c, model_f, poses, savedir=None,
                      names=None, render_factor=0):
        """Render camera poses; returns (n, H, W, 3) numpy.
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
            out = renderer.render_image(model_c, model_f, ro, rd, near, far,
                                        self.rc, viewdirs=vd,
                                        device=self.device)
            rgb = out["rgb_map"].cpu().numpy()
            rgbs.append(rgb)
            if savedir is not None:
                import imageio.v2 as imageio
                name = names[i] if names is not None else i
                imageio.imwrite(os.path.join(savedir, f"{name:03d}.png"),
                                to8b(rgb))
        return np.stack(rgbs)

    def _render_views(self, model_c, model_f, pose_indices, savedir=None):
        scene = self.scene
        rgbs = self._render_poses(model_c, model_f,
                                  scene["poses"][np.asarray(pose_indices)],
                                  savedir=savedir, names=pose_indices)
        psnrs = [mse2psnr(float(np.mean((rgbs[i] - scene["images"][vi]) ** 2)))
                 for i, vi in enumerate(pose_indices)]
        return rgbs, psnrs

    # -- ModelExecute interface --------------------------------------------
    def tune_model(self, bitstream_path, parameters, param_types,
                   lsa_flag=True, ft_flag=False, verbose=False):
        raise NotImplementedError(
            "LSA / fine-tune tuning is not ported to nnc_tpu_torch yet "
            "(ROADMAP B1: the fused train kernel pair)")

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
        out = renderer.render_image(model_c, model_f, ro, rd, scene["near"],
                                    scene["far"], self.rc, viewdirs=vd,
                                    device=self.device)
        mse = float(np.mean((out["rgb_map"].cpu().numpy() - target) ** 2))
        psnr = mse2psnr(mse)
        return psnr, psnr, mse

    def has_eval(self):
        return True

    def has_test(self):
        return True

    def has_tune_ft(self):
        return False

    def has_tune_lsa(self):
        return False
