"""Use-case registry: bundles of {transforms, train, evaluate, dataset}
handlers per task, keyed like the reference registry
(reference: framework/use_case_init/__init__.py:10-232 with keys
'NNR_PYT'/'NNR_TEF'/'NERF_PYT').

Counterpart of ``nnc_tpu/framework/use_cases.py``, with its five keys. The
NeRF handler tunes on ``device`` (None: the first CUDA device) through the
port's ``train/lsa.tune_lsa_scales``.
"""
from __future__ import annotations



class DummyDataset:
    """Placeholder satisfying loader interfaces when a task needs no data.
    (reference: use_case_init/__init__.py:164-182)"""

    def __init__(self, n=1):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return 0, 0


class DummyDataLoader:
    def __init__(self, dataset=None):
        self.dataset = dataset or DummyDataset()

    def __iter__(self):
        return iter(())

    def __len__(self):
        return 0


class ModelSetting:
    """Classification-style handler: loaders + train/eval callables.

    ``init_*`` build real ImageNet-folder loaders from ``dataset_path``
    (reference: use_case_init/__init__.py:21-72 wires torch DataLoaders the
    same way); when no usable path is given they fall back to Dummy loaders
    so data-free codec paths keep working. Return shapes mirror the
    reference: ``init_training`` -> loader, ``init_validation``/``init_test``
    -> (dataset, loader)."""

    def __init__(self, model_transform=None, evaluate=None, train=None,
                 dataset=None, criterion=None, image_size=224):
        self.model_transform = model_transform
        self.evaluate = evaluate
        self.train = train
        self.dataset = dataset
        self.criterion = criterion
        self.image_size = image_size

    def _folder_loader(self, dataset_path, split, batch_size, num_workers,
                       shuffle):
        import os

        if not dataset_path or not os.path.isdir(str(dataset_path)):
            return None
        from ..data.imagenet import (FolderDataLoader, ImageNetDataset,
                                     load_validation_file_list,
                                     resolve_imagenet_root)
        root, eff_split = resolve_imagenet_root(str(dataset_path), split)
        val_files = None
        if eff_split in ("train", "val"):
            for cand in ("imagenet_validation_files.txt", "val.txt"):
                p = os.path.join(str(dataset_path), cand)
                if os.path.isfile(p):
                    val_files = load_validation_file_list(p)
                    break
        ds_cls = self.dataset or ImageNetDataset
        ds = ds_cls(root, eff_split, val_files, image_size=self.image_size)
        return ds, FolderDataLoader(ds, batch_size=batch_size,
                                    shuffle=shuffle, num_workers=num_workers)

    def init_training(self, dataset_path, batch_size, num_workers):
        built = self._folder_loader(dataset_path, "train", batch_size,
                                    num_workers, shuffle=True)
        return built[1] if built else DummyDataLoader()

    def init_validation(self, dataset_path, batch_size, num_workers):
        built = self._folder_loader(dataset_path, "val", batch_size,
                                    num_workers, shuffle=False)
        return built if built else (DummyDataset(), DummyDataLoader())

    def init_test(self, dataset_path, batch_size, num_workers):
        built = self._folder_loader(dataset_path, "test", batch_size,
                                    num_workers, shuffle=False)
        return built if built else (DummyDataset(), DummyDataLoader())


class NeRFModelSetting:
    """NeRF handler: only `.train` exists (reference NeRFModelSetting has no
    `.evaluate`; use_case_init/__init__.py:185-211). ``train`` runs one
    epoch of LSA tuning over a scene and updates the wrapper state dict in
    place, mirroring train_nerf.train_nerf_model -> run_nerf.train
    (reference: train_nerf.py:14-74; run_nerf.py:461-799)."""

    def train(self, nerf_wrapper=None, dataset_type="blender",
              freeze_batch_norm=True, basedir_save=None, N_iters=1000,
              i_save=0, scene=None, dataset_path=None, rc=None,
              learning_rate=1e-4, n_rand=1024, seed=451, device=None,
              **kwargs):
        """One epoch over the scene on ``device``. ``nerf_wrapper``: flat
        state dict with ``model.*``/``model_fine.*`` keys (weight_scaling
        entries tuned in place, identity where absent). Returns (mean_psnr,
        mean_loss)."""
        from ..data.rays import RayBatcher
        from ..models import nerf
        from ..train import lsa
        from ..train.presets import load_scene, make_render_config
        from ..utils.device import resolve_device

        assert nerf_wrapper is not None, "nerf_wrapper (state dict) required"
        device = resolve_device(device)
        if scene is None:
            scene = load_scene(dataset_type, dataset_path)
        if rc is None:
            rc = make_render_config(scene)

        model_c = nerf.params_from_state_dict(nerf_wrapper, "model.", rc.mlp,
                                              device=device)
        model_f = nerf.params_from_state_dict(nerf_wrapper, "model_fine.",
                                              rc.mlp, device=device)
        batcher = RayBatcher(scene["images"], scene["poses"], scene["K"],
                             scene["i_train"], n_rand,
                             mode=scene.get("batching_mode", "image"),
                             seed=seed)
        ls_c, ls_f, mean_psnr, mean_loss, _step, _b = lsa.tune_lsa_scales(
            model_c, model_f, batcher, rc, scene["near"], scene["far"],
            learning_rate=learning_rate, learning_rate_decay=0, epochs=1,
            n_iters=N_iters, i_save=i_save, basedir_save=basedir_save,
            seed=seed, verbose=False)
        for prefix, scales in (("model.", ls_c), ("model_fine.", ls_f)):
            for name, v in scales.items():
                nerf_wrapper[prefix + name + ".weight_scaling"] = \
                    v.cpu().numpy().reshape(-1, 1)
        return mean_psnr, mean_loss

    def init_training(self, *a, **k):
        return DummyDataLoader()

    init_validation = init_training
    init_test = init_training


def _classification_setting():
    from ..train import classification
    return ModelSetting(
        evaluate=classification.evaluate_classification_model,
        train=classification.train_classification_model,
        criterion=classification.cross_entropy,
    )


use_cases = {
    "NNR_JAX": _classification_setting,
    "NNR_PYT": _classification_setting,  # torch state dicts enter via torch_io
    "NNR_TEF": _classification_setting,  # h5 weights enter via tf_io
    "NERF_JAX": NeRFModelSetting,
    "NERF_PYT": NeRFModelSetting,
}
