"""ImageNet-style folder dataset for the classification LSA path.

Counterpart of ``nnc_tpu/data/imagenet.py``, batch for batch. PIL-based (no
torchvision dependency): reads ``root/<class>/<img>`` folders, applies
resize/center-crop/normalize, yields numpy (NHWC float32, int label)
batches, which the executers move to their device. A validation-file list
can carve a train/val split out of one directory like the reference
(reference: framework/applications/datasets/imagenet.py:19-84).
"""
from __future__ import annotations

import os

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _load_image(path, size=224, resize=256):
    from PIL import Image
    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))))
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageNetDataset:
    """root/<wnid>/<file> layout; classes sorted by folder name.

    ``split``: 'train' keeps files NOT in the validation list, 'val' keeps
    files in it, 'test' keeps everything (used on a held-out root, like the
    reference's root/val directory; reference imagenet.py:78-84)."""

    def __init__(self, root, split="train", validation_files=None,
                 image_size=224):
        self.root = root
        self.image_size = image_size
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        val_set = set(validation_files or [])
        self.samples = []
        for c in self.classes:
            for f in sorted(os.listdir(os.path.join(root, c))):
                in_val = f in val_set or os.path.join(c, f) in val_set
                if split == "test" or (split == "val") == in_val:
                    self.samples.append((os.path.join(root, c, f),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        return _load_image(path, self.image_size), label


def load_validation_file_list(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def resolve_imagenet_root(root, split):
    """Map the reference's two-directory layout onto a (dir, split) pair.

    The reference expects ``root/train`` (train + val carved out by a
    validation-file list) and ``root/val`` (the test split)
    (reference: framework/applications/datasets/imagenet.py:27-32). A flat
    root of class folders is also accepted and used for every split.
    Returns (directory, effective_split)."""
    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    if os.path.isdir(train_dir):
        if split in ("train", "val"):
            return train_dir, split
        return (val_dir if os.path.isdir(val_dir) else train_dir), "test"
    return root, split


class FolderDataLoader:
    """Re-iterable batch loader over an :class:`ImageNetDataset`.

    Iterating yields (x NHWC float32, y int32) numpy batches — the loader
    interface of ``nnc_tpu_torch.train.classification``. ``num_workers`` > 1
    decodes images with a thread pool (PIL releases the GIL during decode).
    Mirrors the surface of the reference's torch DataLoader (``.dataset``,
    ``len()`` = number of batches; reference use_case_init/__init__.py:21-72)
    without the torch dependency."""

    def __init__(self, dataset, batch_size=64, shuffle=False, num_workers=0,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, int(num_workers or 0))
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_workers) as pool:
                for start in range(0, len(order), self.batch_size):
                    idxs = order[start:start + self.batch_size]
                    pairs = list(pool.map(self.dataset.__getitem__, idxs))
                    xs, ys = zip(*pairs)
                    yield np.stack(xs), np.asarray(ys, np.int32)
        else:
            for start in range(0, len(order), self.batch_size):
                idxs = order[start:start + self.batch_size]
                xs, ys = zip(*(self.dataset[i] for i in idxs))
                yield np.stack(xs), np.asarray(ys, np.int32)


def imagenet_dataloaders(root, batch_size=64, validation_files_path=None,
                         image_size=224, seed=0, shuffle_train=True):
    """Returns (train_loader_fn, val_loader_fn): zero-arg callables yielding
    (x NHWC float32, y int) numpy batches — the loader interface of
    nnc_tpu_torch.train.classification."""
    val_files = (load_validation_file_list(validation_files_path)
                 if validation_files_path else None)
    train_ds = ImageNetDataset(root, "train", val_files, image_size)
    val_ds = ImageNetDataset(root, "val", val_files, image_size) \
        if val_files else train_ds

    def make_loader(ds, shuffle):
        def loader():
            order = np.arange(len(ds))
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
            for start in range(0, len(ds), batch_size):
                idxs = order[start:start + batch_size]
                xs, ys = zip(*(ds[i] for i in idxs))
                yield np.stack(xs), np.asarray(ys, np.int32)
        return loader

    return make_loader(train_ds, shuffle_train), make_loader(val_ds, False)
