"""The classification side of nnc_tpu_torch against nnc_tpu (CPU, float32).

The same numpy-seeded inputs go through the JAX package and its port:
``train/classification`` (metrics, evaluation, one epoch of Adam, the
executer, IOQ with it), ``framework/torch_executer`` (the reference runs the
same torch code on the host: bit for bit), ``framework/use_cases`` (the
registry, the folder loaders, ``NERF_PYT`` against ``NERF_JAX``) and
``data/imagenet`` (bit for bit). Tolerances:
  - top1 / top5 equal; cross-entropy within 1e-6 relative (float32 sums of
    a log-softmax, ~10 ulp);
  - one epoch of Adam and the executer's tuned tensors within 1e-5
    absolute, mean loss / accuracy within 1e-5: Adam moves a scale by ~lr a
    step whatever its gradient's size, so the gradients' reassociation
    (~1e-7 relative) stays far below it;
  - the IOQ bitstream's bytes equal;
  - ``NERF_PYT`` against ``NERF_JAX``, six steps: scales to rtol 2e-4 /
    atol 2e-6, the bar tests/test_torch_port_train.py holds a six-step
    ``tune_lsa_scales`` trajectory to, PSNR within 1e-3 dB and the loss
    within 1e-3 relative; the handler against the direct LSA call on the
    port: bit for bit.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

import nnc_tpu
import nnc_tpu_torch
from nnc_tpu.data import imagenet as jimagenet
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.framework import torch_executer as jtex
from nnc_tpu.framework import use_cases as juse
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import classification as jcls
from nnc_tpu_torch.data import imagenet as timagenet
from nnc_tpu_torch.framework import torch_executer as ttex
from nnc_tpu_torch.framework import use_cases as tuse
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import classification as tcls


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's work here is tiny: one intra-op thread runs it as fast as
    several alone, and keeps it fast beside other test workers, where idle
    threads of many pools contend for the cores (as
    tests/test_torch_port_scan.py does). The TorchModuleExecuters set one
    thread themselves while they tune on the CPU; later tests in this
    worker get the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _classifier(seed=3, classes=4, hidden=16, dim=8, n=64):
    """tests/test_adapters_and_tasks.py's classifier and data."""
    rng = np.random.default_rng(seed)
    d = {
        "fc1.weight": rng.normal(0, 0.3, (hidden, dim)).astype(np.float32),
        "fc1.bias": np.zeros(hidden, np.float32),
        "fc2.weight": rng.normal(0, 0.3, (classes, hidden))
        .astype(np.float32),
        "fc2.bias": np.zeros(classes, np.float32),
    }
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    y = rng.integers(0, classes, n)

    def loader():
        for i in range(0, n, 16):
            yield x[i:i + 16], y[i:i + 16]

    return d, loader


def _builders():
    return (jcls.mlp_classifier_builder(["fc1", "fc2"]),
            tcls.mlp_classifier_builder(["fc1", "fc2"], device="cpu"))


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{n}": v for k in tree for n, v in _flat(tree[k]).items()}
    return {"": np.asarray(tree.detach() if torch.is_tensor(tree) else tree)}


def test_topk_and_cross_entropy_match_jax():
    rng = np.random.default_rng(0)
    # small integers: many ties, which the stable sort must break as JAX's
    logits = rng.integers(0, 3, (64, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 64)
    for k in (1, 3, 5):
        want = float(jcls.get_topk_accuracy(jnp.asarray(logits),
                                            jnp.asarray(labels), k))
        got = float(tcls.get_topk_accuracy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), k))
        assert got == want, k
    logits = rng.normal(0, 3, (64, 7)).astype(np.float32)
    want = float(jcls.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tcls.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("classes", [4, 6])
def test_evaluate_matches_jax(classes):
    """Four batches of 16; below five classes top5 is 1.0."""
    d, loader = _classifier(classes=classes)
    jb, tb = _builders()
    japply, jp, jls, _ = jb(d)
    tapply, tp, tls, _ = tb(d)
    want = jcls.evaluate_classification_model(japply, jp, jls, loader())
    got = tcls.evaluate_classification_model(tapply, tp, tls, loader())
    assert got[:2] == want[:2]
    assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])
    # max_batches stops early in both
    want = jcls.evaluate_classification_model(japply, jp, jls, loader(), 2)
    got = tcls.evaluate_classification_model(tapply, tp, tls, loader(), 2)
    assert got[:2] == want[:2]


@pytest.mark.parametrize("scales_only", [True, False])
def test_train_one_epoch_matches_jax(scales_only):
    d, loader = _classifier()
    d["fc1.weight_scaling"] = np.linspace(0.9, 1.1, 16, dtype=np.float32)
    jb, tb = _builders()
    japply, jp, jls, _ = jb(d)
    tapply, tp, tls, _ = tb(d)
    want = jcls.train_classification_model(
        japply, jp, jls, loader(), learning_rate=1e-2,
        train_scales_only=scales_only)
    got = tcls.train_classification_model(
        tapply, tp, tls, loader(), learning_rate=1e-2,
        train_scales_only=scales_only)
    moved = 0.0
    for g_tree, w_tree, t0 in zip(got[:2], want[:2], (tp, tls)):
        g_flat, w_flat, t0_flat = _flat(g_tree), _flat(w_tree), _flat(t0)
        assert g_flat.keys() == w_flat.keys()
        for name in w_flat:
            np.testing.assert_allclose(g_flat[name], w_flat[name], rtol=0,
                                       atol=1e-5, err_msg=name)
            moved = max(moved, float(np.abs(w_flat[name]
                                            - t0_flat[name]).max()))
    # the inputs are left as they were; the trained tensors moved
    np.testing.assert_array_equal(tls["fc1"].numpy(),
                                  d["fc1.weight_scaling"])
    assert moved > 1e-3
    assert abs(got[2] - want[2]) <= 1e-5 and abs(got[3] - want[3]) <= 1e-5


def test_classification_executer_tune_matches_jax():
    d, loader = _classifier()
    jb, tb = _builders()
    kw = dict(epochs=2, learning_rate=1e-2, verbose=False)
    want = jcls.ClassificationExecuter(jb, loader, **kw).tune_model(
        parameters=d, param_types={}, lsa_flag=True, ft_flag=True)
    got = tcls.ClassificationExecuter(tb, loader, **kw).tune_model(
        parameters=d, param_types={}, lsa_flag=True, ft_flag=True)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and w
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert got[0]["fc1.weight_scaling"].shape == (16, 1)
    ex = tcls.ClassificationExecuter(tb, loader, verbose=False)
    assert ex.eval_model(d) == ex.test_model(d)


def test_classification_executer_early_stopping_matches_jax(capsys):
    """A learning rate that makes the validation loss rise stops both at the
    same epoch."""
    d, loader = _classifier()
    jb, tb = _builders()
    kw = dict(epochs=8, learning_rate=5.0, patience=1, verbose=True)
    lines = []
    for mod, builder in ((jcls, jb), (tcls, tb)):
        ex = mod.ClassificationExecuter(builder, loader, **kw)
        ex.tune_model(parameters=d, lsa_flag=True)
        out = capsys.readouterr().out
        lines.append([ln for ln in out.splitlines()
                      if ln.startswith("early stopping")])
    assert lines[0] and lines[0] == lines[1]


def test_ioq_bitstream_matches_jax(tmp_path):
    """tests/test_ioq.py's classifier at qp=-38: the same per-tensor QPs,
    so the same bytes."""
    rng = np.random.default_rng(0)
    d = {
        "fc1.weight": rng.normal(0, 0.3, (16, 8)).astype(np.float32),
        "fc1.bias": np.zeros(16, np.float32),
        "fc2.weight": rng.normal(0, 0.3, (4, 16)).astype(np.float32),
        "fc2.bias": np.zeros(4, np.float32),
    }
    x = rng.normal(0, 1, (64, 8)).astype(np.float32)
    y = rng.integers(0, 4, 64)

    def loader():
        yield x, y

    jb, tb = _builders()
    streams = []
    for pkg, mod, builder in ((nnc_tpu, jcls, jb),
                              (nnc_tpu_torch, tcls, tb)):
        ex = mod.ClassificationExecuter(builder, loader, verbose=False)
        bs = str(tmp_path / f"{pkg.__name__}.nnc")
        pkg.compress(d, bitstream_path=bs, qp=-38, ioq=True,
                     model_executer=ex, verbose=False)
        with open(bs, "rb") as f:
            streams.append(f.read())
        rec = pkg.decompress(bs, verbose=False)
        assert ex.eval_model(rec)[0] >= ex.eval_model(d)[0] - 0.05
    assert streams[0] == streams[1]


# -- framework/torch_executer: the reference runs the same torch code -------
def _xy_loader(seed=0, n_batches=4, batch=32, dim=8, classes=4):
    """tests/test_framework_executers.py's data."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, (dim, classes)).astype(np.float32)

    def loader():
        r = np.random.default_rng(seed + 1)
        for _ in range(n_batches):
            x = r.normal(0, 1, (batch, dim)).astype(np.float32)
            y = np.argmax(x @ w_true, axis=1)
            yield x, y
    return loader


def _torch_model(seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _state(ex):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in ex.model.state_dict().items()}


@pytest.mark.parametrize("flags", [(True, False), (False, True),
                                   (True, True)])
def test_torch_module_executer_bit_equal_to_reference(flags):
    lsa_flag, ft_flag = flags
    model = _torch_model()
    kw = dict(learning_rate=5e-3, epochs=2, max_batches=4, verbose=False)
    ex_j = jtex.TorchModuleExecuter(model, _xy_loader(), **kw)
    ex_t = ttex.TorchModuleExecuter(model, _xy_loader(), device="cpu", **kw)
    sd_j, sd_t = _state(ex_j), _state(ex_t)
    assert sd_j.keys() == sd_t.keys()
    for k in sd_j:   # the scales' draws too
        assert np.array_equal(sd_j[k], sd_t[k]), k
    assert ex_t.eval_model(sd_t) == ex_j.eval_model(sd_j)
    want = ex_j.tune_model(parameters=sd_j, lsa_flag=lsa_flag,
                           ft_flag=ft_flag)
    got = ex_t.tune_model(parameters=sd_t, lsa_flag=lsa_flag,
                          ft_flag=ft_flag)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(torch.from_numpy(g[k]),
                               torch.from_numpy(w[k])), k
    assert bool(got[0]) == lsa_flag and bool(got[1]) == ft_flag
    assert ex_t.test_model(sd_t) == ex_j.test_model(sd_j)


def test_torch_module_executer_early_stopping_matches_reference(capsys):
    model = nn.Sequential(nn.Linear(8, 4))
    kw = dict(learning_rate=50.0, learning_rate_decay=0, epochs=8,
              patience=1, max_batches=4, verbose=True)
    lines = []
    for ex in (jtex.TorchModuleExecuter(model, _xy_loader(), **kw),
               ttex.TorchModuleExecuter(model, _xy_loader(), device="cpu",
                                        **kw)):
        ex.tune_model(parameters=_state(ex), lsa_flag=True)
        lines.append(capsys.readouterr().out.splitlines())
    stops = [[ln for ln in out if ln.startswith("early stopping")]
             for out in lines]
    assert stops[0] and stops[0] == stops[1]
    assert lines[0] == lines[1]


@pytest.mark.parametrize("mode", ["zeros", "reflect", "circular",
                                  "replicate"])
def test_scaled_conv2d_padding_modes(mode):
    """The wrapped conv equals nn.Conv2d at identity scales, and the
    reference's wrapper at the drawn scales."""
    torch.manual_seed(0)
    conv = nn.Conv2d(3, 4, 3, padding=1, padding_mode=mode)
    x = torch.randn(2, 3, 8, 8)
    ours = ttex.add_lsa_scaling(nn.Sequential(conv),
                                generator=torch.Generator().manual_seed(1))
    torch.manual_seed(1)
    ref = jtex.add_lsa_scaling(nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1, padding_mode=mode)))
    ref.load_state_dict(ours.state_dict())
    assert torch.equal(ours[0].weight_scaling, ref[0].weight_scaling)
    assert torch.equal(ours(x), ref(x))
    with torch.no_grad():
        ours[0].weight_scaling.fill_(1.0)
    plain = nn.Conv2d(3, 4, 3, padding=1, padding_mode=mode)
    plain.load_state_dict({"weight": ours[0].weight, "bias": ours[0].bias})
    torch.testing.assert_close(ours(x), plain(x))


def test_add_lsa_scaling_walks_to_depth_five():
    def nest(depth):
        mod = nn.Linear(2, 2)
        for _ in range(depth):
            mod = nn.Sequential(mod)
        return mod

    for depth, wrapped in ((5, True), (6, True), (7, False)):
        names = [[n for n, _ in mod.add_lsa_scaling(nest(depth))
                  .named_parameters()] for mod in (ttex, jtex)]
        assert names[0] == names[1]
        assert any(n.endswith("weight_scaling") for n in names[0]) == wrapped


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_torch_module_executer_pins_tf32(allow_tf32, monkeypatch):
    """Every forward of eval / test / tune sees cuDNN's and the matmuls'
    TF32 as the executer was built (off by default, as float32 on the
    host), whatever the process had set; the process's settings come back."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not allow_tf32)
    ex = ttex.TorchModuleExecuter(_torch_model(), _xy_loader(), device="cpu",
                                  max_batches=2, epochs=1, verbose=False,
                                  allow_tf32=allow_tf32)
    seen = []
    ex.model.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.enabled)))
    sd = _state(ex)
    ex.eval_model(sd)
    ex.test_model(sd)
    ex.tune_model(parameters=sd, lsa_flag=True, ft_flag=True)
    assert len(seen) == 2 + 2 + 2 + 2   # eval, test, tune's steps and val
    assert set(seen) == {(allow_tf32, allow_tf32, True)}
    assert torch.backends.cudnn.allow_tf32 is (not allow_tf32)
    assert torch.backends.cuda.matmul.allow_tf32 is (not allow_tf32)


def test_torch_module_executer_channels_last():
    """NHWC batches are transposed to NCHW, as in the reference."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.AdaptiveAvgPool2d(1),
                          nn.Flatten(), nn.Linear(4, 3))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 6, 6, 3)).astype(np.float32)
    y = rng.integers(0, 3, 8)
    loader = lambda: iter([(x, y)])
    kw = dict(channels_last=True, verbose=False)
    ex_j = jtex.TorchModuleExecuter(model, loader, **kw)
    ex_t = ttex.TorchModuleExecuter(model, loader, device="cpu", **kw)
    assert ex_t.eval_model(_state(ex_t)) == ex_j.eval_model(_state(ex_j))


# -- data/imagenet and the registry's folder loaders ------------------------
def _fake_images(root, n_classes=2, per_class=3, seed=0):
    """Class folders of JPEGs of mixed sizes (tests/test_misc_components.py
    makes them the same way)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    files = []
    for c in range(n_classes):
        d = os.path.join(root, f"n{c:08d}")
        os.makedirs(d)
        for i in range(per_class):
            name = f"img_{c}_{i}.JPEG"
            h, w = (24, 40) if i % 2 else (36, 28)
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                os.path.join(d, name))
            files.append((f"n{c:08d}", name))
    return files


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_imagenet_dataset_and_loaders_match_jax(tmp_path):
    files = _fake_images(str(tmp_path))
    val_list = str(tmp_path / "val.txt")
    with open(val_list, "w") as f:
        f.write(files[0][1] + "\n" + os.path.join(*files[4]) + "\n")
    val_files = timagenet.load_validation_file_list(val_list)
    assert val_files == jimagenet.load_validation_file_list(val_list)
    for split in ("train", "val", "test"):
        ds_j = jimagenet.ImageNetDataset(str(tmp_path), split, val_files,
                                         image_size=32)
        ds_t = timagenet.ImageNetDataset(str(tmp_path), split, val_files,
                                         image_size=32)
        assert ds_t.classes == ds_j.classes
        assert ds_t.samples == ds_j.samples and len(ds_t) == len(ds_j)
        _assert_same_batches(
            ((x[None], np.int32([y])) for x, y in
             (ds_t[i] for i in range(len(ds_t)))),
            ((x[None], np.int32([y])) for x, y in
             (ds_j[i] for i in range(len(ds_j)))))
    ds = (timagenet.ImageNetDataset(str(tmp_path), image_size=32),
          jimagenet.ImageNetDataset(str(tmp_path), image_size=32))
    for workers in (0, 2):
        loaders = [mod.FolderDataLoader(d, batch_size=4, shuffle=True,
                                        num_workers=workers, seed=3)
                   for mod, d in zip((timagenet, jimagenet), ds)]
        assert len(loaders[0]) == len(loaders[1]) == 2
        for _epoch in range(2):   # a new order each epoch
            _assert_same_batches(loaders[0], loaders[1])
    for shuffle in (True, False):
        fns = [mod.imagenet_dataloaders(
            str(tmp_path), batch_size=4, validation_files_path=val_list,
            image_size=32, seed=2, shuffle_train=shuffle)
            for mod in (timagenet, jimagenet)]
        for got, want in zip(*fns):
            _assert_same_batches(got(), want())


def test_resolve_imagenet_root_matches_jax(tmp_path):
    flat = tmp_path / "flat"
    two = tmp_path / "two"
    for d in (flat, two / "train", two / "val"):
        d.mkdir(parents=True)
    (tmp_path / "one").mkdir()
    (tmp_path / "one" / "train").mkdir()
    for root in (flat, two, tmp_path / "one"):
        for split in ("train", "val", "test"):
            assert timagenet.resolve_imagenet_root(str(root), split) == \
                jimagenet.resolve_imagenet_root(str(root), split)


def test_use_case_registry_keys():
    assert set(tuse.use_cases) == set(juse.use_cases) == {
        "NNR_JAX", "NNR_PYT", "NNR_TEF", "NERF_JAX", "NERF_PYT"}
    s = tuse.use_cases["NNR_PYT"]()
    assert s.evaluate is tcls.evaluate_classification_model
    assert s.train is tcls.train_classification_model
    assert s.criterion is tcls.cross_entropy
    assert isinstance(tuse.use_cases["NERF_PYT"](), tuse.NeRFModelSetting)
    # no usable path: the dummy loaders
    assert len(s.init_training(None, 4, 0)) == 0
    ds, dl = s.init_test(str(os.devnull), 4, 0)
    assert len(ds) == 1 and list(dl) == []


@pytest.mark.parametrize("layout", ["flat", "train_val"])
def test_model_setting_loaders_match_jax(tmp_path, layout):
    """init_training / init_validation / init_test on a folder tree, with
    the validation list the registry looks for: the same batches."""
    root = tmp_path / "data"
    if layout == "flat":
        root.mkdir()
        files = _fake_images(str(root))
    else:
        (root / "train").mkdir(parents=True)
        (root / "val").mkdir()
        files = _fake_images(str(root / "train"))
        _fake_images(str(root / "val"), per_class=2, seed=1)
    with open(root / "imagenet_validation_files.txt", "w") as f:
        f.write(files[1][1] + "\n")
    settings = [mod.use_cases["NNR_PYT"]() for mod in (tuse, juse)]
    for s in settings:
        s.image_size = 32
    for n_workers in (0, 2):
        t_loader, j_loader = (s.init_training(str(root), 4, n_workers)
                              for s in settings)
        _assert_same_batches(t_loader, j_loader)
        for init in ("init_validation", "init_test"):
            (ds_t, dl_t), (ds_j, dl_j) = (getattr(s, init)(str(root), 4,
                                                           n_workers)
                                          for s in settings)
            assert ds_t.samples == ds_j.samples
            _assert_same_batches(dl_t, dl_j)


def _nerf_case():
    """A W=32 teacher scene with cameras moved in (as
    tests/test_torch_port_train.py's _move_in does) and the teacher's
    weights under 5% noise, as a flat state dict."""
    mlp = jnerf.NeRFConfig(W=32)
    scene, (tc, tf_) = jsynthetic.make_scene(
        n_images=3, H=16, W=16, mlp=mlp,
        rc=jrenderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=4,
                                  chunk=256))
    scene["poses"] = scene["poses"].copy()
    scene["poses"][:, :3, 3] *= 0.3
    scene["near"], scene["far"] = 0.6, 1.8
    rng = np.random.default_rng(1)
    sd = {}
    sd.update(jnerf.params_to_state_dict(tc, "model."))
    sd.update(jnerf.params_to_state_dict(tf_, "model_fine."))
    sd = {k: (np.asarray(v) * (1 + 0.05 * rng.standard_normal(np.shape(v)))
              if k.endswith(".weight") else np.asarray(v)).astype(np.float32)
          for k, v in sd.items()}
    return scene, sd


NERF_RC = dict(n_samples=32, n_importance=32, chunk=16 * 16, perturb=False,
               raw_noise_std=0.0)


def test_nerf_pyt_train_matches_nerf_jax():
    """NERF_PYT's epoch against NERF_JAX's on one state dict carried across;
    no random draw beyond the batcher's seed. Six steps, the length of
    tests/test_torch_port_train.py's trajectory, whose bar this is: a
    channel whose gradient sits near Adam's eps follows its rounding noise,
    and such a channel's distance grows with the steps."""
    scene, sd = _nerf_case()
    sd_j, sd_t = dict(sd), dict(sd)
    kw = dict(scene=scene, N_iters=6, learning_rate=5e-3, n_rand=32)
    want = juse.use_cases["NERF_JAX"]().train(
        nerf_wrapper=sd_j,
        rc=jrenderer.RenderConfig(mlp=jnerf.NeRFConfig(W=32), **NERF_RC),
        **kw)
    got = tuse.use_cases["NERF_PYT"]().train(
        nerf_wrapper=sd_t,
        rc=trenderer.RenderConfig(mlp=tnerf.NeRFConfig(W=32), **NERF_RC),
        device="cpu", **kw)
    keys = [k for k in sd_j if k.endswith(".weight_scaling")]
    assert len(keys) == 24 and set(sd_t) == set(sd_j)
    moved = 0.0
    for k in keys:
        assert sd_t[k].shape == sd_j[k].shape == (sd[k[:-8]].shape[0], 1)
        np.testing.assert_allclose(sd_t[k], sd_j[k], rtol=2e-4, atol=2e-6,
                                   err_msg=k)
        moved = max(moved, float(np.abs(sd_j[k] - 1).max()))
    assert moved > 2e-2
    assert abs(got[0] - want[0]) <= 1e-3
    assert abs(got[1] - want[1]) <= 1e-3 * abs(want[1])


def test_nerf_pyt_train_is_the_direct_lsa_call():
    """16 steps (two full calls of steps_per_call 8): the handler's scales
    are those of tune_lsa_scales called with the reference's arguments, bit
    for bit, and the dict's own scales are where the models start."""
    from nnc_tpu_torch.data.rays import RayBatcher
    from nnc_tpu_torch.train import lsa as tlsa
    scene, sd = _nerf_case()
    sd["model.pts_linears.0.weight_scaling"] = np.full((32, 1), 1.01,
                                                       np.float32)
    rc = trenderer.RenderConfig(mlp=tnerf.NeRFConfig(W=32), **NERF_RC)
    sd_t = dict(sd)
    tuse.use_cases["NERF_PYT"]().train(nerf_wrapper=sd_t, scene=scene, rc=rc,
                                       N_iters=16, learning_rate=5e-3,
                                       n_rand=32, device="cpu")
    models = [tnerf.params_from_state_dict(sd, p, rc.mlp, device="cpu")
              for p in ("model.", "model_fine.")]
    batcher = RayBatcher(scene["images"], scene["poses"], scene["K"],
                         scene["i_train"], 32, seed=451)
    ls_c, ls_f, *_ = tlsa.tune_lsa_scales(
        *models, batcher, rc, scene["near"], scene["far"],
        learning_rate=5e-3, learning_rate_decay=0, epochs=1, n_iters=16,
        seed=451, verbose=False)
    for prefix, scales in (("model.", ls_c), ("model_fine.", ls_f)):
        for name, v in scales.items():
            assert np.array_equal(sd_t[prefix + name + ".weight_scaling"],
                                  v.numpy().reshape(-1, 1)), name
