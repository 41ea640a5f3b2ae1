"""Faults planted underneath the timed path, for the check that the
comparison finds them: each patches the program for the length of a
``with`` block (``with planted("half_batch"): ...``)."""
from __future__ import annotations

import contextlib


def _unchanged_state(patch):
    """An LSA step that returns its state unchanged: Adam updates nothing."""
    from nnc_tpu_torch.train import lsa
    patch(lsa.Adam, "update", lambda self, grads, hyper: None)


def _half_batch(patch):
    """Half of an LSA step's batch left out, the mean taken over the rest."""
    from nnc_tpu_torch.train import lsa
    loss = lsa.double_mse_loss

    def half(model_c, model_f, ro, rd, vd, target, *a, draws=None, **kw):
        h = ro.shape[0] // 2
        draws = {k: v[:h] for k, v in (draws or {}).items()}
        return loss(model_c, model_f, ro[:h], rd[:h], vd[:h], target[:h],
                    *a, draws=draws, **kw)
    patch(lsa, "double_mse_loss", half)


def _altered_loss(patch):
    """An answer altered where it is produced: the first loss a call reads
    back, 0.1% off."""
    from nnc_tpu_torch.train import lsa
    readback = lsa._readback

    def altered(t):
        out = readback(t).copy()
        out[0, 0] *= 1.001
        return out
    patch(lsa, "_readback", altered)


def _altered_view(patch):
    """An answer altered where it is produced: a test view with a pixel
    0.5 off."""
    from nnc_tpu_torch.render import renderer
    render_image = renderer.render_image

    def altered(*a, **kw):
        out = render_image(*a, **kw)
        out["rgb_map"] = out["rgb_map"].clone()
        out["rgb_map"].view(-1)[5] += 0.5
        return out
    patch(renderer, "render_image", altered)


def _altered_frame(patch):
    """An answer altered where it is produced: a frame with a pixel 0.5
    off."""
    from nnc_tpu_torch.render import occupancy
    fast = occupancy.render_image_fast

    def altered(*a, **kw):
        out = fast(*a, **kw)
        out["rgb_map"] = out["rgb_map"].copy()
        out["rgb_map"].reshape(-1)[5] += 0.5
        return out
    patch(occupancy, "render_image_fast", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_loss": _altered_loss, "altered_view": _altered_view,
          "altered_frame": _altered_frame}
# the faults each driver's cells can have
OF_DRIVER = {"lsa": ("unchanged_state", "half_batch", "altered_loss"),
             "render": ("altered_view",), "frame": ("altered_frame",)}


@contextlib.contextmanager
def planted(name: str):
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
