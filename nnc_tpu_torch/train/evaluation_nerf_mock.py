"""Scripted (mock) NeRF evaluation sequences.

Counterpart of ``nnc_tpu/train/evaluation_nerf_mock.py``, value for value;
``device`` is ignored, as there. Capability twin of the reference's
`evaluate_nerf_model` stub, which returns canned PSNR/SSIM/loss curves for
exercising IOQ-style evaluation plumbing without rendering (reference:
framework/applications/utils/evaluation_nerf.py:5-36, modes finite/infinite
with a global call counter). Use the real `NeRFModelExecuter.eval_model` for
actual evaluation.
"""
from __future__ import annotations

_CALL_TIME = 0

_FINITE_PSNR = [20.0, 21.5, 22.3, 22.9, 23.2, 23.4]
_FINITE_SSIM = [0.70, 0.74, 0.77, 0.79, 0.80, 0.81]
_FINITE_LOSS = [0.05, 0.040, 0.033, 0.029, 0.027, 0.026]


def reset():
    global _CALL_TIME
    _CALL_TIME = 0


def evaluate_nerf_model(model=None, criterion=None, testloader=None,
                        testset=None, min_sample_size=1000, max_batches=None,
                        device=None, verbose=False, mode="finite"):
    """Returns (psnr, ssim, loss) from a scripted sequence.

    mode='finite' walks the canned curve then repeats its last value;
    mode='infinite' improves indefinitely (diminishing increments)."""
    global _CALL_TIME
    i = _CALL_TIME
    _CALL_TIME += 1
    if mode == "finite":
        j = min(i, len(_FINITE_PSNR) - 1)
        return _FINITE_PSNR[j], _FINITE_SSIM[j], _FINITE_LOSS[j]
    psnr = 20.0 + 4.0 * (1.0 - 0.8 ** i)
    ssim = 0.70 + 0.12 * (1.0 - 0.8 ** i)
    loss = 0.05 * (0.9 ** i)
    return psnr, ssim, loss
