"""QP <-> stepsize math for NNR uniform quantization.

Semantics match the reference codec's QP parameterization
(reference: nnc_core/common.py:3-62): a QP on a logarithmic grid with
``2**qp_density`` steps per octave.

    stepsize(qp) = (k + (qp & (k-1))) * 2**((qp >> qp_density) - qp_density)

with ``k = 2**qp_density``. Negative QPs give sub-unit stepsizes (finer
quantization); the default operating point of the pipeline is qp=-38,
qp_density=2.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "get_qp_from_stepsize",
    "get_stepsize_from_qp",
    "compute_qp_offset_to_dq_equivalent",
]


def get_stepsize_from_qp(qp, qp_density: int) -> float:
    """Map a quantization parameter to its stepsize (delta).

    ``qp`` may be a python int or a numpy integer. The mantissa is the low
    ``qp_density`` bits (offset by k), the exponent the arithmetic shift of the
    remaining high bits, so each increment of qp by ``2**qp_density`` doubles
    the stepsize. (reference: nnc_core/common.py:28-46)
    """
    qp = int(qp)
    k = 1 << qp_density
    mul = k + (qp & (k - 1))
    shift = qp >> qp_density  # arithmetic shift: floor division by k
    return mul * (2.0 ** (shift - qp_density))


def get_qp_from_stepsize(stepsize, qp_density: int):
    """Inverse of :func:`get_stepsize_from_qp` (up to grid rounding).

    (reference: nnc_core/common.py:3-26)
    """
    k = 1 << qp_density
    base_qp = np.floor(np.log2(stepsize)) * k
    qp = base_qp + ((stepsize * k) / 2 ** (base_qp / k) - k)
    return qp


def compute_qp_offset_to_dq_equivalent(qp_density: int) -> int:
    """QP offset making a plain uniform quantizer's stepsize comparable to the
    dependent quantizer's effective half-step grid: one octave, i.e.
    ``1 << qp_density`` QP steps. (reference: nnc_core/common.py:48-62)"""
    return 1 << qp_density
