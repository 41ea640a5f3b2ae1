"""nnc_tpu_torch: the PyTorch / CUDA port of nnc_tpu for NVIDIA Hopper GPUs.

A package of its own: the NNR codec (``compression``, ``core``, ``coder``,
``hls``), the NeRF renderer and the LSA trainer, with hand-written CUDA
kernels where ``nnc_tpu`` has Pallas kernels. It imports ``torch``, never
``jax``, and nothing of ``nnc_tpu``.

Public API: compress_model, compress, decompress, decompress_model
"""
__version__ = "0.1.0"

from .compression import compress, compress_model, decompress, decompress_model
