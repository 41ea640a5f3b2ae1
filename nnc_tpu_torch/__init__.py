"""nnc_tpu_torch: the PyTorch / CUDA port of nnc_tpu for NVIDIA Hopper GPUs.

It renders NeRFs for the shared NNR codec (``nnc_tpu.compression``, which
imports no JAX) with hand-written CUDA kernels, and imports no JAX itself.

Public API: compress_model, compress, decompress, decompress_model
"""
__version__ = "0.1.0"

from .compression import compress, compress_model, decompress, decompress_model
