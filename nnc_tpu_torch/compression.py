"""Top-level API: ``compress_model`` with a PyTorch NeRF executer.

The codec itself (``nnc_tpu.compression``, ``core``, ``coder``, ``hls``) imports
no JAX and is shared, so for the same weights the port writes the
reference's bytes. What the port supplies is the executer: with ``ioq`` set
and no ``model_executer`` given, :func:`compress_model` builds the torch
``NeRFModelExecuter`` on ``device`` and hands it to
``nnc_tpu.compression.compress_model(model_executer=...)``, which then never
reaches the JAX presets. LSA and fine-tuning need the training kernels and
are not ported yet: asking for them raises.
"""
from __future__ import annotations

from nnc_tpu import compression as _codec
from nnc_tpu.compression import compress, decompress, decompress_model
from nnc_tpu.framework import torch_io

from .models import nerf
from .train.presets import create_nerf_model_executer
from .utils.device import resolve_device

__all__ = ["compress_model", "compress", "decompress", "decompress_model"]


def compress_model(model_path_or_object,
                   bitstream_path="./bitstream.nnc",
                   qp=-38,
                   qp_density=2,
                   nonweight_qp=None,
                   qp_per_tensor=None,
                   use_dq=True,
                   codebook_mode=0,
                   scan_order=0,
                   lambda_scale=0,
                   param_opt=True,
                   cabac_unary_length_minus1=10,
                   opt_qp=False,
                   ioq=False,
                   ioq_codebook=False,
                   bnf=False,
                   lsa=False,
                   fine_tune=False,
                   block_id_and_param_type=None,
                   model_name=None,
                   model_executer=None,
                   model_struct=None,
                   dataset_path=None,
                   learning_rate=1e-4,
                   batch_size=64,
                   epochs=2,
                   max_batches=600,
                   num_workers=8,
                   return_model_data=False,
                   verbose=True,
                   return_bitstream=False,
                   task_type="NeRF",
                   dataset_type="blender",
                   N_iters=50000,
                   learning_rate_decay=0.1,
                   i_save=10000,
                   scene=None,
                   mlp_config=None,
                   mesh=None,
                   use_fused_mlp=False,
                   occupancy_renders=False,
                   occupancy_tuning=False,
                   decompose_rank=None,
                   decompose_energy=None,
                   render_factor=0,
                   precrop_iters=0,
                   precrop_frac=0.5,
                   N_rand=1024,
                   n_samples=64,
                   n_importance=None,
                   device=None):
    """Compress a model into an NNR bitstream (the reference's signature,
    plus ``device``: where the NeRF executer renders; None requires CUDA)."""
    if lsa or fine_tune:
        raise NotImplementedError(
            "lsa / fine_tune are not ported to nnc_tpu_torch yet "
            "(ROADMAP B1: the fused train kernel pair)")
    if occupancy_renders or occupancy_tuning:
        raise NotImplementedError(
            "occupancy mode is not ported to nnc_tpu_torch yet (ROADMAP A4)")
    if mesh is not None:
        raise NotImplementedError("nnc_tpu_torch renders on one device; "
                                  "mesh is not supported")

    if ioq and model_executer is None and task_type == "NeRF":
        if mlp_config is None:
            if isinstance(model_path_or_object, str):
                _, parameters = torch_io.create_NNC_model_instance_from_file(
                    model_path_or_object)
            else:
                _, parameters = \
                    torch_io.create_NNC_model_instance_from_object(
                        model_path_or_object)
            mlp_config = nerf.config_from_state_dict(parameters, "model.")
        model_executer = create_nerf_model_executer(
            dataset_type=dataset_type, dataset_path=dataset_path,
            scene=scene, device=resolve_device(device),
            learning_rate=learning_rate, epochs=epochs,
            learning_rate_decay=learning_rate_decay, n_iters=N_iters,
            i_save=i_save, mlp_config=mlp_config,
            use_fused_mlp=use_fused_mlp, verbose=verbose,
            render_factor=render_factor, precrop_iters=precrop_iters,
            precrop_frac=precrop_frac, n_rand=N_rand, n_samples=n_samples,
            n_importance=n_importance)

    return _codec.compress_model(
        model_path_or_object, bitstream_path=bitstream_path, qp=qp,
        qp_density=qp_density, nonweight_qp=nonweight_qp,
        qp_per_tensor=qp_per_tensor, use_dq=use_dq,
        codebook_mode=codebook_mode, scan_order=scan_order,
        lambda_scale=lambda_scale, param_opt=param_opt,
        cabac_unary_length_minus1=cabac_unary_length_minus1, opt_qp=opt_qp,
        ioq=ioq, ioq_codebook=ioq_codebook, bnf=bnf, lsa=False,
        fine_tune=False, block_id_and_param_type=block_id_and_param_type,
        model_name=model_name, model_executer=model_executer,
        model_struct=model_struct, dataset_path=dataset_path,
        learning_rate=learning_rate, batch_size=batch_size, epochs=epochs,
        max_batches=max_batches, num_workers=num_workers,
        return_model_data=return_model_data, verbose=verbose,
        return_bitstream=return_bitstream, task_type=task_type,
        dataset_type=dataset_type, N_iters=N_iters,
        learning_rate_decay=learning_rate_decay, i_save=i_save, scene=scene,
        mlp_config=mlp_config, mesh=None, use_fused_mlp=use_fused_mlp,
        decompose_rank=decompose_rank, decompose_energy=decompose_energy,
        render_factor=render_factor, precrop_iters=precrop_iters,
        precrop_frac=precrop_frac, N_rand=N_rand, n_samples=n_samples,
        n_importance=n_importance)
