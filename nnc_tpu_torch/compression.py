"""Top-level codec API: compress_model / compress / decompress /
decompress_model.

Counterpart of ``nnc_tpu/compression.py``, stage for stage (reference:
nnc/compression.py:74-842): model ingestion -> block structure inference ->
approx_data init -> per-tensor QP assignment -> optional IOQ -> optional
LSA/fine-tune (training scales through the NeRF renderer) -> optional BN
folding -> final quantization -> NNR encoding; and the inverse chain on
decode (rec -> unfold_bn -> apply_lsa -> recompose). For the same weights
and arguments it writes the same bytes.

What differs is the executer that ``compress_model`` builds when ``lsa``,
``fine_tune`` or ``ioq`` asks for one: the PyTorch ``NeRFModelExecuter`` on
``device`` (None requires a CUDA device). A failure to build it raises; the
stages are not switched off behind the caller's back. Occupancy mode and a
device mesh are not ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict

import numpy as np

from . import coder, hls
from .core import approximator
from .core import model as nnr_model
from .models import nerf
from .parallel import data_devices
from .utils.device import resolve_device
from .utils.logging import StageTimer


def guess_block_id_and_param_type(model_or_dict, model_parameters=None):
    """Infer block structure for a torch-style model/state dict.
    (reference: nnc/compression.py:29-71)"""
    from .framework import torch_io
    nnc_mdl = torch_io.TorchModel()
    if model_parameters is None:
        model_parameters = nnc_mdl.init_model_from_model_object(model_or_dict)
    return nnc_mdl.guess_block_id_and_param_type(model_parameters)


def add_lsa_scaling_parameters(parameter_dict):
    """Insert per-output-channel ``weight_scaling`` vectors after every >=2-D
    ``.weight`` tensor (the state-dict equivalent of wrapping Linear/Conv2d
    layers in Scaled* modules; reference: transforms.py:113-168)."""
    out = OrderedDict()
    for name, value in parameter_dict.items():
        out[name] = value
        if name.endswith(".weight") and np.asarray(value).ndim >= 2:
            ls_name = name + "_scaling"
            if ls_name not in parameter_dict:
                out[ls_name] = np.ones((np.asarray(value).shape[0],),
                                       np.float32)
    return out


def _executer_device(device, mesh):
    """Where the executer renders: ``device``, else the mesh's first data
    device, else the first CUDA device (an error where there is none)."""
    if device is None and mesh is not None:
        return data_devices(mesh)[0]
    return resolve_device(device)


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
    """Compress a model (torch module, state dict, flat numpy dict, or file
    path) into an NNR bitstream. (reference: nnc/compression.py:74-315)
    ``device``: where the NeRF executer renders; None means the first data
    device of ``mesh`` (``parallel.Mesh``: LSA and fine-tuning steps run
    data-parallel over it) or, without one, the first CUDA device, which
    must exist."""
    from .framework import tf_io, torch_io

    if tf_io.is_tef_model(model_path_or_object):
        if isinstance(model_path_or_object, str):
            nnc_mdl, parameters = tf_io.create_NNC_model_instance_from_file(
                model_path_or_object)
        else:
            nnc_mdl, parameters = tf_io.create_NNC_model_instance_from_object(
                model_path_or_object)
        if lsa:
            # TF models are compress/decompress only (reference:
            # nnc/compression.py:136-138)
            print("INFO: LSA is not supported for TensorFlow models; "
                  "disabled.")
            lsa = False
    elif isinstance(model_path_or_object, str):
        nnc_mdl, parameters = torch_io.create_NNC_model_instance_from_file(
            model_path_or_object)
    else:
        nnc_mdl, parameters = torch_io.create_NNC_model_instance_from_object(
            model_path_or_object)

    if lsa:
        parameters = add_lsa_scaling_parameters(parameters)
        parameters = nnc_mdl.init_model_from_dict(parameters)

    if block_id_and_param_type is None and (lsa or bnf):
        block_id_and_param_type = nnc_mdl.guess_block_id_and_param_type(
            parameters)

    if block_id_and_param_type is not None:
        ok = nnr_model.sanity_check_block_id_and_param_type(
            block_id_and_param_type, parameters)
        if not ok:
            print("INFO: Sanity check for block_id_and_param_type failed! "
                  "block_id_and_param_type has been set to None, and lsa "
                  "and bnf have been disabled!")
            block_id_and_param_type = None
            lsa = False
            bnf = False
            for name in [n for n in parameters
                         if n.endswith("weight_scaling")]:
                del parameters[name]
            parameters = nnc_mdl.init_model_from_dict(parameters)

    if (lsa or fine_tune or ioq) and model_executer is None \
            and task_type == "NeRF":
        from .train import lsa as lsa_train
        from .train.presets import create_nerf_model_executer
        if mlp_config is None and "mip360" not in (scene or {}):
            # infer D/W/skips/viewdirs from the checkpoint itself so
            # non-8x256 models work without an explicit mlp_config (the
            # reference hardcodes the architecture, utils.py:18-80)
            mlp_config = nerf.config_from_state_dict(parameters, "model.")
        model_executer = create_nerf_model_executer(
            dataset_type=dataset_type, dataset_path=dataset_path,
            scene=scene, device=_executer_device(device, mesh),
            learning_rate=learning_rate, epochs=epochs,
            learning_rate_decay=learning_rate_decay, n_iters=N_iters,
            i_save=i_save, mlp_config=mlp_config,
            use_fused_mlp=use_fused_mlp, verbose=verbose,
            render_factor=render_factor, precrop_iters=precrop_iters,
            precrop_frac=precrop_frac, n_rand=N_rand,
            n_samples=n_samples, n_importance=n_importance, mesh=mesh)
        lsa_train.route(model_executer.rc).refuse(
            occupancy=occupancy_renders or occupancy_tuning)
        if occupancy_renders or occupancy_tuning:
            # reference: nnc_tpu/compression.py:179-187
            model_executer.rc = dataclasses.replace(
                model_executer.rc,
                use_occupancy_renders=occupancy_renders
                or model_executer.rc.use_occupancy_renders,
                use_occupancy_tuning=occupancy_tuning
                or model_executer.rc.use_occupancy_tuning)

    result = compress(
        parameters,
        num_workers=num_workers,
        bitstream_path=bitstream_path,
        qp=qp,
        qp_density=qp_density,
        nonweight_qp=nonweight_qp,
        qp_per_tensor=qp_per_tensor,
        use_dq=use_dq,
        codebook_mode=codebook_mode,
        scan_order=scan_order,
        lambda_scale=lambda_scale,
        param_opt=param_opt,
        cabac_unary_length_minus1=cabac_unary_length_minus1,
        opt_qp=opt_qp,
        ioq=ioq,
        ioq_codebook=ioq_codebook,
        bnf=bnf,
        lsa=lsa,
        fine_tune=fine_tune,
        block_id_and_param_type=block_id_and_param_type,
        model=nnc_mdl,
        model_executer=model_executer,
        verbose=verbose,
        return_bitstream=return_bitstream,
        decompose_rank=decompose_rank,
        decompose_energy=decompose_energy,
    )

    if return_model_data and return_bitstream:
        return result, block_id_and_param_type
    if return_model_data:
        return block_id_and_param_type
    if return_bitstream:
        return result
    return None


def compress(parameter_dict,
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
             model=None,
             model_executer=None,
             verbose=True,
             return_bitstream=False,
             decompose_rank=None,
             decompose_energy=None,
             num_workers=0):
    """Compress a flat parameter dict. (reference: nnc/compression.py:318-563)

    decompose_rank/decompose_energy enable low-rank (G/H) weight
    factorization before quantization (extension; the NNR DC block syntax is
    fully supported on decode either way)."""
    timer = StageTimer(verbose)

    if model is not None and model.model_info is not None:
        model_info = model.model_info
        parameters = parameter_dict
    else:
        nnc_mdl = nnr_model.NNRModel(parameter_dict)
        parameters = nnc_mdl.init_model_from_dict(parameter_dict)
        model_info = nnc_mdl.model_info

    if block_id_and_param_type is not None:
        nnr_model.set_block_id_and_param_type(model_info,
                                              block_id_and_param_type)

    # capability gating (reference: compression.py:424-436)
    if model_executer is None:
        if lsa:
            print("INFO: lsa requires a model executer; disabled.")
            lsa = False
        if fine_tune:
            print("INFO: fine_tune requires a model executer; disabled.")
            fine_tune = False
        if ioq:
            print("INFO: ioq requires a model executer; disabled.")
            ioq = False
    else:
        if lsa and not model_executer.has_tune_lsa():
            print("INFO: executer cannot tune lsa; disabled.")
            lsa = False
        if fine_tune and not model_executer.has_tune_ft():
            print("INFO: executer cannot fine-tune; disabled.")
            fine_tune = False
        if ioq and not model_executer.has_eval():
            print("INFO: executer cannot eval; ioq disabled.")
            ioq = False

    with timer.stage("INITIALIZE APPROX DATA"):
        approx_data = approximator.init_approx_data(
            parameters, model_info, qp_density, scan_order)

    if decompose_rank is not None or decompose_energy is not None:
        with timer.stage("LOW-RANK DECOMPOSITION"):
            approximator.decompose_params(
                model_info, approx_data, rank=decompose_rank,
                energy=decompose_energy if decompose_energy else 0.9)

    with timer.stage("PREPROCESS QPs"):
        ap_info = approximator.ApproxInfo(
            approx_data, model_info, "uniform", codebook_mode, qp, opt_qp,
            not use_dq, cabac_unary_length_minus1, lambda_scale,
            nonweight_qp=nonweight_qp, qp_per_tensor=qp_per_tensor)

    if ioq:
        with timer.stage("INFERENCE-BASED QP OPT"):
            approximator.inference_based_qp_opt(
                ap_info.approx_info, model_info, model_executer, approx_data,
                param_opt, cabac_unary_length_minus1, verbose,
                try_codebook=ioq_codebook)

    if lsa or fine_tune:
        with timer.stage("LSA / FINE-TUNE"):
            approximator.run_ft_and_lsa(
                model_info, approx_data, ap_info, model_executer,
                block_id_and_param_type, lsa, fine_tune, use_dq, verbose,
                bitstream_path)

    if bnf:
        with timer.stage("BATCH-NORM FOLDING"):
            approximator.fold_bn(model_info, approx_data, ap_info)

    with timer.stage("QUANTIZATION"):
        approx_data_enc = approximator.approx(
            ap_info.approx_info, model_info, approx_data,
            1 if param_opt else 0, verbose=verbose, num_workers=num_workers)

    with timer.stage("ENCODING"):
        enc_info = {
            "cabac_unary_length_minus1": cabac_unary_length_minus1,
            "param_opt_flag": 1 if param_opt else 0,
        }
        bitstream = coder.encode(enc_info, model_info, approx_data_enc,
                                 num_workers=num_workers)

    original_size = model_info.get("original_size") or sum(
        np.asarray(v).nbytes for v in parameters.values())
    if verbose:
        print(f"COMPRESSED FROM {original_size} BYTES TO {len(bitstream)} "
              f"BYTES ({len(bitstream) / max(1, original_size) * 100:.2f}%)")

    if bitstream_path:
        os.makedirs(os.path.dirname(os.path.abspath(bitstream_path)),
                    exist_ok=True)
        with open(bitstream_path, "wb") as f:
            f.write(bytes(bitstream))

    if return_bitstream:
        return bytes(bitstream)
    return None


def decompress(bitstream_or_path, verbose=True, return_model_information=False,
               num_workers=0, model_info=None, ndu_oob=None):
    """Decode an NNR bitstream back to a parameter dict.
    (reference: nnc/compression.py:566-672)

    num_workers > 1 decodes independent NDUs across host threads (the
    native decoder releases the GIL). ``model_info`` supplies external model
    information (required for streams encoded with out-of-band NDU headers,
    see coder.compile_ndu_oob); ``ndu_oob`` is the compile_ndu_oob dict
    itself (required for fully out-of-band streams,
    input_parameters_present_flag = 0)."""
    timer = StageTimer(verbose)
    if isinstance(bitstream_or_path, (str, os.PathLike)):
        with open(bitstream_or_path, "rb") as f:
            bitstream = f.read()
    else:
        bitstream = bytes(bitstream_or_path)

    with timer.stage("DECODING"):
        model_info, approx_data = coder.decode(bitstream,
                                               model_info=model_info,
                                               num_workers=num_workers,
                                               ndu_oob=ndu_oob)

    with timer.stage("RECONSTRUCTION"):
        approximator.rec(approx_data, num_workers=num_workers)
        approximator.unfold_bn(model_info, approx_data)
        approximator.apply_lsa(model_info, approx_data)
        approx_data = approximator.recompose_params(model_info, approx_data)

    parameters = approx_data["parameters"]
    if return_model_information:
        return parameters, model_info
    return parameters


def decompress_model(bitstream_path, model_path=None, verbose=True,
                     return_decompressed_model=True, model_executer=None,
                     test_model=False):
    """Decode and (optionally) save as a torch ``.pt`` state dict.
    (reference: nnc/compression.py:675-842)"""
    parameters, model_info = decompress(bitstream_path, verbose=verbose,
                                        return_model_information=True)
    if model_path is not None:
        if model_info["topology_storage_format"] in (
                hls.TopologyStorageFormat.NNR_TPL_PYT,
                hls.TopologyStorageFormat.NNR_TPL_UNREC, None):
            from .framework.torch_io import save_to_torch_file
            save_to_torch_file(parameters, model_path)
        elif model_info["topology_storage_format"] == \
                hls.TopologyStorageFormat.NNR_TPL_TEF:
            from .framework.tf_io import save_to_tensorflow_file
            save_to_tensorflow_file(parameters, model_path)
        else:
            raise NotImplementedError(
                f"saving topology format "
                f"{model_info['topology_storage_format']} not supported")
    if test_model and model_executer is not None:
        acc = model_executer.test_model(parameters, verbose=verbose)
        if verbose:
            print(f"Decompressed model test metric: {acc}")
    if return_decompressed_model:
        return parameters
    return None
