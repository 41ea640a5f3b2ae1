"""Approximator: per-tensor quantization orchestration and model transforms.

Maintains the ``approx_data`` dict through the codec pipeline:

.. code-block:: python

    approx_data = {
        "approx_method": {param: "uniform"|"codebook"|"skip"},
        "qp_density": np.int32,
        "qp": {param: int},
        "dq_flag": {param: 0|1},
        "decomposition_rank": {block_id: int},
        "g_number_of_rows": {block_id: int},
        "scan_order": {param: int},          # only for ndim > 1
        "parameters": {param: np.ndarray},   # float32 or int32 (quantized)
        "compressed_parameter_types": {block_id: int},
        "codebooks": {param: np.ndarray},
        "codebooks_egk": {param: int},
        "codebook_zero_offsets": {param: int},
    }

Stage semantics follow the reference approximator
(reference: nnc_core/approximator/__init__.py:46-913, baseline.py, codebook.py,
integer.py); the quantizer/entropy backend is the native codec in
``nnc_tpu_torch.coder.cabac``.
"""
from __future__ import annotations

import copy

import numpy as np

from .. import hls
from ..coder import cabac
from . import common
from .model import (NNRBlockAccess, NNRModelAccess, O_TYPES, W_TYPES,
                    add_lsa_to_block_id_and_param_type)


def del_param(approx_data, approx_info, param):
    del approx_data["parameters"][param]
    approx_data["scan_order"].pop(param, None)
    approx_info.get("qp", {}).pop(param, None)
    approx_info.get("dq_flag", {}).pop(param, None)


def init_approx_data(parameters, model_info, qp_density, scan_order):
    """Build a fresh approx_data for a parameter dict.
    (reference: approximator/__init__.py:46-114)"""
    approx_data = {
        "approx_method": {},
        "qp_density": np.int32(qp_density),
        "qp": {},
        "dq_flag": {},
        "decomposition_rank": {},
        "g_number_of_rows": {},
        "scan_order": {},
        "parameters": copy.copy(parameters),
        "compressed_parameter_types": {},
        "codebooks": {},
        "codebooks_egk": {},
        "codebook_zero_offsets": {},
    }

    for x in parameters:
        assert (x.endswith("_G") or x.endswith("_H")) == \
               (("_G" in x) or ("_H" in x)), x
        base = x[:-2] if (x.endswith("_G") or x.endswith("_H")) else x
        if len(model_info["parameter_dimensions"][base]) > 1:
            approx_data["scan_order"][x] = np.int32(scan_order)

    for block_id in model_info["block_identifier"].values():
        if block_id is None:
            continue
        block_access = NNRBlockAccess(model_info, block_id)
        cpt = 0
        if block_access.bn_gamma:
            cpt += hls.BlockParameterTypes.NNR_CPT_BN
        if block_access.bi in approx_data["parameters"]:
            cpt += hls.BlockParameterTypes.NNR_CPT_BI
        if block_access.dc_g in approx_data["parameters"]:
            cpt += hls.BlockParameterTypes.NNR_CPT_DC
            g = approx_data["parameters"][block_access.dc_g]
            approx_data["decomposition_rank"][block_id] = g.shape[1]
            approx_data["g_number_of_rows"][block_id] = g.shape[0]
        if block_access.ls in approx_data["parameters"]:
            cpt += hls.BlockParameterTypes.NNR_CPT_LS
        approx_data["compressed_parameter_types"][block_id] = cpt

    return approx_data


# ---------------------------------------------------------------------------
# BN folding / unfolding
# ---------------------------------------------------------------------------
def fold_bn(model_info, approx_data, ap_info):
    """Fold batch-norm tensors into the block's LSA scale (alpha) and bias
    (delta): g = gamma / sqrt(var + eps); alpha *= g;
    delta = (delta - mean) * g + beta. (reference: approximator:117-201)"""
    model_access = NNRModelAccess(model_info)
    for block_access in model_access.blocks_and_params():
        block_id = block_access.block_id
        if block_id is None:
            continue
        cpt = approx_data["compressed_parameter_types"][block_id]
        ad = approx_data["parameters"]
        assert not approx_data["approx_method"]
        eps = (1e-3 if model_info["topology_storage_format"] ==
               hls.TopologyStorageFormat.NNR_TPL_TEF else 1e-5)

        if cpt & hls.BlockParameterTypes.NNR_CPT_BN == 0:
            continue
        delta = block_access.bi
        bn_shape = ad[block_access.bn_mean].shape
        dq_flag = ap_info.approx_info["dq_flag"][block_access.bn_mean]

        assert (cpt & hls.BlockParameterTypes.NNR_CPT_BI == 0) == \
               (delta not in ad)
        if cpt & hls.BlockParameterTypes.NNR_CPT_BI == 0:
            ad[delta] = np.zeros(bn_shape, dtype=np.float32)
            approx_data["compressed_parameter_types"][block_id] += \
                hls.BlockParameterTypes.NNR_CPT_BI
            # companions are always uniform-coded here (codebook applies to
            # weights only), so assign qp/dq regardless of approx_method
            ap_info.approx_info["qp"][delta] = ap_info.qp_other
            ap_info.approx_info["dq_flag"][delta] = dq_flag

        alpha = block_access.ls
        assert (cpt & hls.BlockParameterTypes.NNR_CPT_LS == 0) == \
               (alpha not in ad)
        if cpt & hls.BlockParameterTypes.NNR_CPT_LS == 0:
            ad[alpha] = np.ones(bn_shape, dtype=np.float32)
            approx_data["compressed_parameter_types"][block_id] += \
                hls.BlockParameterTypes.NNR_CPT_LS
            ap_info.approx_info["qp"][alpha] = ap_info.qp_lsa
            ap_info.approx_info["dq_flag"][alpha] = dq_flag

        g = ad[block_access.bn_gamma] / np.sqrt(ad[block_access.bn_var] + eps)
        del_param(approx_data, ap_info.approx_info, block_access.bn_gamma)
        del_param(approx_data, ap_info.approx_info, block_access.bn_var)
        ad[alpha] = ad[alpha] * g
        ad[delta] = (ad[delta] - ad[block_access.bn_mean]) * g + \
            ad[block_access.bn_beta]
        del_param(approx_data, ap_info.approx_info, block_access.bn_mean)
        del_param(approx_data, ap_info.approx_info, block_access.bn_beta)
        approx_data["compressed_parameter_types"][block_id] -= \
            hls.BlockParameterTypes.NNR_CPT_BN


def unfold_bn(model_info, approx_data):
    """Restore identity BN tensors after decode of a BN-folded model.
    (reference: approximator:204-253)"""
    model_access = NNRModelAccess(model_info)
    for block_access in model_access.blocks_and_params():
        block_id = block_access.block_id
        if block_id is None:
            continue
        bn_absent = approx_data["compressed_parameter_types"][block_id] & \
            hls.BlockParameterTypes.NNR_CPT_BN == 0
        bn_folded = bn_absent and \
            (block_access.bn_gamma in model_info["parameter_type"])
        if not bn_folded:
            continue
        approx_data["compressed_parameter_types"][block_id] += \
            hls.BlockParameterTypes.NNR_CPT_BN
        delta = block_access.bi
        dims = approx_data["parameters"][delta].shape
        if delta not in model_info["parameter_type"]:
            assert approx_data["compressed_parameter_types"][block_id] & \
                hls.BlockParameterTypes.NNR_CPT_BI != 0
            approx_data["parameters"][block_access.bn_beta] = \
                approx_data["parameters"][delta]
            del approx_data["parameters"][delta]
            approx_data["compressed_parameter_types"][block_id] -= \
                hls.BlockParameterTypes.NNR_CPT_BI
        else:
            approx_data["parameters"][block_access.bn_beta] = \
                np.zeros(dims, dtype=np.float32)
        approx_data["parameters"][block_access.bn_mean] = \
            np.zeros(dims, dtype=np.float32)
        approx_data["parameters"][block_access.bn_gamma] = \
            np.ones(dims, dtype=np.float32)
        approx_data["parameters"][block_access.bn_var] = \
            np.ones(dims, dtype=np.float32)


# ---------------------------------------------------------------------------
# Low-rank decomposition (DC): producer for the G/H path
# ---------------------------------------------------------------------------
def decompose_params(model_info, approx_data, rank=None, energy=0.9,
                     min_gain=1.1):
    """Replace block weights by truncated-SVD factors ``<w>_G`` (out, r) and
    ``<w>_H`` (r, in') when the factorization is at least ``min_gain`` times
    smaller. The reference supports coding/decoding DC blocks but ships no
    producer (inherited from NNCodec); this supplies one. ``rank=None``
    chooses the smallest rank capturing ``energy`` of the spectrum."""
    model_access = NNRModelAccess(model_info)
    for block_access in model_access.blocks_and_params():
        block_id = block_access.block_id
        if block_id is None:
            continue
        cpt = approx_data["compressed_parameter_types"][block_id]
        if cpt & hls.BlockParameterTypes.NNR_CPT_DC:
            continue
        w_name = block_access.w
        w = approx_data["parameters"][w_name]
        if w.ndim < 2:
            continue
        mat = w.reshape(w.shape[0], -1)
        u, s, vt = np.linalg.svd(mat, full_matrices=False)
        if rank is None:
            cum = np.cumsum(s ** 2) / max(1e-12, np.sum(s ** 2))
            r = int(np.searchsorted(cum, energy) + 1)
        else:
            r = int(min(rank, s.size))
        if mat.size < min_gain * r * (mat.shape[0] + mat.shape[1]):
            continue  # factorization not worth it for this tensor
        g = (u[:, :r] * s[:r]).astype(np.float32)
        h = vt[:r].astype(np.float32)
        del approx_data["parameters"][w_name]
        approx_data["parameters"][w_name + "_G"] = g
        approx_data["parameters"][w_name + "_H"] = h
        approx_data["compressed_parameter_types"][block_id] = \
            cpt + hls.BlockParameterTypes.NNR_CPT_DC
        approx_data["decomposition_rank"][block_id] = r
        approx_data["g_number_of_rows"][block_id] = g.shape[0]
        if w.ndim > 1:
            so = approx_data["scan_order"].pop(w_name, np.int32(0))
            approx_data["scan_order"][w_name + "_G"] = so
            approx_data["scan_order"][w_name + "_H"] = so


# ---------------------------------------------------------------------------
# LSA
# ---------------------------------------------------------------------------
def set_lsa(model_info, approx_data, lsa_params):
    """Inject tuned LSA scale vectors into approx_data.
    (reference: approximator:255-274)"""
    for k, v in lsa_params.items():
        approx_data["parameters"][k] = np.asarray(v, dtype=np.float32).reshape(
            [np.asarray(v).shape[0]])
        bid = model_info["block_identifier"].get(k)
        if bid is not None:
            approx_data["compressed_parameter_types"][bid] |= \
                hls.BlockParameterTypes.NNR_CPT_LS


def apply_lsa(model_info, approx_data):
    """Bake LSA scales into the weights after decode: w *= ls.reshape(-1,1..).
    (reference: approximator:276-318)"""
    assert not approx_data["approx_method"]
    model_access = NNRModelAccess(model_info)
    for block_access in model_access.blocks_and_params():
        block_id = block_access.block_id
        if block_id is None:
            continue
        cpt = approx_data["compressed_parameter_types"][block_id]
        if cpt & hls.BlockParameterTypes.NNR_CPT_LS == 0:
            continue
        ls = approx_data["parameters"].pop(block_access.ls)
        model_info["parameter_index"].pop(block_access.ls, None)
        model_info["block_identifier"].pop(block_access.ls, None)
        if cpt & hls.BlockParameterTypes.NNR_CPT_DC:
            w = approx_data["parameters"][block_access.dc_g]
        else:
            w = approx_data["parameters"][block_access.w]
        dims_ls = [-1] + [1] * (w.ndim - 1)
        w *= ls.reshape(dims_ls)
        approx_data["compressed_parameter_types"][block_id] -= \
            hls.BlockParameterTypes.NNR_CPT_LS

    # LS tensors that were split out of their block NDU (e.g. codebook-coded
    # companions, coder._partition_block) decode as free-standing params with
    # no NNR_CPT_LS bit; fold them by the w + "_scaling" name convention.
    for name in [n for n in approx_data["parameters"]
                 if n.endswith("_scaling")]:
        base = name[: -len("_scaling")]
        target = base + "_G" if base + "_G" in approx_data["parameters"] \
            else base
        if target not in approx_data["parameters"]:
            continue
        ls = approx_data["parameters"].pop(name)
        model_info["parameter_index"].pop(name, None)
        model_info["block_identifier"].pop(name, None)
        w = approx_data["parameters"][target]
        w *= ls.reshape([-1] + [1] * (w.ndim - 1))


def recompose_params(model_info, approx_data_in):
    """Recompose low-rank (G·H) weights and re-sort parameters by index.
    (reference: approximator:320-384)"""
    assert not approx_data_in["approx_method"]
    approx_data_out = {k: copy.copy(v) for k, v in approx_data_in.items()}
    model_access = NNRModelAccess(model_info)
    for block_access in model_access.blocks_and_params():
        block_id = block_access.block_id
        if block_id is None:
            continue
        cpt = approx_data_out["compressed_parameter_types"][block_id]
        if cpt & hls.BlockParameterTypes.NNR_CPT_DC == 0:
            continue
        g = approx_data_out["parameters"].pop(block_access.dc_g)
        h = approx_data_out["parameters"].pop(block_access.dc_h)
        w = g.dot(h).reshape(model_info["parameter_dimensions"][block_access.w])
        approx_data_out["parameters"][block_access.w] = w
        approx_data_out["compressed_parameter_types"][block_id] -= \
            hls.BlockParameterTypes.NNR_CPT_DC
        model_info["parameter_index"][block_access.w] = \
            model_info["parameter_index"].pop(block_access.dc_g)
        del model_info["block_identifier"][block_access.dc_g]
        model_info["parameter_index"].pop(block_access.dc_h, None)
        model_info["block_identifier"].pop(block_access.dc_h, None)

    order = sorted(model_info["parameter_index"],
                   key=model_info["parameter_index"].get)
    approx_data_out["parameters"] = {
        p: approx_data_out["parameters"][p] for p in order}
    return approx_data_out


# ---------------------------------------------------------------------------
# Quantization methods
# ---------------------------------------------------------------------------
def _iter_to_approximate(approx_info, model_info, approx_data):
    """Yield (par_type, param) pairs eligible for approximation."""
    model_access = NNRModelAccess(model_info)
    for block_or_param in model_access.blocks_and_params():
        for par_type, param, _ in block_or_param.param_generator(
                approx_data["compressed_parameter_types"]):
            if (par_type in approx_info["to_approximate"]) and \
                    (param not in approx_data["approx_method"]):
                yield par_type, param


def _quant_one(approx_info, approx_data, param, dq_flag, qp):
    """Quantize one tensor, returning (int32 values, final qp)."""
    encoder = cabac.Encoder()
    encoder.initCtxModels(approx_info["cabac_unary_length_minus1"], 0)
    x = approx_data["parameters"][param]
    q = np.zeros(x.shape, dtype=np.int32)
    qp_out = encoder.quantLayer(
        x, q, dq_flag, int(approx_data["qp_density"]), int(qp),
        approx_info["lambda_scale"], approx_info["cabac_unary_length_minus1"],
        int(approx_data["scan_order"].get(param, 0)))
    return q, qp_out


def uniform_approx(approx_info, model_info, approx_data_in, verbose=True,
                   num_workers=0):
    """Uniform (optionally dependent) scalar quantization of all eligible
    tensors. (reference: approximator/baseline.py:10-71; the reference
    quantizes serially — per-tensor RDOQ is independent and the native
    quantLayer releases the GIL, so tensors fan out across host threads)"""
    approx_data_out = {k: copy.copy(v) for k, v in approx_data_in.items()}
    todo = list(_iter_to_approximate(approx_info, model_info,
                                     approx_data_in))

    def one(param):
        enc_qp = int(approx_info["qp"][param])
        dq_flag = int(approx_info["dq_flag"][param])
        q, qp = _quant_one(approx_info, approx_data_in, param, dq_flag,
                           enc_qp)
        return param, enc_qp, dq_flag, q, qp

    if num_workers and num_workers > 1 and len(todo) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(one, [p for _, p in todo]))
    else:
        results = [one(p) for _, p in todo]

    for param, enc_qp, dq_flag, q, qp in results:
        if qp != enc_qp and verbose:
            print(f"INFO: QP for {param} has been clipped from {enc_qp} to "
                  f"{qp} to avoid int32_t overflow!")
        approx_data_out["qp"][param] = qp
        approx_data_out["parameters"][param] = q
        approx_data_out["approx_method"][param] = "uniform"
        approx_data_out["dq_flag"][param] = dq_flag
    return approx_data_out


def uniform_rec(param, approx_data):
    """Dequantize one uniform-coded tensor in place.
    (reference: approximator/baseline.py:73-101)"""
    values = approx_data["parameters"][param]
    assert values.dtype == np.int32
    out = np.zeros(values.shape, dtype=np.float32)
    decoder = cabac.Decoder()
    decoder.dequantLayer(out, values, int(approx_data["qp_density"]),
                         int(approx_data["qp"][param]),
                         int(approx_data["scan_order"].get(param, 0)),
                         int(approx_data["dq_flag"].get(param, 0)))
    approx_data["parameters"][param] = out
    del approx_data["approx_method"][param]


def skip_approx(approx_info, model_info, approx_data_in):
    """int32 tensors pass through unquantized ('skip').
    (reference: approximator/integer.py:11-42)"""
    approx_data_out = {k: copy.copy(v) for k, v in approx_data_in.items()}
    for _par_type, param in _iter_to_approximate(approx_info, model_info,
                                                 approx_data_in):
        if approx_data_in["parameters"][param].dtype == np.int32:
            approx_data_out["approx_method"][param] = "skip"
            approx_data_out["dq_flag"][param] = 0
    return approx_data_out


def skip_rec(param, approx_data):
    assert approx_data["parameters"][param].dtype == np.int32
    del approx_data["approx_method"][param]


# --- codebook method -------------------------------------------------------
def derive_sorted_codebook_from_tensor(tensor):
    """(reference: codebook.py:14-39)"""
    codebook, indices = np.unique(tensor, return_inverse=True)
    return codebook, indices.reshape(tensor.shape).astype(np.int32)


def _encoded_size(values, dq_flag, scan_order, culm1, param_opt=0):
    enc = cabac.Encoder()
    enc.initCtxModels(culm1, param_opt)
    enc.encodeLayer(values, dq_flag, scan_order)
    return enc.finish().size


def get_codebook_offset(codebook, indices, cabac_unary_length_minus1):
    """Brute-force the codebook offset minimizing CABAC-coded index size.
    (reference: codebook.py:41-95)"""
    codebook_offset = 0
    if indices.dtype == np.int32:
        min_bits = None
        for cb in range(len(codebook)):
            bits = _encoded_size(indices - cb, 0, 0,
                                 cabac_unary_length_minus1, 1)
            if min_bits is None or bits < min_bits:
                min_bits = bits
                codebook_offset = cb
    return codebook, indices - codebook_offset, codebook_offset


def get_codebook_bytes(codebook, codebook_offset, egk):
    """Bits (rounded up to bytes via bit count) of the HLS-coded codebook."""
    buf = bytearray()
    w = hls.BitWriter(buf)
    w.ue(2, egk)
    w.ue(8, len(codebook))
    w.cb_zero_offset(len(codebook), codebook_offset)
    w.codebook(egk, len(codebook), codebook_offset, codebook)
    return (w.get_num_bits_touched() + 7) // 8


def get_best_egk(codebook, codebook_offset):
    """Search Exp-Golomb order 0..15 minimizing codebook size.
    (reference: codebook.py:97-137)"""
    best_egk, min_bytes = 0, None
    for egk in range(16):
        nbytes = get_codebook_bytes(codebook, codebook_offset, egk)
        if min_bytes is None or nbytes < min_bytes:
            min_bytes, best_egk = nbytes, egk
    return best_egk, min_bytes


def codebook_approx(approx_info, model_info, approx_data_in, param_opt=0,
                    verbose=True):
    """Codebook quantization: uniform-quantize (no DQ), unique values form the
    codebook, indices entropy-coded. mode 1 = always codebook; mode 2 = RD
    choice vs uniform. (reference: codebook.py:172-325)

    With codebook_mode == 0, ``approx_info["codebook_force"]`` (a set of
    tensor names, produced by the IOQ codebook arbitration) codebook-codes
    exactly those tensors, leaving everything else to uniform_approx —
    a per-tensor method assignment the reference's tensor-MSE mode-2 RD
    choice cannot express (it under-values codebooks' exactly-representable
    levels for rendered quality; BASELINE.md r4 companion note)."""
    approx_data_out = {k: copy.copy(v) for k, v in approx_data_in.items()}
    culm1 = approx_info["cabac_unary_length_minus1"]
    force = approx_info.get("codebook_force") \
        if approx_info["codebook_mode"] == 0 else None

    def _prepare(param):
        """Quantize + codebook stats for one tensor; returns dict of both
        options and their coded sizes (mode 2 needs them)."""
        qp_off = 0
        if approx_info["dq_flag"][param] == 1:
            qp_off = common.compute_qp_offset_to_dq_equivalent(
                int(approx_data_out["qp_density"]))
            if verbose:
                print("INFO: Dependent quantization (DQ) cannot be used "
                      "with 'codebook'. QP changed by "
                      f"{-qp_off} for similar performance.")
        enc_qp = int(approx_info["qp"][param]) - qp_off
        q, qp = _quant_one(approx_info, approx_data_in, param, 0, enc_qp)
        if qp != enc_qp and verbose:
            print(f"INFO: QP for {param} clipped from {enc_qp} to {qp}!")
        codebook, indexes = derive_sorted_codebook_from_tensor(q)
        codebook, indexes, cb_offset = get_codebook_offset(codebook, indexes,
                                                           culm1)
        egk, _ = get_best_egk(codebook, cb_offset)
        st = {"q": q, "qp": qp, "codebook": codebook, "indexes": indexes,
              "cb_offset": cb_offset, "egk": egk}
        if approx_info["codebook_mode"] == 2:
            dq_flag = int(approx_info["dq_flag"][param])
            q_uni, qp_uni = q, qp
            if dq_flag == 1:  # re-quantize with DQ at the original qp
                q_uni, qp_uni = _quant_one(approx_info, approx_data_in,
                                           param, 1,
                                           int(approx_info["qp"][param]))
            so = int(approx_data_in["scan_order"].get(param, 0))
            st.update(
                q_uni=q_uni, qp_uni=qp_uni, dq_flag=dq_flag,
                bytes_uni=_encoded_size(q_uni, dq_flag, so, culm1,
                                        param_opt),
                bytes_cb=_encoded_size(indexes, 0, so, culm1, param_opt)
                + get_codebook_bytes(codebook, cb_offset, egk))
        return st

    def _select_codebook(param, st):
        approx_data_out["qp"][param] = st["qp"]
        approx_data_out["parameters"][param] = st["indexes"]
        approx_data_out["codebooks"][param] = st["codebook"]
        approx_data_out["approx_method"][param] = "codebook"
        approx_data_out["dq_flag"][param] = 0
        approx_data_out["codebook_zero_offsets"][param] = st["cb_offset"]
        approx_data_out["codebooks_egk"][param] = st["egk"]

    def _select_uniform(param, st):
        approx_data_out["qp"][param] = st["qp_uni"]
        approx_data_out["parameters"][param] = st["q_uni"]
        approx_data_out["approx_method"][param] = "uniform"
        approx_data_out["dq_flag"][param] = st["dq_flag"]

    handled = set()
    for par_type, param in _iter_to_approximate(approx_info, model_info,
                                                approx_data_in):
        if param in handled:
            continue
        if force is not None:
            if param not in force:
                continue
            _select_codebook(param, _prepare(param))
            continue
        # All to_approximate tensors are codebook-eligible, companions
        # (bias/BN/LSA) included (reference: codebook.py:205-208). A block
        # whose companion ends up codebook-coded is split into per-tensor
        # NDUs by the coder (is_block_possible), mirroring the reference.
        # DC-decomposed G/H pairs share one codebook_present_flag in the
        # NDU syntax, so the method choice must be JOINT (an independent
        # mode-2 RD choice could diverge and produce an unencodable unit)
        pair = None
        if param.endswith("_G"):
            cand = param[:-2] + "_H"
            if cand in approx_data_in["parameters"]:
                pair = cand
        st = _prepare(param)
        if approx_info["codebook_mode"] == 1:
            _select_codebook(param, st)
            continue
        if pair is None:
            if st["bytes_cb"] < st["bytes_uni"]:
                _select_codebook(param, st)
            else:
                _select_uniform(param, st)
        else:
            st2 = _prepare(pair)
            handled.add(pair)
            if st["bytes_cb"] + st2["bytes_cb"] < \
                    st["bytes_uni"] + st2["bytes_uni"]:
                _select_codebook(param, st)
                _select_codebook(pair, st2)
            else:
                _select_uniform(param, st)
                _select_uniform(pair, st2)
    return approx_data_out, approx_info


def codebook_rec(param, approx_data):
    """(reference: codebook.py:328-363)"""
    assert approx_data["parameters"][param].dtype == np.int32
    cb = approx_data["codebooks"][param] * common.get_stepsize_from_qp(
        int(approx_data["qp"][param]), int(approx_data["qp_density"]))
    offset = approx_data["codebook_zero_offsets"][param]
    approx_data["parameters"][param] = np.float32(
        cb[approx_data["parameters"][param] + offset])
    del approx_data["approx_method"][param]
    del approx_data["codebooks"][param]
    del approx_data["codebook_zero_offsets"][param]
    del approx_data["codebooks_egk"][param]
    del approx_data["qp"][param]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def approx(approx_info, model_info, approx_data, param_opt=0, verbose=True,
           num_workers=0):
    """Quantize all eligible tensors with the configured method.
    (reference: approximator:690-701)"""
    approx_data = skip_approx(approx_info, model_info, approx_data)
    if approx_info["approx_method"] == "codebook" or \
            approx_info.get("codebook_force"):
        approx_data, approx_info = codebook_approx(
            approx_info, model_info, approx_data, param_opt, verbose=verbose)
    return uniform_approx(approx_info, model_info, approx_data,
                          verbose=verbose, num_workers=num_workers)


def rec(approx_data, num_workers=0):
    """Dequantize all quantized tensors in place.
    (reference: approximator:704-721; per-tensor reconstruction is
    independent and dequantLayer releases the GIL — fan out like approx)"""
    def one(param):
        method = approx_data["approx_method"].get(param)
        if method == "uniform":
            uniform_rec(param, approx_data)
        elif method == "codebook":
            codebook_rec(param, approx_data)
        elif method == "skip":
            skip_rec(param, approx_data)
        else:
            assert method is None, f"unknown approx_method {method}"

    params = list(approx_data["parameters"])
    if num_workers and num_workers > 1 and len(params) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(one, params))
    else:
        for param in params:
            one(param)


# ---------------------------------------------------------------------------
# LSA / FT orchestration
# ---------------------------------------------------------------------------
def run_ft_and_lsa(model_info, approx_data, ap_info, model_executer,
                   block_id_and_param_type, lsa_flag, ft_flag, use_dq,
                   verbose, bitstream_path):
    """Quantize -> dequantize -> tune (LSA scales and/or fine-tuned params
    against the dequantized weights) -> inject results into approx_data.
    (reference: approximator:603-687)"""
    approx_info_ft = copy.deepcopy(ap_info.approx_info)
    if not lsa_flag:
        approx_info_ft["to_approximate"] = list(W_TYPES)
    else:
        approx_info_ft["to_approximate"] = [
            t for t in approx_info_ft["to_approximate"] if t != "weight.ls"]

    approx_data_ft = approx(approx_info_ft, model_info, approx_data,
                            verbose=verbose)
    rec(approx_data_ft)

    tuned = model_executer.tune_model(
        bitstream_path=bitstream_path,
        parameters=approx_data_ft["parameters"],
        param_types=model_info["parameter_type"],
        lsa_flag=lsa_flag,
        ft_flag=ft_flag,
        verbose=verbose,
    )
    lsa_params, ft_params = tuned

    if ft_flag:
        approx_data["parameters"].update(ft_params)
    if lsa_flag:
        if block_id_and_param_type:
            set_lsa(model_info, approx_data, lsa_params)
            add_lsa_to_block_id_and_param_type(block_id_and_param_type,
                                               lsa_params)
        else:
            approx_data["parameters"].update(lsa_params)
        ap_info.set_ls_qps(model_info, approx_data, 1 if use_dq else 0)


def inference_based_qp_opt(approx_info, model_info, model_executer,
                           approx_data, param_opt, cabac_unary_length_minus1,
                           verbose=True, qp_offsets=(-4, -3, -2, -1,
                                                     1, 2, 3, 4),
                           force_full=False, try_codebook=False,
                           codebook_qp_offsets=(0, 1)):
    """Inference-optimised QP assignment, rate-distortion style.

    Mirrors the reference algorithm (reference: approximator:387-600):
    (1) quantize+encode+eval at QP, QP-1 and QP+1 globally to estimate the
    accuracy-per-byte tradeoff lambda = max((lambda_-1 + lambda_+1)/2, 0);
    (2) greedily refine per-tensor QPs (weights sorted by size, the largest
    kept at the global QP as the reference does) over ``qp_offsets``,
    accepting a change when cost = accuracy_drop + lambda * byte_delta
    improves on the best so far.

    Unlike the reference — which re-quantizes and re-encodes the ENTIRE
    model for every (tensor, offset) trial, ~8·N² tensor encodes — the
    refinement loop here delta-measures each uniform-mode trial: only the
    trial tensor is re-quantized/re-reconstructed and only its NDU is
    re-encoded (``coder.encode_param_unit``), with the rest of the size and
    reconstruction carried over. Per-tensor quantization, NDU framing and
    reconstruction are independent, so the decisions are identical to the
    full re-measure (equivalence-tested).

    ``try_codebook=True`` (delta mode only) additionally arbitrates
    uniform-vs-codebook per tensor with the SAME inference probe and
    lambda: each refined tensor is also trialled codebook-coded at
    ``qp + off`` for off in ``codebook_qp_offsets`` (and at its accepted
    refined qp). The reference's codebook_mode=2 decides by coded bytes at
    tensor-MSE-equivalent QPs (codebook.py:267-319), which measurably
    under-values codebooks' exactly-representable levels for rendered
    quality (BASELINE.md r4: forced codebook is ~2 dB above the flat RD
    curve at qp=-30 yet mode 2 picks uniform everywhere); arbitrating with
    the task probe captures that. Accepted tensors are recorded in
    ``approx_info["codebook_force"]``, which the final approx() honors.
    A method switch can re-partition a block's NDUs (partial split),
    changing sibling framing — so codebook trials delta the whole block's
    covering units (coder.encode_units_covering), not a single NDU.

    Cost drops from O(N) encodes per
    trial to O(1). ``force_full=True`` keeps the reference's full
    re-measure (also used when the approx method is not uniform)."""
    from .. import coder as _coder

    enc_info = {"cabac_unary_length_minus1": cabac_unary_length_minus1,
                "param_opt_flag": param_opt}

    def measure(info, want_state=False):
        ad_q = approx(info, model_info, approx_data, param_opt, verbose=False)
        bs = _coder.encode(enc_info, model_info, ad_q)
        quant = None
        if want_state:
            quant = dict(ad_q)
            quant["parameters"] = dict(ad_q["parameters"])
            quant["qp"] = dict(ad_q["qp"])
            quant["dq_flag"] = dict(ad_q["dq_flag"])
            quant["approx_method"] = dict(ad_q["approx_method"])
        ad_r = ad_q  # approx() deep-copies approx_data; safe to rec in place
        rec(ad_r)
        acc = model_executer.eval_model(ad_r["parameters"], verbose=False)
        acc = acc[0] if isinstance(acc, (tuple, list)) else acc
        return len(bs), float(acc), quant, ad_r["parameters"]

    def weight_params(info):
        out = []
        for p in info["qp"]:
            base = p[:-2] if (p.endswith("_G") or p.endswith("_H")) else p
            if model_info["parameter_type"].get(base) in W_TYPES:
                out.append(p)
        return out

    use_delta = (not force_full) and \
        approx_info["approx_method"] == "uniform"

    ref_size, ref_acc, cur_adq, cur_rec = measure(approx_info,
                                                  want_state=use_delta)
    if verbose:
        print(f"\tIOQ: baseline {ref_size} bytes, accuracy {ref_acc}")

    lambdas = []
    for global_off in (-1, +1):
        info = copy.deepcopy(approx_info)
        for p in weight_params(info):
            info["qp"][p] = int(info["qp"][p]) + global_off
        size, acc, _q, _r = measure(info)
        diff_br = size - ref_size
        lambdas.append(-(ref_acc - acc) / diff_br if diff_br else 0.0)
        if verbose:
            print(f"\tIOQ: QP{global_off:+d} -> {size} bytes, acc {acc}")
    lamb = max((lambdas[0] + lambdas[1]) / 2.0, 0.0)

    by_size = sorted(weight_params(approx_info),
                     key=lambda p: approx_data["parameters"][p].size,
                     reverse=True)
    best_info = copy.deepcopy(approx_info)
    best_cost = 0.0
    cur_rec = dict(cur_rec) if use_delta else None
    cur_size = ref_size

    def try_delta(p, qp_enc):
        """Measure (size, acc, state) for best_info with p's qp -> qp_enc,
        re-coding only p's tensor and NDU."""
        dq = int(best_info["dq_flag"][p])
        q, qp_out = _quant_one(approx_info, approx_data, p, dq, qp_enc)
        trial_adq = dict(cur_adq)
        trial_adq["parameters"] = dict(cur_adq["parameters"],
                                       **{p: q})
        trial_adq["qp"] = dict(cur_adq["qp"], **{p: qp_out})
        size = cur_size \
            - _coder.encode_param_unit(enc_info, model_info, cur_adq, p) \
            + _coder.encode_param_unit(enc_info, model_info, trial_adq, p)
        tiny = {"parameters": {p: q}, "qp": {p: qp_out},
                "qp_density": approx_data["qp_density"],
                "scan_order": approx_data["scan_order"],
                "dq_flag": {p: dq}, "approx_method": {p: "uniform"}}
        uniform_rec(p, tiny)
        trial_params = dict(cur_rec, **{p: tiny["parameters"][p]})
        acc = model_executer.eval_model(trial_params, verbose=False)
        acc = acc[0] if isinstance(acc, (tuple, list)) else acc
        return size, float(acc), (trial_adq, trial_params)

    def _block_members(p):
        """Every coded tensor sharing p's block (p itself if block-less)."""
        def base(x):
            if (x.endswith("_G") or x.endswith("_H")) and \
                    x[:-2] in model_info["parameter_type"]:
                return x[:-2]
            return x
        bid = model_info["block_identifier"].get(base(p))
        if bid is None:
            return {p}
        return {x for x in approx_data["parameters"]
                if model_info["block_identifier"].get(base(x)) == bid}

    def try_codebook_delta(p, qp_val):
        """Measure (size, acc, state) for p codebook-coded at approx_info-qp
        ``qp_val`` (DQ compensation applied exactly as codebook_approx's
        _prepare does, so the final approx() reproduces this trial)."""
        qp_off = 0
        if int(approx_info["dq_flag"][p]) == 1:
            qp_off = common.compute_qp_offset_to_dq_equivalent(
                int(approx_data["qp_density"]))
        q, qp_out = _quant_one(approx_info, approx_data, p, 0,
                               int(qp_val) - qp_off)
        cb, idx = derive_sorted_codebook_from_tensor(q)
        culm1 = approx_info["cabac_unary_length_minus1"]
        cb, idx, cb_off = get_codebook_offset(cb, idx, culm1)
        egk, _ = get_best_egk(cb, cb_off)
        trial_adq = dict(cur_adq)
        trial_adq["parameters"] = dict(cur_adq["parameters"], **{p: idx})
        trial_adq["qp"] = dict(cur_adq["qp"], **{p: qp_out})
        trial_adq["approx_method"] = dict(cur_adq["approx_method"],
                                          **{p: "codebook"})
        trial_adq["dq_flag"] = dict(cur_adq["dq_flag"], **{p: 0})
        trial_adq["codebooks"] = dict(cur_adq.get("codebooks", {}),
                                      **{p: cb})
        trial_adq["codebook_zero_offsets"] = dict(
            cur_adq.get("codebook_zero_offsets", {}), **{p: cb_off})
        trial_adq["codebooks_egk"] = dict(cur_adq.get("codebooks_egk", {}),
                                          **{p: egk})
        members = _block_members(p)
        size = cur_size \
            - _coder.encode_units_covering(enc_info, model_info, cur_adq,
                                           members) \
            + _coder.encode_units_covering(enc_info, model_info, trial_adq,
                                           members)
        step = common.get_stepsize_from_qp(int(qp_out),
                                           int(approx_data["qp_density"]))
        recon = np.float32((cb * step)[idx + cb_off])
        trial_params = dict(cur_rec, **{p: recon})
        acc = model_executer.eval_model(trial_params, verbose=False)
        acc = acc[0] if isinstance(acc, (tuple, list)) else acc
        return size, float(acc), (trial_adq, trial_params)

    for p in by_size[1:]:  # the largest tensor stays at the global QP
        if use_delta and cur_adq["approx_method"].get(p) != "uniform":
            continue  # e.g. integer-skip: qp changes are no-ops
        for qp_off in qp_offsets:
            qp_enc = int(approx_info["qp"][p]) + qp_off
            if use_delta:
                size, acc, state = try_delta(p, qp_enc)
            else:
                trial = copy.deepcopy(best_info)
                trial["qp"][p] = qp_enc
                size, acc, _q, _r = measure(trial)
            cost = (ref_acc - acc) + lamb * (size - ref_size)
            if cost < best_cost:
                best_cost = cost
                best_info["qp"][p] = qp_enc
                if use_delta:
                    cur_adq, cur_rec = state
                    cur_size = size
                if verbose:
                    print(f"\tIOQ: {p} qp -> {qp_enc} "
                          f"(cost {cost:.6f}, {size} bytes, acc {acc})")
        if not (try_codebook and use_delta) or \
                p.endswith("_G") or p.endswith("_H"):
            # DC pairs share one codebook_present_flag; a per-tensor method
            # trial on one half could produce an unencodable unit — skip
            continue
        cb_qps = {int(approx_info["qp"][p]) + off
                  for off in codebook_qp_offsets}
        cb_qps.add(int(best_info["qp"][p]))  # the accepted refined qp
        for qp_val in sorted(cb_qps):
            size, acc, state = try_codebook_delta(p, qp_val)
            cost = (ref_acc - acc) + lamb * (size - ref_size)
            if cost < best_cost:
                best_cost = cost
                best_info["qp"][p] = int(qp_val)
                best_info.setdefault("codebook_force", set()).add(p)
                cur_adq, cur_rec = state
                cur_size = size
                if verbose:
                    print(f"\tIOQ: {p} -> codebook at qp {qp_val} "
                          f"(cost {cost:.6f}, {size} bytes, acc {acc})")
    approx_info.clear()
    approx_info.update(best_info)
    return {"size": cur_size, "acc_ref": ref_acc} if use_delta else None


class ApproxInfo:
    """Per-tensor QP / dq_flag assignment. (reference: approximator:724-913)"""

    def __init__(self, approx_data, model_info, approx_method, codebook_mode,
                 qp, opt_qp, disable_dq, cabac_unary_length_minus1,
                 lambda_scale, nonweight_qp=None, qp_per_tensor=None):
        self._approx_info = {
            "approx_method": "codebook" if codebook_mode > 0 else approx_method,
            "codebook_mode": codebook_mode,
            "dq_flag": {x: 0 if disable_dq else 1
                        for x in approx_data["parameters"]},
            "lambda_scale": lambda_scale,
            "cabac_unary_length_minus1": cabac_unary_length_minus1,
            "to_approximate": W_TYPES + O_TYPES,
        }
        self._qp_other = None
        self._qp_lsa = None

        if approx_method in ("uniform", "codebook"):
            qp = int(np.int32(qp))
            qp_density = int(approx_data["qp_density"])
            self._qp_other = nonweight_qp if nonweight_qp else \
                qp - (2 << qp_density)
            self._qp_lsa = nonweight_qp if nonweight_qp else \
                qp - (2 << qp_density)
            self._approx_info["qp"] = {}
            for x in approx_data["parameters"]:
                if x not in model_info["parameter_index"] and \
                        (x.endswith("_G") or x.endswith("_H")):
                    assert model_info["parameter_type"][x[:-2]] in W_TYPES
                    self._approx_info["qp"][x] = qp
                else:
                    self._approx_info["qp"][x] = (
                        qp if model_info["parameter_type"][x] in W_TYPES
                        else self._qp_other)
            if qp_per_tensor is not None:
                assert isinstance(qp_per_tensor, dict)
                for x in approx_data["parameters"]:
                    self._approx_info["qp"][x] = qp_per_tensor.get(
                        x, self._approx_info["qp"][x])
            if opt_qp:
                self._modify_qp(approx_data, model_info)

    @property
    def qp_lsa(self):
        return self._qp_lsa

    @property
    def qp_other(self):
        return self._qp_other

    @property
    def approx_info(self):
        return self._approx_info

    def apply_qp(self, approx_data, model_info, qp, nonweight_qp=None):
        qp = int(np.int32(qp))
        qp_density = int(approx_data["qp_density"])
        self._qp_other = nonweight_qp if nonweight_qp else \
            qp - (2 << qp_density)
        self._qp_lsa = nonweight_qp if nonweight_qp else \
            qp - (2 << qp_density)
        self._approx_info["qp"] = {}
        for x in approx_data["parameters"]:
            if x not in model_info["parameter_index"] and \
                    (x.endswith("_G") or x.endswith("_H")):
                self._approx_info["qp"][x] = qp
            else:
                self._approx_info["qp"][x] = (
                    qp if model_info["parameter_type"][x] in W_TYPES
                    else self._qp_other)

    def _modify_qp(self, approx_data, model_info):
        """opt_qp: scale each weight tensor's QP by its relative size and
        (inverse) std share. (reference: approximator:832-893)"""
        param_names, param_sizes, param_std = [], [], []
        for k, v in approx_data["parameters"].items():
            base = k[:-2] if (k.endswith("_G") or k.endswith("_H")) else k
            if model_info["parameter_type"][base] not in ["weight"]:
                continue
            if k.endswith("_G"):
                continue
            if k.endswith("_H"):
                g = approx_data["parameters"][base + "_G"]
                h = approx_data["parameters"][base + "_H"]
                s = int(np.prod(g.shape[:-1]) * h.shape[-1])
                param_names.append(base + "_G")
                param_sizes.append(0)
                param_std.append(0)
                param_names.append(base + "_H")
                param_sizes.append(s)
                param_std.append(float(np.std(
                    np.concatenate((g.flatten(), h.flatten())))))
            else:
                param_names.append(k)
                param_sizes.append(v.size)
                param_std.append(float(np.std(v)))

        if not param_names:
            return
        rel_sizes = np.array(param_sizes) / max(1, sum(param_sizes))
        rel_std = np.array(param_std) / max(param_std)
        shares = rel_sizes + 0.1 * (1 - rel_std)
        w = dict(zip(param_names, shares))
        for name in param_names:
            qp = self._approx_info["qp"][name]
            if w[name] > 0.5:
                w[name] = 0.15
            self._approx_info["qp"][name] = np.int32(round(qp * (1 - w[name])))
            if name.endswith("_H"):
                self._approx_info["qp"][name[:-2] + "_G"] = \
                    self._approx_info["qp"][name]

    def set_ls_qps(self, model_info, approx_data, dq_flag):
        for block_access in NNRModelAccess(model_info).blocks_and_params():
            if block_access.block_id is None:
                continue
            cpt = approx_data["compressed_parameter_types"][
                block_access.block_id]
            if cpt & hls.BlockParameterTypes.NNR_CPT_LS:
                self._approx_info["qp"][block_access.ls] = self._qp_lsa
                self._approx_info["dq_flag"][block_access.ls] = dq_flag
