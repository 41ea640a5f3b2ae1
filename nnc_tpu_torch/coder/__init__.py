"""NNR coder: serialize a quantized model into an NNR bitstream and back.

Unit sequence: NNR_STR, NNR_MPS, [NNR_TPL], then one NNR_NDU per block (a
layer's weight + bias/LSA/BN companions) or free-standing parameter.
(reference flow: nnc_core/coder/__init__.py:100-148 encode, 620-673 decode;
header compilation semantics: nnc_core/coder/syntax_compiler.py.)

Differences from the reference (documented, self-consistent):
  * The encoder obtains CABAC entry points directly from the native codec
    instead of re-decoding each NDU (optional `verify` mode re-decodes).
  * Each coded tensor's arithmetic-engine segment is byte-aligned, so NDUs
    can be decoded tensor-parallel on host CPU workers.
  * A block whose companion cannot share the block header (codebook-coded,
    integer-skip, or dq-inconsistent) keeps its groupable members in the
    block NDU (cpt bits masked) and emits only the offenders as
    single-tensor NDUs — the reference splits the whole block
    (coder/__init__.py:11-38); partial split preserves DC shape metadata.
"""
from __future__ import annotations

import numpy as np

from .. import hls
from ..hls import syntax
from ..core import common
from ..core.model import NNRModelAccess, NNRParamAccess
from . import cabac

_PT = hls.CompressedDataUnitPayloadType
_CPT = hls.BlockParameterTypes


def _partition_block(block_access, approx_data):
    """Split a block into (kept_cpt, split_names): members that cannot ride
    the shared block header get their own single-tensor NDU.

    The block NDU header carries exactly one dq_flag and codebook fields
    only for the weight (plus its DC pair), so a companion that is
    codebook-coded, integer-skip, or dq-inconsistent with the rest is
    un-groupable (reference full-split rules: coder/__init__.py:11-38; this
    encoder splits only the offending members and masks their cpt bits —
    docs/BITSTREAM.md "partial block split").

    Returns ``kept_cpt=None`` when the weight itself cannot anchor a block
    NDU (integer-skip weight), in which case every member splits."""
    cpt = approx_data["compressed_parameter_types"][block_access.block_id]
    am = approx_data["approx_method"]
    members = list(block_access.param_generator(
        approx_data["compressed_parameter_types"]))
    w_names = {p for t, p, _ in members if t.endswith("weight")}
    if any(am.get(p) == "skip" for p in w_names):
        return None, [p for _t, p, _d in members]
    # the unit's single dq_flag: the weight's if it codes uniform,
    # else the first uniform companion's
    blk_dq = None
    for _t, p, _d in members:
        if p in w_names and am.get(p) == "uniform":
            blk_dq = int(approx_data["dq_flag"].get(p, 0))
            break
    split = set()
    for t, p, _d in members:
        if p in w_names:
            continue
        if am.get(p) in ("codebook", "skip"):
            split.add(p)
            continue
        d = int(approx_data["dq_flag"].get(p, 0))
        if blk_dq is None:
            blk_dq = d
        elif d != blk_dq:
            split.add(p)
    # the four BN tensors are signaled by ONE cpt bit: atomic
    bn_names = {p for t, p, _d in members if t.startswith("bn.")}
    if split & bn_names:
        split |= bn_names
    kept_cpt = int(cpt)
    for t, p, _d in members:
        if p not in split:
            continue
        if t == "weight.ls":
            kept_cpt &= ~_CPT.NNR_CPT_LS
        elif t == "bias":
            kept_cpt &= ~_CPT.NNR_CPT_BI
        elif t.startswith("bn."):
            kept_cpt &= ~_CPT.NNR_CPT_BN
    return kept_cpt, [p for _t, p, _d in members if p in split]


def is_block_possible(block_access, approx_data):
    """A block NDU covering ALL members is possible iff nothing needs to
    split. (reference: coder/__init__.py:11-38)"""
    cpt = approx_data["compressed_parameter_types"].get(block_access.block_id)
    if cpt is None:
        return False
    for _t, param, _d in block_access.param_generator(
            approx_data["compressed_parameter_types"]):
        if param not in approx_data["parameters"]:
            return False
    am = approx_data["approx_method"]
    if block_access.dc_g in am and \
            am[block_access.dc_g] != am.get(block_access.dc_h):
        return False
    kept_cpt, split = _partition_block(block_access, approx_data)
    return kept_cpt == cpt and not split


# ---------------------------------------------------------------------------
# Header compilation (field semantics per reference syntax_compiler.py)
# ---------------------------------------------------------------------------
def compile_start_unit(profile=0):
    return {
        "nnr_unit_type": hls.NnrUnitType.NNR_STR,
        "partial_data_counter_present_flag": 0,
        "partial_data_counter": 0,
        "independently_decodable_flag": 1,
        "general_profile_idc": profile,
    }


def compile_mps(approx_data, topology_present):
    mps = {
        "nnr_unit_type": hls.NnrUnitType.NNR_MPS,
        "partial_data_counter_present_flag": 0,
        "partial_data_counter": 0,
        "independently_decodable_flag": 1,
        "topology_carriage_flag": 1 if topology_present else 0,
        "mps_sparsification_flag": 0,
        "mps_pruning_flag": 0,
        "mps_unification_flag": 0,
        "mps_decomposition_performance_map_flag": 0,
        "mps_topology_indexed_reference_flag": 0,
    }
    if "qp_density" in approx_data:
        mps["mps_quantization_method_flags"] = \
            hls.QuantizationMethodFlags.NNR_QSU
        mps["mps_qp_density"] = int(approx_data["qp_density"])
        mps["mps_quantization_parameter"] = 0
    else:
        mps["mps_quantization_method_flags"] = 0
    return mps


def compile_tpl(model_info):
    return {
        "nnr_unit_type": hls.NnrUnitType.NNR_TPL,
        "partial_data_counter_present_flag": 0,
        "partial_data_counter": 0,
        "independently_decodable_flag": 1,
        "topology_data": "",
        "topology_storage_format": int(model_info["topology_storage_format"]),
        "topology_compression_format":
            int(model_info["topology_compression_format"]),
    }


def compile_ndu_oob(tensor_dims=None, cabac_unary_length_minus1=None,
                    compressed_parameter_types=None,
                    decomposition_parameter_dict=None):
    """Out-of-band NDU parameters (reference: syntax_compiler.py:44-63).

    Two strengths, chosen by how much is supplied:

    * **Sub-flag OOB** (``input_parameters_present_flag = 1``): tensor
      dimensions and/or the CABAC unary length are omitted from the
      serialized headers; the decoder is handed the same values via
      ``decode(..., model_info=...)``. Works on any model — dimensions are
      recovered per tensor by topology name.
    * **Full OOB** (``input_parameters_present_flag = 0``): additionally
      omits ``compressed_parameter_types`` and the DC fields. Because one
      OOB dict describes every NDU of the stream, this requires the values
      to be stream-global: ``encode`` raises if any unit's actual cpt/DC
      fields differ from the supplied ones. Decode takes the same dict via
      ``decode(..., ndu_oob=...)``. Selected when ``tensor_dims``,
      ``cabac_unary_length_minus1`` and ``compressed_parameter_types`` are
      all given (plus ``decomposition_parameter_dict`` with keys
      ``decomposition_rank``/``g_number_of_rows`` whenever cpt includes
      NNR_CPT_DC). The reference additionally *requires* a DC stream for
      ipp=0 (its ``all([...])`` gate); that restriction is dropped here —
      cpt=0 single-tensor streams are the common full-OOB case.

    ``tensor_dims`` may be ``True`` ("omitted; recover per tensor from
    external ``parameter_dimensions``") or an explicit dimension list
    (single-tensor streams; validated at encode)."""
    oob = {
        "input_parameters_present_flag": 1,
        "tensor_dimensions_flag": 0 if tensor_dims is not None else 1,
        "cabac_unary_length_flag":
            0 if cabac_unary_length_minus1 is not None else 1,
    }
    cpt = compressed_parameter_types
    full = (tensor_dims is not None
            and cabac_unary_length_minus1 is not None
            and cpt is not None
            and (not (int(cpt) & _CPT.NNR_CPT_DC)
                 or decomposition_parameter_dict is not None))
    if full:
        oob["input_parameters_present_flag"] = 0
        oob["compressed_parameter_types"] = int(cpt)
        oob["cabac_unary_length_minus1"] = int(cabac_unary_length_minus1)
        if tensor_dims is not True:
            oob["tensor_dimensions"] = [int(d) for d in tensor_dims]
        if int(cpt) & _CPT.NNR_CPT_DC:
            oob["decomposition_rank"] = int(
                decomposition_parameter_dict["decomposition_rank"])
            oob["g_number_of_rows"] = int(
                decomposition_parameter_dict["g_number_of_rows"])
    return oob


def _coded_tensors(block_or_param, approx_data):
    """Payload-ordered [(par_type, name, dims)] of the unit's coded tensors."""
    return list(block_or_param.param_generator(
        approx_data["compressed_parameter_types"]))


def compile_ndu(param, approx_data, enc_info, model_info, is_block, cpt,
                block_access, tensor_dims, ndu_oob=None):
    h = {
        "nnr_unit_type": hls.NnrUnitType.NNR_NDU,
        "partial_data_counter_present_flag": 0,
        "partial_data_counter": 0,
        "independently_decodable_flag": 1,
        "input_parameters_present_flag": 1,
        "tensor_dimensions_flag": 1,
        "cabac_unary_length_flag": 1,
        "count_tensor_dimensions": len(tensor_dims),
        "tensor_dimensions": list(tensor_dims),
        "cabac_unary_length_minus1": enc_info["cabac_unary_length_minus1"],
        "mps_topology_indexed_reference_flag": 0,
        "nnr_decompressed_data_format_present_flag": 0,
        "nnr_decompressed_data_format": hls.DecompressedDataFormat.TENSOR_FLOAT32,
    }

    method = approx_data["approx_method"].get(param)
    if is_block:
        h["nnr_compressed_data_unit_payload_type"] = _PT.NNR_PT_BLOCK
        h["compressed_parameter_types"] = int(cpt)
        if cpt & _CPT.NNR_CPT_DC:
            h["decomposition_rank"] = \
                approx_data["decomposition_rank"][block_access.block_id]
            h["g_number_of_rows"] = \
                approx_data["g_number_of_rows"][block_access.block_id]
            param = block_access.dc_g
        else:
            param = block_access.w
        method = approx_data["approx_method"][param]
    elif method in ("uniform", "codebook"):
        h["nnr_compressed_data_unit_payload_type"] = _PT.NNR_PT_FLOAT
        h["compressed_parameter_types"] = 0
    elif method == "skip":
        h["nnr_compressed_data_unit_payload_type"] = _PT.NNR_PT_INT
        h["compressed_parameter_types"] = 0
    else:
        h["nnr_compressed_data_unit_payload_type"] = _PT.NNR_PT_RAW_FLOAT
        h["compressed_parameter_types"] = 0
        h["raw_float32_parameter"] = approx_data["parameters"][param]

    pt = h["nnr_compressed_data_unit_payload_type"]
    if pt in (_PT.NNR_PT_BLOCK, _PT.NNR_PT_FLOAT, _PT.NNR_PT_INT):
        # The header's dq flag describes the uniform-coded tensors of the
        # unit; codebook-indexed tensors always code with dq=0. A block's
        # members are dq-consistent by construction (_partition_block
        # splits out mismatches), so any uniform member's flag works.
        if is_block:
            h["dq_flag"] = 0
            for _t, p, _d in _coded_tensors(block_access, approx_data):
                if approx_data["approx_method"].get(p) == "uniform":
                    h["dq_flag"] = int(approx_data["dq_flag"][p])
                    break
        elif method == "codebook":
            h["dq_flag"] = 0
        else:
            h["dq_flag"] = int(approx_data["dq_flag"][param])

    h["nnr_multiple_topology_elements_present_flag"] = \
        1 if pt == _PT.NNR_PT_BLOCK else 0
    if pt == _PT.NNR_PT_BLOCK:
        ids = list(block_access.topology_elem_generator(
            approx_data["compressed_parameter_types"]))
        h["count_topology_elements_minus2"] = len(ids) - 2
        h["topology_elem_id_list"] = ids
    else:
        h["topology_elem_id"] = param

    if method == "codebook":
        h["codebook_present_flag"] = 1
        h["codebook_egk__"] = approx_data["codebooks_egk"][param]
        h["codebook_size__"] = len(approx_data["codebooks"][param])
        h["CbZeroOffset__"] = approx_data["codebook_zero_offsets"][param]
        h["codebook__"] = approx_data["codebooks"][param]
        if is_block and (cpt & _CPT.NNR_CPT_DC):
            ph = block_access.dc_h
            assert approx_data["approx_method"][ph] == "codebook"
            h["codebook_egk__dc"] = approx_data["codebooks_egk"][ph]
            h["codebook_size__dc"] = len(approx_data["codebooks"][ph])
            h["CbZeroOffset__dc"] = approx_data["codebook_zero_offsets"][ph]
            h["codebook__dc"] = approx_data["codebooks"][ph]
    else:
        h["codebook_present_flag"] = 0

    if len(tensor_dims) > 1:
        h["scan_order"] = int(approx_data["scan_order"].get(param, 0))
    if ndu_oob:
        # fields carried out-of-band keep their values in h (the writer
        # needs dims for the scan/EP sections) but are not serialized
        if ndu_oob.get("input_parameters_present_flag", 1) == 0:
            # full OOB: one dict describes EVERY unit, so each unit's
            # actual values must match it — otherwise the stream would
            # silently decode wrong
            def _require(field, actual):
                want = ndu_oob[field]
                if int(actual) != int(want):
                    raise ValueError(
                        f"full out-of-band encoding requires stream-global "
                        f"{field}, but an NDU has {actual} != oob {want} "
                        f"(unit: {h.get('topology_elem_id', h.get('topology_elem_id_list'))})")
            _require("compressed_parameter_types",
                     h.get("compressed_parameter_types", 0))
            _require("cabac_unary_length_minus1", h["cabac_unary_length_minus1"])
            if int(ndu_oob["compressed_parameter_types"]) & _CPT.NNR_CPT_DC:
                _require("decomposition_rank", h["decomposition_rank"])
                _require("g_number_of_rows", h["g_number_of_rows"])
            if "tensor_dimensions" in ndu_oob and \
                    [int(d) for d in h["tensor_dimensions"]] != \
                    list(ndu_oob["tensor_dimensions"]):
                raise ValueError(
                    f"full out-of-band encoding with explicit tensor_dims "
                    f"requires every NDU to share them, but "
                    f"{list(h['tensor_dimensions'])} != "
                    f"{list(ndu_oob['tensor_dimensions'])}")
            h["input_parameters_present_flag"] = 0
        else:
            for k in ("input_parameters_present_flag",
                      "tensor_dimensions_flag", "cabac_unary_length_flag"):
                if k in ndu_oob:
                    h[k] = ndu_oob[k]
    return h


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------
def _encode_ndu_payload(param_names, approx_data, enc_info, mps_qp):
    """CABAC-encode the named tensors (payload order) into one NDU;
    returns (payload bytes, [eps] for >=2-D tensors)."""
    culm1 = enc_info["cabac_unary_length_minus1"]
    param_opt = enc_info.get("param_opt_flag", 0)
    qp_density = int(approx_data["qp_density"])
    enc = cabac.Encoder()
    ep_lists = []
    for param in param_names:
        values = approx_data["parameters"][param]
        method = approx_data["approx_method"][param]
        scan = int(approx_data["scan_order"].get(param, 0))
        dq = 0 if method in ("codebook", "skip") else \
            int(approx_data["dq_flag"][param])
        enc.initCtxModels(culm1, param_opt)
        if method in ("uniform", "codebook"):
            qp_delta = int(approx_data["qp"][param]) - mps_qp
            enc.iae_v(6 + qp_density, qp_delta)
        enc.encodeLayer(values, dq, scan)
        if values.ndim > 1 and scan > 0:
            ep_lists.append(enc.getEntryPoints())
        enc.terminate_segment()
    return enc.finish().tobytes(), ep_lists


def _compile_units(enc_info, model_info, approx_data, ndu_oob=None):
    """Walk the model's blocks and compile the NDU partition: returns a
    list of (header, [coded tensor names] or None) in bitstream order."""
    model_access = NNRModelAccess(model_info)
    units = []

    def single_unit(param, dims=None):
        if dims is None:
            dims = approx_data["parameters"][param].shape
        h = compile_ndu(param, approx_data, enc_info, model_info, False,
                        0, None, dims, ndu_oob)
        raw = h["nnr_compressed_data_unit_payload_type"] == \
            _PT.NNR_PT_RAW_FLOAT
        units.append((h, None if raw else [param]))

    for block_or_param in model_access.blocks_and_params():
        if block_or_param.block_id is None:
            single_unit(block_or_param.param)
            continue
        cpt = approx_data["compressed_parameter_types"][
            block_or_param.block_id]
        kept_cpt, split = _partition_block(block_or_param, approx_data)
        if kept_cpt is not None:
            ad_unit = approx_data
            if kept_cpt != cpt:
                # mask the split members' cpt bits for this unit only
                masked = dict(approx_data["compressed_parameter_types"])
                masked[block_or_param.block_id] = kept_cpt
                ad_unit = dict(approx_data,
                               compressed_parameter_types=masked)
            kept = [p for _t, p, _d in
                    _coded_tensors(block_or_param, ad_unit)]
            if len(kept) >= 2:
                dims = model_info["parameter_dimensions"][block_or_param.w]
                h = compile_ndu(None, ad_unit, enc_info, model_info, True,
                                kept_cpt, block_or_param, dims, ndu_oob)
                units.append((h, kept))
            else:
                # a PT_BLOCK unit needs >=2 topology elements; a block
                # stripped down to its bare weight codes as a single NDU
                split = kept + list(split)
        for param in split:
            single_unit(param)
    return units


def encode_param_unit(enc_info, model_info, approx_data, param):
    """Encode ONLY the NDU whose payload contains ``param``; returns its
    serialized byte length (header + payload). Used by the IOQ refinement
    loop to delta-measure a single-tensor QP trial without re-encoding the
    whole model (the reference re-encodes everything per trial,
    reference approximator:387-600 — ~8·N² tensor encodes)."""
    units = _compile_units(enc_info, model_info, approx_data)
    for h, names in units:
        if names is not None and param in names:
            # compile_mps always writes mps_quantization_parameter = 0
            payload, ep_lists = _encode_ndu_payload(names, approx_data,
                                                    enc_info, 0)
            if ep_lists:
                h["cabac_entry_point_lists"] = ep_lists
            return len(syntax.encode_unit(h, payload))
    raise KeyError(f"{param} is not coded in any NDU payload")


def encode_units_covering(enc_info, model_info, approx_data, params):
    """Serialized byte total of every NDU whose payload intersects
    ``params`` (an iterable of tensor names).

    Method trials (uniform vs codebook) can re-partition a block into a
    partially-split unit set, changing the framing of OTHER members of the
    same block — so the IOQ codebook arbitration deltas the whole block's
    covering units, not a single tensor's NDU (cf. encode_param_unit,
    which is sound for qp-only trials because those never re-partition)."""
    wanted = set(params)
    units = _compile_units(enc_info, model_info, approx_data)
    total = 0
    covered = set()
    for h, names in units:
        if not names or not (set(names) & wanted):
            continue
        payload, ep_lists = _encode_ndu_payload(names, approx_data,
                                                enc_info, 0)
        if ep_lists:
            h["cabac_entry_point_lists"] = ep_lists
        total += len(syntax.encode_unit(h, payload))
        covered |= set(names) & wanted
    missing = wanted - covered
    if missing:
        raise KeyError(f"{sorted(missing)} not coded in any NDU payload")
    return total


def encode(enc_info, model_info, approx_data, ndu_oob=None,
           num_workers: int = 0):
    """Serialize model_info + approx_data into a full NNR bitstream.
    ``ndu_oob`` (from :func:`compile_ndu_oob`) omits the flagged NDU header
    fields; decoding then requires external model information.
    (reference: coder/__init__.py:100-148)

    ``num_workers > 1`` CABAC-encodes NDU payloads in a thread pool: each
    NDU is an independent stream segment and the native encoder releases
    the GIL, mirroring the parallel decode path."""
    bitstream = bytearray()
    topology_present = model_info["topology_storage_format"] is not None
    mps = compile_mps(approx_data, topology_present)
    mps_qp = mps.get("mps_quantization_parameter", 0)

    bitstream += syntax.encode_unit(compile_start_unit(0))
    bitstream += syntax.encode_unit(mps)
    if topology_present:
        bitstream += syntax.encode_unit(compile_tpl(model_info))

    units = _compile_units(enc_info, model_info, approx_data, ndu_oob)

    def payload_of(names):
        if names is None:
            return None
        return _encode_ndu_payload(names, approx_data, enc_info, mps_qp)

    if num_workers > 1 and len(units) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            payloads = list(pool.map(payload_of, [u[1] for u in units]))
    else:
        payloads = [payload_of(u[1]) for u in units]

    for (h, _bp), result in zip(units, payloads):
        if result is None:
            bitstream += syntax.encode_unit(h)
            continue
        payload, ep_lists = result
        if ep_lists:
            h["cabac_entry_point_lists"] = ep_lists
        bitstream += syntax.encode_unit(h, payload)
    return bitstream


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _block_names_from_topology(ids, cpt):
    """Invert topology_elem_generator ordering -> named roles."""
    it = iter(ids)
    names = {}
    if cpt & _CPT.NNR_CPT_DC:
        names["dc_g"] = next(it)
        names["dc_h"] = next(it)
        names["w"] = names["dc_g"][:-2]
    else:
        names["w"] = next(it)
    if cpt & _CPT.NNR_CPT_LS:
        names["ls"] = next(it)
    if cpt & _CPT.NNR_CPT_BN:
        names["bn_beta"] = next(it)
        names["bn_gamma"] = next(it)
        names["bn_mean"] = next(it)
        names["bn_var"] = next(it)
    if cpt & _CPT.NNR_CPT_BI:
        names["bi"] = next(it)
    return names


def _decode_ndu(h, payload, approx_data, model_info, next_index):
    """Decode one NDU's tensors into approx_data/model_info. Returns the
    number of parameter indices consumed."""
    pt = h["nnr_compressed_data_unit_payload_type"]
    qp_density = int(approx_data["qp_density"])
    mps_qp = approx_data.get("_mps_qp", 0)
    culm1 = int(h.get("cabac_unary_length_minus1", 10))
    dims = tuple(h.get("tensor_dimensions", ()))
    scan = int(h.get("scan_order", 0))
    used = 0

    def register(name, ptype, shape, bid=None):
        nonlocal used
        model_info["parameter_type"][name] = ptype
        model_info["parameter_dimensions"][name] = tuple(shape)
        model_info["parameter_index"][name] = next_index + used
        if bid is not None:
            model_info["block_identifier"][name] = bid
        used += 1

    if pt == _PT.NNR_PT_RAW_FLOAT:
        name = h["topology_elem_id"]
        approx_data["parameters"][name] = h["raw_float32_parameter"]
        register(name, "unspecified" if len(dims) <= 1 else "weight", dims)
        return used

    dec = cabac.Decoder()
    dec.setStream(payload)

    # (name, par_type, dims, method, codebook_suffix)
    plan = []
    if pt == _PT.NNR_PT_BLOCK:
        cpt = int(h["compressed_parameter_types"])
        names = _block_names_from_topology(h["topology_elem_id_list"], cpt)
        bid = names["w"]
        w_method = "codebook" if h.get("codebook_present_flag") else "uniform"
        n0 = dims[0]
        # payload order must match param_generator: ls, bi, bn*, w/G/H
        if cpt & _CPT.NNR_CPT_LS:
            plan.append((names["ls"], "weight.ls", (n0,), "uniform", None))
        if cpt & _CPT.NNR_CPT_BI:
            plan.append((names["bi"], "bias", (n0,), "uniform", None))
        if cpt & _CPT.NNR_CPT_BN:
            for role, t in (("bn_beta", "bn.beta"), ("bn_gamma", "bn.gamma"),
                            ("bn_mean", "bn.mean"), ("bn_var", "bn.var")):
                plan.append((names[role], t, (n0,), "uniform", None))
        if cpt & _CPT.NNR_CPT_DC:
            rank = int(h["decomposition_rank"])
            g_rows = int(h["g_number_of_rows"])
            g_dims = (g_rows, rank)
            h_dims = (rank, int(np.prod(dims)) // g_rows)
            plan.append((names["dc_g"], "weight", g_dims, w_method, ""))
            plan.append((names["dc_h"], "weight", h_dims, w_method, "dc"))
        else:
            plan.append((names["w"], "weight", dims, w_method, ""))
        approx_data["compressed_parameter_types"][bid] = cpt
        if cpt & _CPT.NNR_CPT_DC:
            approx_data["decomposition_rank"][bid] = int(
                h["decomposition_rank"])
            approx_data["g_number_of_rows"][bid] = int(h["g_number_of_rows"])
        # register indices in canonical (weight, bias, ls, bn, G/H) order so a
        # reconstructed state dict keeps framework-native ordering
        reg_order = []
        if cpt & _CPT.NNR_CPT_DC:
            # phantom anchor for the recomposed weight (block access resolves
            # the block's "weight" through it; recompose_params materializes
            # it); the factors themselves must not claim the weight slot.
            reg_order += [(names["w"], "weight", dims),
                          (names["dc_g"], "unspecified", g_dims),
                          (names["dc_h"], "unspecified", h_dims)]
        else:
            reg_order += [(names["w"], "weight", dims)]
        if cpt & _CPT.NNR_CPT_BI:
            reg_order += [(names["bi"], "bias", (n0,))]
        if cpt & _CPT.NNR_CPT_LS:
            reg_order += [(names["ls"], "weight.ls", (n0,))]
        if cpt & _CPT.NNR_CPT_BN:
            reg_order += [(names[r], t, (n0,)) for r, t in
                          (("bn_beta", "bn.beta"), ("bn_gamma", "bn.gamma"),
                           ("bn_mean", "bn.mean"), ("bn_var", "bn.var"))]
        for name, t, s in reg_order:
            register(name, t, s, bid)
    else:
        name = h["topology_elem_id"]
        method = ("skip" if pt == _PT.NNR_PT_INT else
                  ("codebook" if h.get("codebook_present_flag") else
                   "uniform"))
        ptype = "weight" if len(dims) > 1 else "unspecified"
        plan.append((name, ptype, dims, method, ""))
        register(name, ptype, dims)

    hdr_dq = int(h.get("dq_flag", 0))
    # entry-point lists arrive in payload order of the >=2-D tensors; feed
    # each to the decoder so chunked layers decode via entry-point seeking
    # (threaded block-rows; reference: setEntryPoints coder/__init__.py:439)
    ep_lists = list(h.get("cabac_entry_point_lists", []))
    for name, _ptype, shape, method, cb_suffix in plan:
        dq = 0 if method in ("codebook", "skip") else hdr_dq
        dec.initCtxModels(culm1)
        if method in ("uniform", "codebook"):
            qp_delta = dec.iae_v(6 + qp_density)
            approx_data["qp"][name] = np.int32(mps_qp + qp_delta)
        out = np.zeros(shape, dtype=np.int32)
        tensor_scan = scan if len(shape) > 1 else 0
        if tensor_scan > 0 and ep_lists:
            eps = ep_lists.pop(0)
            dec.setEntryPoints(np.asarray(eps, dtype=np.uint64))
        dec.decodeLayer(out, dq, tensor_scan)
        dec.terminate_segment()
        approx_data["parameters"][name] = out
        approx_data["approx_method"][name] = method
        approx_data["dq_flag"][name] = dq
        if len(shape) > 1:
            approx_data["scan_order"][name] = np.int32(tensor_scan)
        if method == "codebook":
            approx_data["codebooks"][name] = np.asarray(
                h["codebook__" + cb_suffix], dtype=np.int32)
            approx_data["codebooks_egk"][name] = int(
                h["codebook_egk__" + cb_suffix])
            approx_data["codebook_zero_offsets"][name] = int(
                h["CbZeroOffset__" + cb_suffix])
    consumed = dec.finish()
    assert consumed == len(payload), (
        f"NDU payload size mismatch: consumed {consumed} of {len(payload)}")
    return used


def _surface_performance_maps(model_info, h, kind):
    """Expose decoded MPS/LPS performance maps + flags on model_info
    (reference: nnc/compression.py:590-607 model_information surface)."""
    flags = model_info.setdefault("performance_map_flags", {})
    maps = model_info.setdefault("performance_maps", {"mps": {}, "lps": {}})
    for name in ("sparsification_flag", "pruning_flag", "unification_flag"):
        key = f"{kind}_{name}"
        if key in h:
            flags[key] = h[key]
    if kind == "mps":
        flags["mps_decomposition_performance_map_flag"] = \
            h.get("mps_decomposition_performance_map_flag", 0)
    for name in ("sparsification_performance_map", "pruning_performance_map",
                 "unification_performance_map",
                 "decomposition_performance_map"):
        key = f"{kind}_{name}"
        if key in h:
            maps[kind][name] = h[key]


def decode(bitstream, model_info=None, num_workers: int = 0, ndu_oob=None):
    """Parse a full NNR bitstream. Returns (model_info, approx_data).
    (reference: coder/__init__.py:620-673)

    ``ndu_oob``: for streams encoded with a full out-of-band dict
    (``input_parameters_present_flag = 0``), pass the same
    :func:`compile_ndu_oob` dict used at encode.

    ``num_workers > 1`` decodes NDU payloads in a thread pool: each NDU is an
    independent byte-delimited unit and the native CABAC decoder releases the
    GIL, so decode scales across host cores (the reference is strictly
    serial)."""
    oob = None
    if model_info and model_info.get("parameter_dimensions"):
        # external model information doubles as the out-of-band parameter
        # source for streams encoded with compile_ndu_oob
        oob = model_info
    if ndu_oob is not None:
        # full-OOB streams (input_parameters_present_flag = 0): the caller
        # hands back the same compile_ndu_oob dict used at encode; its
        # stream-global values overlay the per-tensor dimension source
        oob = {**(oob or {}), **ndu_oob}
    if model_info is None:
        model_info = {}
    model_info.setdefault("parameter_type", {})
    model_info.setdefault("parameter_dimensions", {})
    model_info.setdefault("parameter_index", {})
    model_info.setdefault("block_identifier", {})
    model_info.setdefault("topology_storage_format", None)
    model_info.setdefault("topology_compression_format", None)

    approx_data = {
        "approx_method": {},
        "qp": {},
        "dq_flag": {},
        "decomposition_rank": {},
        "g_number_of_rows": {},
        "scan_order": {},
        "parameters": {},
        "compressed_parameter_types": {},
        "codebooks": {},
        "codebooks_egk": {},
        "codebook_zero_offsets": {},
    }

    data = bytes(bitstream)
    r = hls.BitReader(data)
    first = True
    ndus = []  # (header, payload) deferred for (possibly parallel) decode
    while r.byte_pos < len(data):
        if r.byte_pos + 4 > len(data):
            raise ValueError(
                f"truncated bitstream: {len(data) - r.byte_pos} trailing "
                f"bytes cannot hold a unit size field")
        h, payload_start, unit_end = syntax.decode_unit_header(r, oob=oob)
        if unit_end > len(data):
            raise ValueError(
                f"truncated bitstream: unit claims {unit_end - r.byte_pos} "
                f"more bytes but only {len(data) - r.byte_pos} remain")
        utype = h["nnr_unit_type"]
        if first:
            assert utype == hls.NnrUnitType.NNR_STR, \
                "bitstream must start with NNR_STR"
            version = h.get("nnc_tpu_format_version", 0)
            if version > hls.FORMAT_VERSION:
                raise ValueError(
                    f"bitstream format version {version} is newer than this "
                    f"decoder supports ({hls.FORMAT_VERSION}); upgrade "
                    f"nnc_tpu to decode it")
            first = False
        if utype is None:
            pass  # unknown unit type: skipped by size (parse tolerance)
        elif utype == hls.NnrUnitType.NNR_MPS:
            if h["mps_quantization_method_flags"] & \
                    hls.QuantizationMethodFlags.NNR_QSU:
                approx_data["qp_density"] = np.int32(h["mps_qp_density"])
                approx_data["_mps_qp"] = int(
                    h.get("mps_quantization_parameter", 0))
            _surface_performance_maps(model_info, h, "mps")
        elif utype == hls.NnrUnitType.NNR_LPS:
            # layer parameter sets carry per-layer performance maps; their
            # quantization overrides apply to subsequent NDUs (none are
            # produced by this encoder — decoded for parity/tolerance)
            _surface_performance_maps(model_info, h, "lps")
        elif utype == hls.NnrUnitType.NNR_TPL:
            model_info["topology_storage_format"] = \
                hls.TopologyStorageFormat(h["topology_storage_format"])
            model_info["topology_compression_format"] = \
                hls.TopologyCompressionFormat(h["topology_compression_format"])
        elif utype == hls.NnrUnitType.NNR_NDU:
            ndus.append((h, data[payload_start:unit_end]))
        r = hls.BitReader(data, unit_end)

    if num_workers > 1 and len(ndus) > 1:
        from concurrent.futures import ThreadPoolExecutor

        def decode_one(h_payload):
            h, payload = h_payload
            # private approx_data/model_info shards, merged in unit order
            ad = {k: ({} if isinstance(v, dict) else v)
                  for k, v in approx_data.items()}
            mi = {"parameter_type": {}, "parameter_dimensions": {},
                  "parameter_index": {}, "block_identifier": {}}
            used = _decode_ndu(h, payload, ad, mi, 0)
            return ad, mi, used

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(decode_one, ndus))
        next_index = 0
        for ad, mi, used in results:
            for key in ("approx_method", "qp", "dq_flag", "scan_order",
                        "parameters", "compressed_parameter_types",
                        "decomposition_rank", "g_number_of_rows",
                        "codebooks", "codebooks_egk",
                        "codebook_zero_offsets"):
                approx_data[key].update(ad[key])
            for key in ("parameter_type", "parameter_dimensions",
                        "block_identifier"):
                model_info[key].update(mi[key])
            for name, idx in mi["parameter_index"].items():
                model_info["parameter_index"][name] = next_index + idx
            next_index += used
    else:
        next_index = 0
        for h, payload in ndus:
            next_index += _decode_ndu(h, payload, approx_data, model_info,
                                      next_index)

    approx_data.pop("_mps_qp", None)
    return model_info, approx_data
