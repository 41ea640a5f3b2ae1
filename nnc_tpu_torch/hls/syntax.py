"""NNR unit syntax: serialize/deserialize unit headers + payload framing.

Each NNR unit is laid out as::

    u(32) nnr_unit_size          # bytes following this field
    nnr_unit_header              # type + flags, byte-aligned
    nnr_unit_payload             # unit-specific header fields + byte payload

Field names match the reference syntax compiler
(reference: nnc_core/coder/syntax_compiler.py:5-199 and the hls.Coder syntax
tree at nnc_core/hls/__init__.py:260-704). The bit layout itself is this
implementation's own (self-consistent encode/decode; see README for format
notes).
"""
from __future__ import annotations

import numpy as np

from . import (BitReader, BitWriter, BlockParameterTypes,
               CompressedDataUnitPayloadType, NnrUnitType)

_PT = CompressedDataUnitPayloadType


# ---------------------------------------------------------------------------
# Shared unit header
# ---------------------------------------------------------------------------
def _write_unit_header(w: BitWriter, h: dict) -> None:
    w.u(8, int(h["nnr_unit_type"]))
    w.u(1, h.get("partial_data_counter_present_flag", 0))
    if h.get("partial_data_counter_present_flag", 0):
        w.u(15, h.get("partial_data_counter", 0))
    w.u(1, h.get("independently_decodable_flag", 1))
    w.byte_alignment()


# ---------------------------------------------------------------------------
# Unit payloads
# ---------------------------------------------------------------------------
def _write_str(w: BitWriter, h: dict) -> None:
    from . import FORMAT_VERSION
    w.u(8, h.get("general_profile_idc", 0))
    # format-version field (this implementation's own layout contract; not
    # in the reference STR payload): decoders reject streams written by a
    # newer, incompatible layout instead of misparsing them
    w.u(8, h.get("nnc_tpu_format_version", FORMAT_VERSION))


def _read_str(r: BitReader, h: dict) -> None:
    h["general_profile_idc"] = r.u(8)
    h["nnc_tpu_format_version"] = r.u(8)


# ---------------------------------------------------------------------------
# Performance maps (reference: nnc_core/hls/__init__.py:533-620). Each map is
# a dict of parallel lists; the count field stores len+1 and the loops run
# over len entries, mirroring the reference's count/count-1 convention.
# ---------------------------------------------------------------------------
def _write_spm(w: BitWriter, m: dict) -> None:
    n = len(m.get("sparsification_threshold", ()))
    w.u(8, n + 1)
    for i in range(n):
        w.flt_bits(m["sparsification_threshold"][i])
        w.flt_bits(m["non_zero_ratio"][i])
        w.flt_bits(m["spm_nn_accuracy"][i])
        cls = m["spm_nn_class_accuracy"][i]
        w.u(8, len(cls))
        w.ue(7, int(m["spm_class_bitmask"][i]))
        for a in cls:
            w.flt_bits(a)


def _read_spm(r: BitReader) -> dict:
    n = r.u(8) - 1
    m = {"sparsification_threshold": [], "non_zero_ratio": [],
         "spm_nn_accuracy": [], "spm_class_bitmask": [],
         "spm_nn_class_accuracy": []}
    for _ in range(n):
        m["sparsification_threshold"].append(r.flt_bits())
        m["non_zero_ratio"].append(r.flt_bits())
        m["spm_nn_accuracy"].append(r.flt_bits())
        count_classes = r.u(8)
        m["spm_class_bitmask"].append(r.ue(7))
        m["spm_nn_class_accuracy"].append(
            [r.flt_bits() for _ in range(count_classes)])
    return m


def _write_ppm(w: BitWriter, m: dict) -> None:
    n = len(m.get("pruning_ratio", ()))
    w.u(8, n + 1)
    for i in range(n):
        w.flt_bits(m["pruning_ratio"][i])
        w.flt_bits(m["ppm_nn_accuracy"][i])
        cls = m["ppm_nn_class_accuracy"][i]
        w.u(8, len(cls))
        w.ue(7, int(m["ppm_class_bitmask"][i]))
        for a in cls:
            w.flt_bits(a)


def _read_ppm(r: BitReader) -> dict:
    n = r.u(8) - 1
    m = {"pruning_ratio": [], "ppm_nn_accuracy": [], "ppm_class_bitmask": [],
         "ppm_nn_class_accuracy": []}
    for _ in range(n):
        m["pruning_ratio"].append(r.flt_bits())
        m["ppm_nn_accuracy"].append(r.flt_bits())
        count_classes = r.u(8)
        m["ppm_class_bitmask"].append(r.ue(7))
        m["ppm_nn_class_accuracy"].append(
            [r.flt_bits() for _ in range(count_classes)])
    return m


def _write_upm(w: BitWriter, m: dict) -> None:
    n = len(m.get("unification_threshold", ()))
    w.u(8, n + 1)
    for i in range(n):
        rd = m["reshaped_tensor_dimensions"][i]
        w.ue(1, len(rd) + 1)
        for d in rd:
            w.ue(7, int(d))
        w.byte_alignment()
        sb = m["super_block_dimensions"][i]
        w.u(8, len(sb) + 1)
        for d in sb:
            w.u(8, int(d))
        bd = m["block_dimensions"][i]
        w.u(8, len(bd) + 1)
        for d in bd:
            w.u(8, int(d))
        w.flt_bits(m["unification_threshold"][i])
        w.flt_bits(m["upm_nn_accuracy"][i])
        w.u(8, int(m["upm_count_classes"][i]))
        # quirk preserved from the reference: the class-accuracy loop runs
        # over the BITMASK value, not count_classes (hls:618-620)
        cls = m["upm_nn_class_accuracy"][i]
        bitmask = int(m["upm_class_bitmask"][i])
        assert len(cls) == bitmask, "upm class accuracies follow the bitmask"
        w.ue(7, bitmask)
        for a in cls:
            w.flt_bits(a)


def _read_upm(r: BitReader) -> dict:
    n = r.u(8) - 1
    m = {"reshaped_tensor_dimensions": [], "super_block_dimensions": [],
         "block_dimensions": [], "unification_threshold": [],
         "upm_nn_accuracy": [], "upm_count_classes": [],
         "upm_class_bitmask": [], "upm_nn_class_accuracy": []}
    for _ in range(n):
        cr = r.ue(1)
        m["reshaped_tensor_dimensions"].append(
            [r.ue(7) for _ in range(cr - 1)])
        r.byte_alignment()
        cs = r.u(8)
        m["super_block_dimensions"].append([r.u(8) for _ in range(cs - 1)])
        cb = r.u(8)
        m["block_dimensions"].append([r.u(8) for _ in range(cb - 1)])
        m["unification_threshold"].append(r.flt_bits())
        m["upm_nn_accuracy"].append(r.flt_bits())
        m["upm_count_classes"].append(r.u(8))
        bitmask = r.ue(7)
        m["upm_class_bitmask"].append(bitmask)
        m["upm_nn_class_accuracy"].append(
            [r.flt_bits() for _ in range(bitmask)])
    return m


def _write_dpm(w: BitWriter, m: dict) -> None:
    n = len(m.get("mse_threshold", ()))
    w.u(8, n + 1)
    for i in range(n):
        w.flt_bits(m["mse_threshold"][i])
        w.flt_bits(m["dpm_nn_accuracy"][i])
        w.flt_bits(m["nn_reduction_ratio"][i])
        cls = m["dpm_nn_class_accuracy"][i]
        w.u(16, len(cls))
        for a in cls:
            w.flt_bits(a)


def _read_dpm(r: BitReader) -> dict:
    n = r.u(8) - 1
    m = {"mse_threshold": [], "dpm_nn_accuracy": [], "nn_reduction_ratio": [],
         "dpm_nn_class_accuracy": []}
    for _ in range(n):
        m["mse_threshold"].append(r.flt_bits())
        m["dpm_nn_accuracy"].append(r.flt_bits())
        m["nn_reduction_ratio"].append(r.flt_bits())
        count_classes = r.u(16)
        m["dpm_nn_class_accuracy"].append(
            [r.flt_bits() for _ in range(count_classes)])
    return m


def _write_mps(w: BitWriter, h: dict) -> None:
    w.u(1, h.get("topology_carriage_flag", 0))
    w.u(1, h.get("mps_sparsification_flag", 0))
    w.u(1, h.get("mps_pruning_flag", 0))
    w.u(1, h.get("mps_unification_flag", 0))
    w.u(1, h.get("mps_decomposition_performance_map_flag", 0))
    w.u(2, h.get("mps_quantization_method_flags", 0))
    w.u(1, h.get("mps_topology_indexed_reference_flag", 0))
    if h.get("mps_quantization_method_flags", 0):
        w.u(4, int(h["mps_qp_density"]))
        w.i(16, int(h.get("mps_quantization_parameter", 0)))
    if h.get("mps_sparsification_flag", 0):
        _write_spm(w, h["mps_sparsification_performance_map"])
    if h.get("mps_pruning_flag", 0):
        _write_ppm(w, h["mps_pruning_performance_map"])
    if h.get("mps_unification_flag", 0):
        _write_upm(w, h["mps_unification_performance_map"])
    if h.get("mps_decomposition_performance_map_flag", 0):
        _write_dpm(w, h["mps_decomposition_performance_map"])
    w.byte_alignment()


def _read_mps(r: BitReader, h: dict) -> None:
    h["topology_carriage_flag"] = r.u(1)
    h["mps_sparsification_flag"] = r.u(1)
    h["mps_pruning_flag"] = r.u(1)
    h["mps_unification_flag"] = r.u(1)
    h["mps_decomposition_performance_map_flag"] = r.u(1)
    h["mps_quantization_method_flags"] = r.u(2)
    h["mps_topology_indexed_reference_flag"] = r.u(1)
    if h["mps_quantization_method_flags"]:
        h["mps_qp_density"] = r.u(4)
        h["mps_quantization_parameter"] = r.i(16)
    if h["mps_sparsification_flag"]:
        h["mps_sparsification_performance_map"] = _read_spm(r)
    if h["mps_pruning_flag"]:
        h["mps_pruning_performance_map"] = _read_ppm(r)
    if h["mps_unification_flag"]:
        h["mps_unification_performance_map"] = _read_upm(r)
    if h["mps_decomposition_performance_map_flag"]:
        h["mps_decomposition_performance_map"] = _read_dpm(r)
    r.byte_alignment()


def _write_lps(w: BitWriter, h: dict) -> None:
    """NNR_LPS: layer parameter set (reference: hls nnr_layer_parameter_set
    unit header :355-357 and payload :622-641)."""
    w.u(1, h.get("lps_self_contained_flag", 0))
    w.u(7, 0)  # nnr_reserved_zero_7bits
    w.byte_alignment()
    w.u(1, 0)  # nnr_reserved_zero_1_bits
    w.u(1, h.get("lps_sparsification_flag", 0))
    w.u(1, h.get("lps_pruning_flag", 0))
    w.u(1, h.get("lps_unification_flag", 0))
    w.u(3, h.get("lps_quantization_method_flags", 0))
    w.u(1, 0)  # nnr_reserved_zero_1bit
    if h.get("lps_quantization_method_flags", 0):
        w.u(4, int(h.get("lps_qp_density", 2)))
        w.i(16, int(h.get("lps_quantization_parameter", 0)))
    if h.get("lps_sparsification_flag", 0):
        _write_spm(w, h["lps_sparsification_performance_map"])
    if h.get("lps_pruning_flag", 0):
        _write_ppm(w, h["lps_pruning_performance_map"])
    if h.get("lps_unification_flag", 0):
        _write_upm(w, h["lps_unification_performance_map"])
    w.byte_alignment()


def _read_lps(r: BitReader, h: dict) -> None:
    h["lps_self_contained_flag"] = r.u(1)
    r.u(7)
    r.byte_alignment()
    r.u(1)
    h["lps_sparsification_flag"] = r.u(1)
    h["lps_pruning_flag"] = r.u(1)
    h["lps_unification_flag"] = r.u(1)
    h["lps_quantization_method_flags"] = r.u(3)
    r.u(1)
    if h["lps_quantization_method_flags"]:
        h["lps_qp_density"] = r.u(4)
        h["lps_quantization_parameter"] = r.i(16)
    if h["lps_sparsification_flag"]:
        h["lps_sparsification_performance_map"] = _read_spm(r)
    if h["lps_pruning_flag"]:
        h["lps_pruning_performance_map"] = _read_ppm(r)
    if h["lps_unification_flag"]:
        h["lps_unification_performance_map"] = _read_upm(r)
    r.byte_alignment()


def _write_tpl(w: BitWriter, h: dict) -> None:
    w.u(8, int(h["topology_storage_format"]))
    w.u(8, int(h.get("topology_compression_format", 0)))
    w.st(h.get("topology_data", ""))


def _read_tpl(r: BitReader, h: dict) -> None:
    h["topology_storage_format"] = r.u(8)
    h["topology_compression_format"] = r.u(8)
    h["topology_data"] = r.st()


def _write_codebook_fields(w: BitWriter, h: dict, suffix: str) -> None:
    egk = int(h["codebook_egk__" + suffix])
    size = int(h["codebook_size__" + suffix])
    off = int(h["CbZeroOffset__" + suffix])
    w.ue(2, egk)
    w.ue(8, size)
    w.cb_zero_offset(size, off)
    w.codebook(egk, size, off, h["codebook__" + suffix])


def _read_codebook_fields(r: BitReader, h: dict, suffix: str) -> None:
    egk = r.ue(2)
    size = r.ue(8)
    off = r.cb_zero_offset(size)
    h["codebook_egk__" + suffix] = egk
    h["codebook_size__" + suffix] = size
    h["CbZeroOffset__" + suffix] = off
    h["codebook__" + suffix] = np.array(r.codebook(egk, size, off),
                                        dtype=np.int32)


def _write_ndu(w: BitWriter, h: dict) -> None:
    pt = int(h["nnr_compressed_data_unit_payload_type"])
    w.u(2, pt)
    w.u(1, h["nnr_multiple_topology_elements_present_flag"])
    w.u(1, h.get("nnr_decompressed_data_format_present_flag", 0))
    w.u(1, h["input_parameters_present_flag"])
    w.byte_alignment()

    if h["nnr_multiple_topology_elements_present_flag"]:
        ids = h["topology_elem_id_list"]
        w.u(16, h["count_topology_elements_minus2"])
        for elem in ids:
            w.st(elem)
    else:
        w.st(h["topology_elem_id"])

    if h.get("nnr_decompressed_data_format_present_flag", 0):
        w.u(7, int(h.get("nnr_decompressed_data_format", 1)))
        w.byte_alignment()

    if h["input_parameters_present_flag"]:
        w.u(1, h.get("tensor_dimensions_flag", 1))
        w.u(1, h.get("cabac_unary_length_flag", 1))
        if h.get("tensor_dimensions_flag", 1):
            w.ue(2, h["count_tensor_dimensions"])
            for d in h["tensor_dimensions"]:
                w.ue(7, int(d))
        if h.get("cabac_unary_length_flag", 1):
            w.ue(2, int(h["cabac_unary_length_minus1"]))
        w.u(4, int(h.get("compressed_parameter_types", 0)))
        if int(h.get("compressed_parameter_types", 0)) & \
                BlockParameterTypes.NNR_CPT_DC:
            w.ue(7, int(h["decomposition_rank"]))
            w.ue(7, int(h["g_number_of_rows"]))

    if pt in (_PT.NNR_PT_BLOCK, _PT.NNR_PT_FLOAT, _PT.NNR_PT_INT):
        w.u(1, int(h["dq_flag"]))

    w.u(1, h.get("codebook_present_flag", 0))
    if h.get("codebook_present_flag", 0):
        _write_codebook_fields(w, h, "")
        if pt == _PT.NNR_PT_BLOCK and \
                (int(h.get("compressed_parameter_types", 0)) &
                 BlockParameterTypes.NNR_CPT_DC):
            _write_codebook_fields(w, h, "dc")

    if len(h.get("tensor_dimensions", ())) > 1 and \
            pt in (_PT.NNR_PT_BLOCK, _PT.NNR_PT_FLOAT, _PT.NNR_PT_INT):
        w.u(4, int(h.get("scan_order", 0)))
        if int(h.get("scan_order", 0)) > 0:
            # entry-point lists: one list per coded tensor that chunks, in
            # payload order; counts are derivable from dims + scan_order.
            for eps in h.get("cabac_entry_point_lists", []):
                w.ue(5, len(eps))
                w.entry_point_list(len(eps), eps)
    w.byte_alignment()

    if pt == _PT.NNR_PT_RAW_FLOAT:
        w.flt_tensor(32, np.ascontiguousarray(
            h["raw_float32_parameter"], dtype=np.float32))


def _oob_fill(h: dict, oob) -> None:
    """Fill header fields carried out-of-band (reference: compile_ndu_oob,
    nnc_core/coder/syntax_compiler.py:44-63; the reference's generator-based
    parse pauses mid-header for the same fixup, hls:419)."""
    if oob is None:
        raise ValueError(
            "bitstream uses out-of-band NDU parameters; decode requires "
            "external model information (tensor dimensions)")
    if "tensor_dimensions" not in h and "tensor_dimensions" in oob:
        # stream-global dims from a full-OOB dict (single-tensor streams)
        h["tensor_dimensions"] = list(oob["tensor_dimensions"])
        h["count_tensor_dimensions"] = len(h["tensor_dimensions"])
    if "tensor_dimensions" not in h:
        if h.get("nnr_multiple_topology_elements_present_flag"):
            # the weight (or its G factor) is the FIRST topology element of
            # a block NDU (coder._block_names_from_topology ordering);
            # companions (ls/bn/bias) follow
            name = h["topology_elem_id_list"][0]
            if name.endswith("_G") or name.endswith("_H"):
                name = name[:-2]
        else:
            name = h["topology_elem_id"]
        dims = oob["parameter_dimensions"][name]
        h["tensor_dimensions"] = list(dims)
        h["count_tensor_dimensions"] = len(dims)
    if "cabac_unary_length_minus1" not in h:
        h["cabac_unary_length_minus1"] = int(
            oob.get("cabac_unary_length_minus1", 10))


def _read_ndu(r: BitReader, h: dict, oob=None) -> None:
    pt = r.u(2)
    h["nnr_compressed_data_unit_payload_type"] = _PT(pt)
    h["nnr_multiple_topology_elements_present_flag"] = r.u(1)
    h["nnr_decompressed_data_format_present_flag"] = r.u(1)
    h["input_parameters_present_flag"] = r.u(1)
    r.byte_alignment()

    if h["nnr_multiple_topology_elements_present_flag"]:
        h["count_topology_elements_minus2"] = r.u(16)
        n = h["count_topology_elements_minus2"] + 2
        h["topology_elem_id_list"] = [r.st() for _ in range(n)]
    else:
        h["topology_elem_id"] = r.st()

    if h["nnr_decompressed_data_format_present_flag"]:
        h["nnr_decompressed_data_format"] = r.u(7)
        r.byte_alignment()

    if h["input_parameters_present_flag"]:
        h["tensor_dimensions_flag"] = r.u(1)
        h["cabac_unary_length_flag"] = r.u(1)
        if h["tensor_dimensions_flag"]:
            h["count_tensor_dimensions"] = r.ue(2)
            h["tensor_dimensions"] = [r.ue(7) for _ in
                                      range(h["count_tensor_dimensions"])]
        if h["cabac_unary_length_flag"]:
            h["cabac_unary_length_minus1"] = r.ue(2)
        h["compressed_parameter_types"] = r.u(4)
        if h["compressed_parameter_types"] & BlockParameterTypes.NNR_CPT_DC:
            h["decomposition_rank"] = r.ue(7)
            h["g_number_of_rows"] = r.ue(7)
    else:
        # full out-of-band header (input_parameters_present_flag = 0):
        # cpt + DC fields come from the stream-global OOB dict
        if oob is None or "compressed_parameter_types" not in oob:
            raise ValueError(
                "bitstream uses fully out-of-band NDU parameters "
                "(input_parameters_present_flag = 0); decode requires the "
                "compile_ndu_oob dict used at encode (ndu_oob=...)")
        h["compressed_parameter_types"] = int(
            oob["compressed_parameter_types"])
        if h["compressed_parameter_types"] & BlockParameterTypes.NNR_CPT_DC:
            h["decomposition_rank"] = int(oob["decomposition_rank"])
            h["g_number_of_rows"] = int(oob["g_number_of_rows"])
    if "tensor_dimensions" not in h or "cabac_unary_length_minus1" not in h:
        _oob_fill(h, oob)

    if pt in (_PT.NNR_PT_BLOCK, _PT.NNR_PT_FLOAT, _PT.NNR_PT_INT):
        h["dq_flag"] = r.u(1)

    h["codebook_present_flag"] = r.u(1)
    if h["codebook_present_flag"]:
        _read_codebook_fields(r, h, "")
        if pt == _PT.NNR_PT_BLOCK and \
                (h.get("compressed_parameter_types", 0) &
                 BlockParameterTypes.NNR_CPT_DC):
            _read_codebook_fields(r, h, "dc")

    if len(h.get("tensor_dimensions", ())) > 1 and \
            pt in (_PT.NNR_PT_BLOCK, _PT.NNR_PT_FLOAT, _PT.NNR_PT_INT):
        h["scan_order"] = r.u(4)
        if h["scan_order"] > 0:
            # Only the >=2-D tensors of the unit carry entry points (block
            # companions are 1-D): one list for the weight, or two when the
            # block carries G/H decomposition factors. Entry points are
            # byte offsets only (chunk segments restart the engine/contexts/
            # DQ state, so no mid-stream resume fields exist).
            n_lists = 2 if (pt == _PT.NNR_PT_BLOCK and
                            (h.get("compressed_parameter_types", 0) &
                             BlockParameterTypes.NNR_CPT_DC)) else 1
            lists = []
            for _ in range(n_lists):
                n = r.ue(5)
                lists.append(r.entry_point_list(n))
            h["cabac_entry_point_lists"] = lists
    r.byte_alignment()

    if pt == _PT.NNR_PT_RAW_FLOAT:
        h["raw_float32_parameter"] = r.flt_tensor(
            32, tuple(h.get("tensor_dimensions", (1,))))


# ---------------------------------------------------------------------------
# Unit framing
# ---------------------------------------------------------------------------
_WRITERS = {
    NnrUnitType.NNR_STR: _write_str,
    NnrUnitType.NNR_MPS: _write_mps,
    NnrUnitType.NNR_LPS: _write_lps,
    NnrUnitType.NNR_TPL: _write_tpl,
    NnrUnitType.NNR_NDU: _write_ndu,
}
_READERS = {
    NnrUnitType.NNR_STR: _read_str,
    NnrUnitType.NNR_MPS: _read_mps,
    NnrUnitType.NNR_LPS: _read_lps,
    NnrUnitType.NNR_TPL: _read_tpl,
    NnrUnitType.NNR_NDU: _read_ndu,
}


def encode_unit(header: dict, payload: bytes = b"") -> bytearray:
    """Serialize one unit (with nnr_unit_size back-patched).
    (reference: hls encode_nnr_unit_with_size_dummy/update_nnr_unit_size,
    nnc_core/hls/__init__.py:664-704)"""
    buf = bytearray()
    w = BitWriter(buf)
    w.u(32, 0)  # size dummy
    _write_unit_header(w, header)
    _WRITERS[NnrUnitType(header["nnr_unit_type"])](w, header)
    if payload:
        w.bytes_payload(payload)
    size = len(buf) - 4
    buf[0:4] = size.to_bytes(4, "big")
    return buf


def decode_unit_header(r: BitReader, oob=None):
    """Read size + generic + unit-specific header. Returns (header, payload
    start byte, unit end byte). ``oob`` supplies out-of-band NDU parameters
    (parameter_dimensions / cabac_unary_length_minus1) for streams encoded
    with them omitted.

    Units of an unknown/unsupported type are skipped by size (the header
    carries ``unknown_unit_type``) instead of failing the whole stream —
    parse tolerance for forward compatibility (the reference KeyErrors)."""
    start = r.byte_pos
    size = r.u(32)
    end = start + 4 + size
    raw_type = r.u(8)
    try:
        utype = NnrUnitType(raw_type)
        reader = _READERS[utype]
    except (ValueError, KeyError):
        return {"nnr_unit_type": None, "unknown_unit_type": raw_type}, end, end
    h = {"nnr_unit_type": utype}
    h["partial_data_counter_present_flag"] = r.u(1)
    if h["partial_data_counter_present_flag"]:
        h["partial_data_counter"] = r.u(15)
    h["independently_decodable_flag"] = r.u(1)
    r.byte_alignment()
    if reader is _read_ndu:
        reader(r, h, oob)
    else:
        reader(r, h)
    return h, r.byte_pos, end
