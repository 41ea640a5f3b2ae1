"""NNR high-level syntax (HLS): bit-level I/O and unit enums.

Host-side, byte-exact bitstream plumbing for the NNR container
(ISO/IEC 15938-17 style). Implements the primitive bit codes used by the
syntax tree: fixed-width unsigned/signed (``u``/``i``), Exp-Golomb
(``ue``/``ie``), float/strings, codebook delta coding, and CABAC entry-point
lists. (reference: nnc_core/hls/__init__.py:9-258 defines the equivalent
surface; this is an independent bytearray-based implementation.)
"""
from __future__ import annotations

import enum
import sys

import numpy as np

assert sys.byteorder == "little"

# Version of this implementation's (self-defined) bitstream layout, written
# into every NNR_STR unit and checked on decode. The layout intentionally
# diverges from ISO/IEC 15938-17 (docs/BITSTREAM.md); self-consistency is the
# compatibility contract, so any layout change MUST bump this and the golden
# fixtures under tests/golden/ (byte-identity tests pin the current layout).
FORMAT_VERSION = 2  # v2: codebook-coded companions + partial block split


class NnrUnitType(enum.IntEnum):
    NNR_STR = 0
    NNR_MPS = 1
    NNR_LPS = 2
    NNR_TPL = 3
    NNR_QNT = 4
    NNR_NDU = 5
    NNR_AGG = 6


class DecompressedDataFormat(enum.IntEnum):
    TENSOR_INT32 = 0
    TENSOR_FLOAT32 = 1


class CompressedDataUnitPayloadType(enum.IntEnum):
    NNR_PT_INT = 0
    NNR_PT_FLOAT = 1
    NNR_PT_RAW_FLOAT = 2
    NNR_PT_BLOCK = 3


class BlockParameterTypes(enum.IntEnum):
    NNR_CPT_DC = 0x01
    NNR_CPT_LS = 0x02
    NNR_CPT_BN = 0x04
    NNR_CPT_BI = 0x08


class QuantizationMethodFlags(enum.IntEnum):
    NNR_QSU = 1
    NNR_QCB = 2


class TopologyStorageFormat(enum.IntEnum):
    NNR_TPL_UNREC = 0
    NNR_TPL_NNEF = 1
    NNR_TPL_ONNX = 2
    NNR_TPL_PYT = 3
    NNR_TPL_TEF = 4
    NNR_TPL_PRUN = 5
    NNR_TPL_REFLIST = 6
    NNR_TPL_JAX = 7  # TPU-native pytree topology (extension)


class TopologyCompressionFormat(enum.IntEnum):
    NNR_PT_RAW = 0
    NNR_DFL = 1


class BitWriter:
    """MSB-first bit writer over a ``bytearray``."""

    def __init__(self, bitstream: bytearray):
        self._bytes = bitstream
        self._nbits_in_cur = 0  # bits already written into the last byte (0..7)

    def get_num_bits_touched(self) -> int:
        return len(self._bytes) * 8 - (8 - self._nbits_in_cur if self._nbits_in_cur else 0)

    def write_bit(self, bit: int) -> None:
        if self._nbits_in_cur == 0:
            self._bytes.append(0)
            self._nbits_in_cur = 8
        self._nbits_in_cur -= 1
        if bit:
            self._bytes[-1] |= 1 << self._nbits_in_cur

    def u(self, n: int, x: int) -> None:
        """Fixed-width unsigned, n bits, MSB first."""
        x = int(x)
        assert n > 0 and 0 <= x < (1 << n), (n, x)
        for i in range(n - 1, -1, -1):
            self.write_bit((x >> i) & 1)

    def ue(self, k: int, x: int) -> None:
        """k-th order Exp-Golomb, unsigned (escalating-k unary prefix)."""
        x = int(x)
        assert x >= 0
        while x >= (1 << k):
            self.u(1, 0)
            x -= 1 << k
            k += 1
        self.u(1, 1)
        if k > 0:
            self.u(k, x)

    def i(self, n: int, x: int) -> None:
        """Fixed-width signed (two's complement), n bits."""
        x = int(x)
        assert -(1 << (n - 1)) <= x < (1 << (n - 1))
        self.u(n, x if x >= 0 else x + (1 << n))

    def ie(self, k: int, x: int) -> None:
        """Signed Exp-Golomb: interleave sign into magnitude."""
        x = int(x)
        self.ue(k, ((-x) << 1) if x <= 0 else ((x << 1) - 1))

    def byte_alignment(self) -> None:
        self.u(1, 1)
        self._nbits_in_cur = 0

    def flt(self, n: int, x) -> None:
        assert n == 32
        assert self._nbits_in_cur == 0
        self._bytes.extend(np.float32(x).tobytes())

    def flt_bits(self, x) -> None:
        """32-bit float at arbitrary bit position (performance-map fields)."""
        self.u(32, int(np.float32(x).view(np.uint32)))

    def flt_tensor(self, n: int, x: np.ndarray) -> None:
        assert n == 32
        assert self._nbits_in_cur == 0
        assert x.dtype == np.float32
        self._bytes.extend(np.ascontiguousarray(x).tobytes())

    def st(self, v: str) -> None:
        """Null-terminated UTF-8 string; must be byte-aligned."""
        assert self._nbits_in_cur == 0
        self._bytes.extend(v.encode("utf-8", "strict"))
        self._bytes.append(0)

    def bytes_payload(self, payload: bytes) -> None:
        assert self._nbits_in_cur == 0
        self._bytes.extend(payload)

    def codebook(self, codebook_egk: int, codebook_size: int, cb_zero_offset: int, codebook) -> None:
        """Delta-coded codebook around its zero-offset entry.

        (reference hls/__init__.py:121-134 coding layout.)"""
        prev = int(codebook[cb_zero_offset])
        self.ie(7, prev)  # codebook_zero_value
        for j in range(cb_zero_offset - 1, -1, -1):
            self.ue(codebook_egk, prev - int(codebook[j]) - 1)  # delta_left
            prev = int(codebook[j])
        prev = int(codebook[cb_zero_offset])
        for j in range(cb_zero_offset + 1, codebook_size):
            self.ue(codebook_egk, int(codebook[j]) - prev - 1)  # delta_right
            prev = int(codebook[j])

    def cb_zero_offset(self, codebook_size: int, cb_zero_offset: int) -> None:
        self.ie(2, cb_zero_offset - (codebook_size >> 1))

    def entry_point_list(self, block_rows_minus1: int, eps) -> None:
        """CABAC entry points: byte offsets only (first absolute ue, the
        rest delta-coded ie).

        The in-memory representation keeps the native codec's packed uint64
        (offset << 11); only the offset is serialized. The reference's
        3-field shape (offset, byte value, dq state; hls/__init__.py:136-148)
        exists so its decoder can resume the arithmetic engine mid-stream —
        this implementation instead restarts the engine, contexts, and DQ
        state at byte-aligned chunk boundaries (native/deepcabac.cpp
        encode_layer_impl), which makes the value/state fields dead by
        construction; they are omitted from the written syntax
        (docs/BITSTREAM.md)."""
        for j in range(block_rows_minus1):
            offset = int(eps[j]) >> 11
            if j == 0:
                self.ue(11, offset)
            else:
                self.ie(7, offset - (int(eps[j - 1]) >> 11))


class BitReader:
    """MSB-first bit reader over ``bytes``/``bytearray``."""

    def __init__(self, bitstream, start_byte: int = 0):
        self._bytes = bitstream
        self._byte_pos = start_byte
        self._bit_pos = 7

    @property
    def byte_pos(self) -> int:
        return self._byte_pos

    def get_num_bits_touched(self) -> int:
        return self._byte_pos * 8 + (7 - self._bit_pos if self._bit_pos != 7 else 0)

    def read_bit(self) -> int:
        bit = (self._bytes[self._byte_pos] >> self._bit_pos) & 1
        if self._bit_pos == 0:
            self._bit_pos = 7
            self._byte_pos += 1
        else:
            self._bit_pos -= 1
        return bit

    def u(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.read_bit()
        return x

    def ue(self, k: int) -> int:
        x = 0
        while self.read_bit() == 0:
            x += 1 << k
            k += 1
        if k > 0:
            x += self.u(k)
        return x

    def i(self, n: int) -> int:
        x = self.u(n)
        if x >= (1 << (n - 1)):
            x -= 1 << n
        return x

    def ie(self, k: int) -> int:
        x = self.ue(k)
        return -(x >> 1) if (x & 1) == 0 else ((x + 1) >> 1)

    def byte_alignment(self) -> None:
        one = self.read_bit()
        assert one == 1
        if self._bit_pos != 7:
            self._bit_pos = 7
            self._byte_pos += 1

    def flt(self, n: int):
        assert n == 32 and self._bit_pos == 7
        v = np.frombuffer(bytes(self._bytes[self._byte_pos:self._byte_pos + 4]), dtype="<f4")[0]
        self._byte_pos += 4
        return v

    def flt_bits(self) -> float:
        return float(np.uint32(self.u(32)).view(np.float32))

    def flt_tensor(self, n: int, dims):
        assert n == 32 and self._bit_pos == 7
        count = int(np.prod(dims))
        raw = bytes(self._bytes[self._byte_pos:self._byte_pos + 4 * count])
        self._byte_pos += 4 * count
        return np.frombuffer(raw, dtype="<f4").reshape(dims).copy()

    def st(self) -> str:
        assert self._bit_pos == 7
        end = self._bytes.index(0, self._byte_pos)
        s = bytes(self._bytes[self._byte_pos:end]).decode("utf-8")
        self._byte_pos = end + 1
        return s

    def bytes_payload(self, n: int) -> bytes:
        assert self._bit_pos == 7
        raw = bytes(self._bytes[self._byte_pos:self._byte_pos + n])
        self._byte_pos += n
        return raw

    def codebook(self, codebook_egk: int, codebook_size: int, cb_zero_offset: int):
        cb = [0] * codebook_size
        cb[cb_zero_offset] = self.ie(7)
        prev = cb[cb_zero_offset]
        for j in range(cb_zero_offset - 1, -1, -1):
            cb[j] = prev - self.ue(codebook_egk) - 1
            prev = cb[j]
        prev = cb[cb_zero_offset]
        for j in range(cb_zero_offset + 1, codebook_size):
            cb[j] = prev + self.ue(codebook_egk) + 1
            prev = cb[j]
        return cb

    def cb_zero_offset(self, codebook_size: int) -> int:
        return self.ie(2) + (codebook_size >> 1)

    def entry_point_list(self, block_rows_minus1: int):
        eps = []
        prev_offset = 0
        for j in range(block_rows_minus1):
            if j == 0:
                offset = self.ue(11)
            else:
                offset = prev_offset + self.ie(7)
            prev_offset = offset
            eps.append(offset << 11)
        return eps
