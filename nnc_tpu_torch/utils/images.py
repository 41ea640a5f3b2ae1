"""PNG writing from the standard library alone (``zlib`` + ``struct``).

The executer's test-view and i_save renders write PNGs on machines that may
have no imaging package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image) -> bytes:
    """An 8-bit PNG of ``image``: uint8 (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA. Rows are stored unfiltered (filter type 0)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"image must be uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"image must be (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {img.shape}")
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    """Write ``image`` (see :func:`png_bytes`) to ``path``."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))
