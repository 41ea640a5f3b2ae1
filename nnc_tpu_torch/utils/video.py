"""Video artifact writer with graceful degradation.

The reference writes testset/spiral videos as mp4 via imageio+ffmpeg
(reference: framework/nerf_model/run_nerf.py:781-794, fps=30 quality=8).
This environment has no ffmpeg, so previously the writers fell back to
GIF (256-color, ~10x larger, fixed frame duration). This module restores
a real 30 fps true-color video artifact without ffmpeg by muxing
PIL-encoded JPEG frames into an AVI (MJPEG) container in pure Python:

  1. ``.mp4`` via imageio (ffmpeg) — reference-identical artifact
  2. ``.avi`` MJPEG, pure-Python RIFF muxer + PIL JPEG frames
  3. ``.gif`` via imageio — last resort (PIL also absent)

``write_video`` returns the path actually written (or None).
"""
from __future__ import annotations

import io
import os
import struct

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    if frame.ndim == 2:  # grayscale (disp maps): promote for compatibility
        frame = np.repeat(frame[..., None], 3, axis=-1)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(path: str, frames: np.ndarray, fps: int = 30,
                    quality: int = 90) -> None:
    """Mux uint8 frames (N,H,W,3) or (N,H,W) into an MJPEG .avi.

    Standard RIFF/AVI layout (hdrl: avih + one 'vids'/'MJPG' stream;
    movi: one '00dc' JPEG chunk per frame; idx1 keyframe index) — every
    frame is an independent JPEG, so all frames are keyframes.
    """
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise TypeError(f"frames must be uint8, got {frames.dtype}")
    if frames.ndim == 3:
        frames = frames[..., None].repeat(3, axis=-1)
    n, h, w = frames.shape[:3]
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    max_sz = max(len(j) for j in jpegs)

    # AVIMAINHEADER (56 bytes): frame timing, HASINDEX flag, dimensions
    avih = _chunk(b"avih", struct.pack(
        "<14I", round(1e6 / fps), max_sz * fps, 0, 0x10, n, 0, 1,
        max_sz, w, h, 0, 0, 0, 0))
    # AVISTREAMHEADER: fps as dwRate/dwScale, stream length in frames
    strh = _chunk(b"strh", struct.pack(
        "<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0,
        n, max_sz, 0xFFFFFFFF, 0, 0, 0, w, h))
    # BITMAPINFOHEADER with MJPG compression
    strf = _chunk(b"strf", struct.pack(
        "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0))
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_payload = b""
    index = b""
    for j in jpegs:
        # idx1 offsets are relative to the 'movi' fourcc; the first
        # chunk therefore sits at offset 4
        index += struct.pack("<4sIII", b"00dc", 0x10,
                             4 + len(movi_payload), len(j))
        movi_payload += _chunk(b"00dc", j)
    movi = _list(b"movi", movi_payload)
    idx1 = _chunk(b"idx1", index)

    riff = _chunk(b"RIFF", b"AVI " + hdrl + movi + idx1)
    with open(path, "wb") as f:
        f.write(riff)


def write_video(path_base: str, frames: np.ndarray, fps: int = 30,
                quality: int = 8, verbose: bool = False):
    """Write ``path_base`` + best-available extension; return the path.

    ``quality`` follows the reference's imageio scale (0-10); it is
    mapped to a JPEG quality for the AVI fallback.
    """
    frames = np.asarray(frames)
    try:
        import imageio.v2 as imageio
        path = path_base + ".mp4"
        imageio.mimwrite(path, frames, fps=fps, quality=quality)
        return path
    except Exception:
        pass
    try:
        path = path_base + ".avi"
        write_mjpeg_avi(path, frames, fps=fps,
                        quality=int(np.clip(quality, 0, 10) * 10))
        if verbose:
            print(f"wrote {path} (MJPEG fallback, no ffmpeg)")
        return path
    except Exception:
        pass
    try:
        import imageio.v2 as imageio
        path = path_base + ".gif"
        imageio.mimwrite(path, frames, duration=round(1000 / fps), loop=0)
        if verbose:
            print(f"wrote {path} (GIF fallback)")
        return path
    except Exception as e:
        print(f"INFO: video writing skipped ({e})")
        return None
