"""Minimal pure-Python PNG *encoder* (zlib + struct, filter-0 rows), the
port's copy of ``data/png.py`` of the JAX package.

The decode side lives in the native C++ loader (``native/loader.cpp``,
bound by ``native_loader``); this writer lets tests and the card's smoke
run materialise TUM- and EuRoC-layout sequence directories without an
imaging library.  Supports
8/16-bit grayscale and 8-bit RGB — the formats the decoder reads
(reference dataset layout: TUM rgb/*.png + depth/*.png, 16-bit depth).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, array, bitdepth: int = 8) -> None:
    """Encode ``(H, W)`` gray or ``(H, W, 3)`` RGB, uint8 or uint16."""
    arr = np.asarray(array)
    h, w = arr.shape[:2]
    color_type = 0 if arr.ndim == 2 else 2
    if bitdepth == 8:
        data = arr.astype(np.uint8)
    else:
        data = arr.astype(">u2")
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
