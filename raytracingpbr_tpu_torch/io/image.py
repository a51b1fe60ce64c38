"""PNG read/write in numpy and ``zlib``.

Covers the format the repository's goldens use: 8-bit, non-interlaced, gray
/ RGB / RGBA, every scanline with filter type 0 (what the native codec,
``native/image_io.cpp``, writes). Anything else raises.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> channels


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """An (H, W, 3) image (float in [0, 1] or uint8) as the bytes of an RGB
    PNG. zlib level 1 by default: the live preview's frames are
    latency-bound."""
    u8 = _to_u8(img)
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        body = typ + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) image (float in [0, 1] or uint8) as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level=6))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced, filter-0 PNG into (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if typ == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: scanline filters other than 0 are not "
                         "supported")
    return rows[:, 1:].reshape(h, w, c).copy()
