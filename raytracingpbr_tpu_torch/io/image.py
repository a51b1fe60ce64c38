"""PNG and Radiance RGBE (.hdr) read/write in numpy and ``zlib``.

PNG covers the format the repository's goldens use: 8-bit, non-interlaced,
gray / RGB / RGBA, every scanline with filter type 0 (what the native
codec, ``native/image_io.cpp``, writes). Anything else raises.

HDR writes flat RGBE scanlines in float32 arithmetic, as the native codec
does (so the bytes are its bytes), and reads flat and new-style
run-length-encoded scanlines. The codecs have no work for the card.
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


_HDR_HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def encode_hdr(img: np.ndarray) -> bytes:
    """An (H, W, 3) float image as the bytes of a Radiance .hdr with flat
    RGBE scanlines: per pixel the mantissas ``trunc(c * frexp(m)[0] * 256
    / m)`` of the channels and ``exponent + 128``, ``m`` the largest
    channel; black (``m <= 1e-32``) is four zero bytes."""
    data = np.ascontiguousarray(np.asarray(img, np.float32))
    h, w = data.shape[:2]
    m = data.max(-1)
    lit = m > np.float32(1e-32)
    safe = np.where(lit, m, np.float32(1))
    mant, e = np.frexp(safe)
    scale = mant * np.float32(256) / safe
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.where(lit[..., None], data * scale[..., None],
                             np.float32(0)).astype(np.uint8)
    rgbe[..., 3] = np.where(lit, e + 128, 0).astype(np.uint8)
    return _HDR_HEAD + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes()


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) float image as Radiance RGBE (.hdr)."""
    with open(path, "wb") as f:
        f.write(encode_hdr(img))


def _rle_scanline(data: bytes, pos: int, w: int, path: str):
    """One new-style RLE scanline (four component planes after its 4-byte
    header at ``pos``) -> ((w, 4) uint8, next position)."""
    out = np.empty((4, w), np.uint8)
    pos += 4
    for c in range(4):
        x = 0
        while x < w:
            if pos >= len(data):
                raise ValueError(f"{path}: truncated scanline")
            code = data[pos]
            pos += 1
            if code > 128:  # a run of one byte
                count = code - 128
                if x + count > w or pos >= len(data):
                    raise ValueError(f"{path}: bad run")
                out[c, x:x + count] = data[pos]
                pos += 1
            else:  # literal bytes
                count = code
                if count == 0 or x + count > w or pos + count > len(data):
                    raise ValueError(f"{path}: bad literal")
                out[c, x:x + count] = np.frombuffer(data, np.uint8, count,
                                                    pos)
                pos += count
            x += count
    return out.T, pos


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (``-Y H +X W``, flat or new-style RLE
    scanlines) into (H, W, 3) float32 linear radiance, row 0 at the top:
    ``mantissa * 2**(e - 136)``, zero where ``e`` is 0."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    pos, fmt_ok = data.index(b"\n") + 1, False
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].rstrip(b"\r")
        pos = end + 1
        if not line:
            break
        fmt_ok |= b"FORMAT=32-bit_rle_rgbe" in line
    if not fmt_ok:
        raise ValueError(f"{path}: not 32-bit_rle_rgbe")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        head = data[pos:pos + 4]
        if (8 <= w <= 0x7FFF and len(head) == 4 and head[0] == 2
                and head[1] == 2 and (head[2] << 8 | head[3]) == w):
            rgbe[y], pos = _rle_scanline(data, pos, w, path)
        else:
            if pos + 4 * w > len(data):
                raise ValueError(f"{path}: truncated scanline")
            rgbe[y] = np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, np.float32(0),
                     np.ldexp(np.float32(1), e - 136).astype(np.float32))
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


def hdr_to_env_layout(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) row-major from the top -> the environment's (W, H, 3)
    ``img[x, y]`` layout with y up."""
    return np.ascontiguousarray(np.transpose(img[::-1], (1, 0, 2)))
