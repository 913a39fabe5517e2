"""Minimal dependency-free PNG reader/writer (zlib is in the stdlib).

Plays the role of the reference's libpng wrapper (src/driver/image.cpp).
Supports 8-bit RGB/RGBA/gray, which covers the reference's golden
images and our own outputs.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def read_png(path):
    """Reads an 8-bit PNG into a (H, W, C) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _MAGIC, "not a PNG"
    pos = 8
    idat = []
    width = height = bit_depth = color_type = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            assert bit_depth == 8, f"unsupported bit depth {bit_depth}"
            assert interlace == 0, "interlaced PNG unsupported"
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    stride = width * channels
    raw = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    filters = raw[:, 0]
    lines = raw[:, 1:].copy()
    out = np.zeros_like(lines)
    bpp = channels
    for y in range(height):
        line = lines[y].astype(np.uint8).copy()
        f = filters[y]
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.uint8)
        if f == 0:
            out[y] = line
        elif f == 1:  # Sub
            for x in range(stride):
                left = out[y, x - bpp] if x >= bpp else 0
                out[y, x] = (int(line[x]) + int(left)) & 0xFF
        elif f == 2:  # Up
            out[y] = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif f == 3:  # Average
            for x in range(stride):
                left = int(out[y, x - bpp]) if x >= bpp else 0
                out[y, x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                a = int(out[y, x - bpp]) if x >= bpp else 0
                c = int(prev[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                out[y, x] = (int(line[x]) + int(_paeth(
                    np.uint8(a), np.uint8(b), np.uint8(c)))) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
    img = out.reshape(height, width, channels)
    if color_type == 3:
        img = palette[img[..., 0]]
    return img


def write_png(path, img):
    """Writes a (H, W), (H, W, 3) or (H, W, 4) uint8 array as PNG."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1).tobytes()
    idat = zlib.compress(raw, 6)

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload +
                struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", idat))
        f.write(chunk(b"IEND", b""))
