"""Plain reference of a served frame: the PNG read back, and the composite
the viewer puts over its background.

What the benchmark holds the viewer's `/api/frame` to. It imports nothing
of the program:

- `decode_png`: an 8-bit, non-interlaced PNG of colour type 0 (grey), 2
  (RGB), 4 (grey + alpha) or 6 (RGBA) to a uint8 (h, w, channels) array,
  by the PNG specification (ISO/IEC 15948): the chunks (CRCs checked),
  the IDAT stream inflated by zlib, and each row's filter undone (0 None,
  1 Sub, 2 Up, 3 Average, 4 Paeth). Rows of filter 0-2 are undone with a
  few numpy operations; Average and Paeth rows, which the viewer never
  writes, pixel by pixel.
- `composite`: an (h, w, 4) float RGBA render, premultiplied, as the
  viewer shows it (Brush's `render_u32_buffer` display path): each
  channel floored to u8 after clamping 255 x to [0, 255] (the RGBA8
  pack), then RGB plus the grey 24 times (1 - alpha) in float32, clipped
  to [0, 255] and truncated to u8.
- `numbers`: a served frame against the reference's: the largest gap of
  a channel in u8 levels (`level_gap`), and the share of pixels with a
  channel more than one level off (`off_share`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
BACKGROUND = 24.0


def header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG, or
    None when `data` does not start as one."""
    if len(data) < 33 or data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    return w, h, depth, ctype, interlace


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_slow(kind: int, row: bytearray, prev: bytes, bpp: int):
    """Average (3) or Paeth (4), in place, byte by byte."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + _paeth(a, b, c)) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 (h, w, channels) image of a PNG (see the module
    docstring); ValueError for anything else."""
    hdr = header(data)
    if hdr is None:
        raise ValueError("not a PNG")
    w, h, depth, ctype, interlace = hdr
    if depth != 8 or ctype not in CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    idat = []
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        if kind == b"IDAT":
            idat.append(body)
        if kind == b"IEND":
            break
        pos += 12 + length
    bpp = CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            px = line.reshape(w, bpp).astype(np.int64)
            cur = (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {r}: filter {kind}")
        out[r] = cur
        prev = out[r]
    return out.reshape(h, w, bpp)


def composite(rgba) -> np.ndarray:
    """uint8 (h, w, 3): a float (h, w, 4) premultiplied RGBA render as the
    viewer shows it (see the module docstring)."""
    img = np.asarray(rgba, np.float32)
    q = np.clip(img * np.float32(255.0), 0.0, 255.0).astype(np.int64)
    a = q[..., 3:4].astype(np.float32) / np.float32(255.0)
    rgb = q[..., :3].astype(np.float32) + np.float32(BACKGROUND) * (
        np.float32(1.0) - a)
    return np.clip(rgb, 0.0, 255.0).astype(np.uint8)


def numbers(served: np.ndarray, reference: np.ndarray) -> dict:
    """level_gap and off_share of a served uint8 (h, w, 3) frame against
    the reference's composite of the same shape."""
    if served.shape != reference.shape:
        return {"level_gap": float("inf"), "off_share": float("inf")}
    gap = np.abs(served.astype(np.int16) - reference.astype(np.int16))
    worst = gap.max(axis=-1)
    return {"level_gap": float(worst.max()),
            "off_share": float(np.mean(worst > 1))}
