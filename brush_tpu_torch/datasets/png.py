"""A PNG codec in the standard library, numpy and the port's native
library, for hosts without Pillow.

The port's datasets are mostly 8-bit PNGs (NeRF-synthetic scenes, the
renders of `cli render`), and a card's host may have no Pillow. So:

- `decode_png` reads 8-bit, non-interlaced PNGs of colour type 0 (grey),
  2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), with a `tRNS`
  chunk and all five row filters. It returns what
  `np.asarray(Image.open(f).convert("RGBA" if alpha else "RGB"))` returns
  (the arrays are byte-equal), where `alpha` is the reference's rule: an
  alpha channel or a `tRNS` chunk (brush_tpu/datasets/scene.py:67-75).
- `encode_png` writes an 8-bit grey, RGB or RGBA array with every row
  stored unfiltered (filter 0).

The row filters are undone by the port's native library
(brush_tpu_torch/native/png.cpp, built with g++ at first use), which
releases the interpreter lock, so the loader's threads decode in
parallel. On a host without a compiler numpy does it. Rows filtered with
Average or Paeth depend on the pixel to their left and on the row above,
so the image is unfiltered as a wavefront: pixel (r, c) needs only pixels
on the anti-diagonals r + c - 1 and r + c - 2, and each anti-diagonal
(every row's own filter at once, all channels) is a few numpy
operations, h + w - 1 steps in all.
Any other PNG (16-bit or fewer than 8 bits, interlaced) and any other
format goes to Pillow (see `datasets.loading._decode_image`).
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

from brush_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples a pixel, by colour type.
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngHeader(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


def read_header(data: bytes) -> PngHeader | None:
    """The IHDR fields of a PNG, or None when `data` is not a PNG."""
    if len(data) < 33 or data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    return PngHeader(w, h, depth, ctype, interlace)


def decodable(header: PngHeader | None) -> bool:
    """Whether `decode_png` reads a PNG with this header."""
    return (header is not None and header.bit_depth == 8
            and header.color_type in CHANNELS and header.interlace == 0)


def _chunks(data: bytes):
    """(type, body) of each chunk after the signature, CRCs checked."""
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_wavefront(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """The image bytes (h, w * bpp) of filtered scanlines `rows` (h,
    1 + w * bpp), one anti-diagonal of pixels at a time.

    The pixels sit in a (h + 1, w + 1) grid with a zero row above and a zero
    column to the left, flattened: along an anti-diagonal the flat index
    steps by w, so a diagonal and its left, upper and upper-left neighbours
    are strided slices."""
    h = rows.shape[0]
    kinds = rows[:, 0, None]
    filt = rows[:, 1:].reshape(h * w, bpp).astype(np.int16)
    out = np.zeros(((h + 1) * (w + 1), bpp), np.int16)
    fstep = max(w - 1, 1)   # a 1-pixel-wide image has one pixel a diagonal
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        n = r1 - r0   # pixels on the diagonal, less one
        s = w + 2 + d + r0 * w   # (r0, d - r0) in the padded grid
        e = s + n * w + 1
        a = out[s - 1:e - 1:w]             # left
        b = out[s - w - 1:e - w - 1:w]     # up
        c = out[s - w - 2:e - w - 2:w]     # up-left
        f0 = d + r0 * (w - 1)
        f = filt[f0:f0 + n * fstep + 1:fstep]
        k = kinds[r0:r1 + 1]
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(k == 4, paeth, np.where(
            k == 3, (a + b) >> 1, np.where(
                k == 2, b, np.where(k == 1, a, 0))))
        out[s:e:w] = (f + pred) & 255
    return out.reshape(h + 1, w + 1, bpp)[1:, 1:].astype(np.uint8).reshape(
        h, w * bpp)


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """The image bytes (height, stride) from the filtered scanlines."""
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    kinds = rows[:, 0]
    top = int(kinds.max(initial=0))
    if top > 4:
        raise ValueError(f"PNG: unknown row filter {top}")
    if native.available():
        return native.png_unfilter(rows, bpp)
    return _unfilter_wavefront(rows, stride // bpp, bpp)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3|4) uint8 from an 8-bit, non-interlaced PNG: RGBA iff the
    PNG has an alpha channel or a `tRNS` chunk, else RGB, as Pillow's
    convert gives them. Raises ValueError on any other PNG."""
    header = read_header(data)
    if not decodable(header):
        raise ValueError(f"decode_png reads 8-bit non-interlaced PNGs of "
                         f"colour type 0, 2, 3, 4 or 6, not {header}")
    w, h, _depth, ctype, _il = header
    palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    bpp = CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of scanlines, "
                         f"{h * (stride + 1)} needed")
    px = _unfilter(raw, h, stride, bpp).reshape(h, w, bpp)

    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        # Indices past the palette read as black, as in Pillow.
        full = np.zeros((256, 4), np.uint8)
        full[:len(palette), :3] = palette
        full[:, 3] = 255
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            full[:len(alpha), 3] = alpha
        return full[px[..., 0], :4 if trns is not None else 3]
    if ctype in (0, 2):
        rgb = np.repeat(px, 3, axis=2) if ctype == 0 else px
        if trns is None:
            return np.ascontiguousarray(rgb)
        # A tRNS colour: the pixels equal to it are transparent. Its
        # samples are 16-bit; one above 255 matches no 8-bit pixel.
        key = struct.unpack(">" + "H" * (len(trns) // 2), trns)
        match = np.all(px == np.asarray(key[:bpp], np.int32), axis=2)
        alpha = np.where(match, 0, 255).astype(np.uint8)
        return np.concatenate([rgb, alpha[..., None]], axis=2)
    if ctype == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, axis=2),
                               px[..., 1:]], axis=2)
    return px


def png_bytes(width: int, height: int, color_type: int,
              scanlines: bytes) -> bytes:
    """A PNG file from its filtered scanlines (each row prefixed by its
    filter byte): signature, IHDR, one IDAT, IEND."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scanlines))
            + chunk(b"IEND", b""))


def encode_png(image: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 (H, W), (H, W, 3) or (H, W, 4) array, every
    row unfiltered."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[2] if img.ndim == 3 else 0)
    if ctype is None:
        raise ValueError(f"encode_png takes (H, W[, 3|4]), not {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * img.shape[2]), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    return png_bytes(w, h, ctype, rows.tobytes())
