"""Image files.  Counterpart of pine_tpu/io/image_io.py (save_image,
load_image).

PNG is written and read with the standard library (zlib, struct), so the
port needs no imaging package.  ``save_image`` applies the reference's
clip, 1/2.2 encode, rounding and vertical flip, then writes an 8-bit RGB
PNG.  ``decode_png`` reads 8-bit gray, gray+alpha, RGB and RGBA PNGs without
interlace, undoing the five row filters (None, Sub, Up, Average, Paeth);
ancillary chunks are skipped, and any other PNG (palette, 1-, 2-, 4- or
16-bit samples, Adam7 interlace) or another file format is refused with a
message that names it.  ``load_image`` gives the array pine_tpu's
``load_image`` gives for such a file, in its float32 order: the samples as
PIL reads them, gray replicated to RGB, the alpha of RGBA dropped, then /255
and, with ``decode_srgb``, **2.2.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def encode_rgb8(rgb, invert_y=True, encode_srgb=True):
    """(H,W,3) float [0,1] (or uint8) -> (H,W,3) uint8, as written to disk."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0.0, 1.0)
        if encode_srgb:
            rgb = rgb ** (1.0 / 2.2)
        rgb = (rgb * 255.0 + 0.5).astype(np.uint8)
    if invert_y:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters of 8-bit samples -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if kind == 0:
            cur = line.copy()
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 1:  # Sub: a running sum of each channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) \
                .astype(np.uint8).reshape(-1)
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}: not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data):
    """PNG bytes -> uint8 (H,W) gray or (H,W,C) samples (C = 2, 3 or 4), as
    PIL's ``np.asarray(Image.open(...))`` gives them (module docstring)."""
    if data[:8] != PNG_SIGNATURE:
        kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "non-PNG"
        raise ValueError(f"a {kind} image is not supported: only PNG files are read")
    pos, idat, head = 8, [], None
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # a critical chunk (PLTE) this reader does not take
            raise ValueError(f"PNG chunk {kind.decode('latin-1')} is not supported")
    if head is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = head
    if colour not in CHANNELS:
        raise ValueError(f"{COLOUR_NAMES.get(colour, f'colour type {colour}')} PNGs are not "
                         "supported: only 8-bit gray, gray+alpha, RGB and RGBA")
    if depth != 8:
        raise ValueError(f"{depth}-bit {COLOUR_NAMES[colour]} PNGs are not supported: "
                         "only 8-bit samples")
    if interlace:
        raise ValueError("Adam7-interlaced PNGs are not supported")
    ch = CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (1 + w * ch):
        raise ValueError("PNG image data is truncated")
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def rgb_of(samples):
    """Decoded samples as (H,W,3) uint8: gray replicated, alpha dropped (PIL's
    ``convert("RGB")``)."""
    if samples.ndim == 2:
        return np.stack([samples] * 3, axis=-1)
    if samples.shape[-1] == 2:
        return np.stack([samples[..., 0]] * 3, axis=-1)
    return samples[..., :3]


def load_image(path, decode_srgb=True):
    """Read an 8-bit PNG as pine_tpu's ``load_image`` does -> float32 (H,W,3),
    or (H,W,2) for gray+alpha, whose alpha pine_tpu keeps (module
    docstring)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    arr = arr.astype(np.float32) / 255.0
    if decode_srgb:
        arr = arr**2.2
    return arr


def _chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def save_image(path, rgb, invert_y=True, encode_srgb=True):
    """Write (H,W,3) float [0,1] (or uint8) as an 8-bit RGB PNG."""
    img = encode_rgb8(rgb, invert_y, encode_srgb)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
