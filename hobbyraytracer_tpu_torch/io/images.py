"""Host-side image encode/decode (replaces vendored stb, SURVEY.md §2 #32).

A copy of hobbyraytracer_tpu/io/images.py, faults included (read_jpg
falls back to Pillow on a ValueError of io/jpeg.py only), so that both
packages read the same files to the same arrays. Pillow is imported only
inside read_jpg, for the streams io/jpeg.py refuses.

The reference vendors stb_image / stb_image_write for PNG/TGA/BMP encode and
PNG/JPG/HDR decode (texture.cpp:9-10, film.cpp:10-11). Image I/O is not
perf-critical (SURVEY.md #32), so this is a small dependency-free pure
numpy/stdlib implementation:

- write: PNG (zlib), TGA (uncompressed), BMP (24-bit)
- read: PNG (8-bit gray/RGB/RGBA, non-interlaced), TGA (type 2),
  BMP (24-bit), Radiance HDR (flat + RLE) via .hdr module

All functions use (H, W, C) uint8 row-major with row 0 at the TOP of the
image, matching stb's convention.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


# ----------------------------------------------------------------- PNG write

def write_png(path: str, img: np.ndarray) -> int:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    colour_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1).tobytes()
    out = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)
    return 1


# ------------------------------------------------------------------ PNG read

def _defilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    raw = raw.reshape(h, 1 + stride)
    filters = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    for y in range(h):
        f = filters[y]
        line = data[y].copy()
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if f == 0:
            out[y] = line
        elif f == 1:  # Sub
            for x in range(stride):
                a = out[y, x - c] if x >= c else 0
                out[y, x] = (line[x] + a) & 0xFF
        elif f == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif f == 3:  # Average
            for x in range(stride):
                a = out[y, x - c] if x >= c else 0
                out[y, x] = (line[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                a = out[y, x - c] if x >= c else 0
                b = prev[x]
                pc = prev[x - c] if x >= c else 0
                p = a + b - pc
                pa, pb, pcd = abs(p - a), abs(p - b), abs(p - pc)
                pred = a if (pa <= pb and pa <= pcd) else (b if pb <= pcd else pc)
                out[y, x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
    return out.astype(np.uint8).reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = colour_type = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, colour_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    c = {0: 1, 2: 3, 4: 2, 6: 4}[colour_type]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return _defilter(raw, h, w, c)


# ----------------------------------------------------------------------- TGA

def write_tga(path: str, img: np.ndarray) -> int:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                         8 * c, 0x20)  # 0x20: top-left origin
    bgr = img[:, :, ::-1] if c >= 3 else img
    with open(path, "wb") as f:
        f.write(header + bgr.tobytes())
    return 1


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    (idlen, cmap_type, img_type, _, _, _, _, _, w, h, bpp,
     desc) = struct.unpack_from("<BBBHHBHHHHBB", data, 0)
    if img_type != 2 or cmap_type != 0:
        raise ValueError("only uncompressed truecolor TGA supported")
    c = bpp // 8
    off = 18 + idlen
    img = np.frombuffer(data, np.uint8, h * w * c, off).reshape(h, w, c)
    img = img[:, :, ::-1] if c >= 3 else img  # BGR(A) -> RGB(A)
    if not (desc & 0x20):  # bottom-left origin -> flip
        img = img[::-1]
    return np.ascontiguousarray(img)


# ----------------------------------------------------------------------- BMP

def write_bmp(path: str, img: np.ndarray) -> int:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c == 1:
        img = np.repeat(img, 3, axis=2)
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    data_size = (row_bytes + pad) * h
    header = struct.pack("<2sIHHI", b"BM", 54 + data_size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                       2835, 2835, 0, 0)
    bgr = img[:, :, ::-1]  # BMP stores BGR, bottom-up
    padding = b"\x00" * pad
    body = b"".join(bgr[y].tobytes() + padding for y in range(h - 1, -1, -1))
    with open(path, "wb") as f:
        f.write(header + info + body)
    return 1


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    hdr_size, w, h = struct.unpack_from("<Iii", data, 14)
    (bpp,) = struct.unpack_from("<H", data, 28)
    if bpp != 24:
        raise ValueError("only 24-bit BMP supported")
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    rows = []
    pos = offset
    for _ in range(abs(h)):
        rows.append(np.frombuffer(data, np.uint8, row_bytes, pos).reshape(w, 3))
        pos += row_bytes + pad
    img = np.stack(rows)
    if h > 0:
        img = img[::-1]  # bottom-up -> top-down
    return np.ascontiguousarray(img[:, :, ::-1])


# ------------------------------------------------------------------ dispatch

def read_jpg(path: str) -> np.ndarray:
    """JPEG decode (stb_image handles JPG for ImageTexture,
    texture.cpp:30-51). Baseline/extended-sequential streams decode
    dependency-free (io/jpeg.py); progressive (SOF2) falls back to Pillow
    when importable, else raises (the texture layer degrades to debug
    cyan exactly like a missing file, texture.cpp:56-57)."""
    from . import jpeg as jpeg_mod
    try:
        return jpeg_mod.read_jpeg(path)
    except ValueError as native_err:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"JPEG decode failed ({native_err}) and Pillow is not "
                f"available for fallback: {path}") from native_err
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)


def read_image(path: str) -> np.ndarray:
    """Decode by extension -> (H,W,C) uint8, like stbi_load.

    Raises on unknown/corrupt files; callers replicate the reference's
    missing-texture degradation (debug cyan, texture.cpp:56-57).
    """
    p = path.lower()
    if p.endswith(".png"):
        return read_png(path)
    if p.endswith(".tga"):
        return read_tga(path)
    if p.endswith(".bmp"):
        return read_bmp(path)
    if p.endswith(".jpg") or p.endswith(".jpeg"):
        return read_jpg(path)
    if p.endswith(".hdr"):
        from . import hdr
        rgb = hdr.read_hdr(path)
        return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    # stb_image's remaining decode matrix (io/extra_formats.py)
    if p.endswith((".ppm", ".pgm", ".pbm", ".pnm")):
        from .extra_formats import read_pnm
        return read_pnm(path)
    if p.endswith(".psd"):
        from .extra_formats import read_psd
        return read_psd(path)
    if p.endswith(".gif"):
        from .extra_formats import read_gif
        return read_gif(path)
    raise ValueError(f"unsupported image format: {path}")
