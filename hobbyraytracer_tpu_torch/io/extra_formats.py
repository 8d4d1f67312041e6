"""Dependency-free decoders for stb_image's remaining formats.

A copy of hobbyraytracer_tpu/io/extra_formats.py, faults included (the RLE
branch of decode_psd reads 16-bit channels as 8-bit rows), so that both packages decode the same files
to the same arrays.

The reference's texture loader accepts everything stb_image decodes
(dependencies/stb/stb/stb_image.h; call site texture.cpp:30-51). With
PNG/TGA/BMP/HDR (io/images.py, io/hdr.py) and JPEG (io/jpeg.py) covered,
this module closes the rest of stb's decode matrix:

- PNM: PBM/PGM/PPM, ascii (P1-P3) and binary (P4-P6), 8- and 16-bit
  maxval (16-bit scaled down to 8, like stbi_load's default path)
- PSD: Photoshop composite image, 8- or 16-bit RGB/RGBA/grayscale,
  RAW (compression 0) and RLE/PackBits (compression 1) — the same
  subset stb's stbi__psd_load handles
- GIF: GIF87a/89a, first frame, LZW decode, local/global palettes,
  interlacing, transparency index -> opaque black (stb composites the
  first frame the same way)

All return (H, W, 3) uint8 row-major, row 0 at top (stb convention, as
io/images.py). Not perf-critical (SURVEY.md #32): textures decode once
on the host at scene load.
"""
from __future__ import annotations

import struct

import numpy as np


# ----------------------------------------------------------------------- PNM

def decode_pnm(data: bytes) -> np.ndarray:
    if len(data) < 2 or data[0:1] != b"P" or data[1] not in b"123456":
        raise ValueError("not a PNM (P1-P6) file")
    kind = int(chr(data[1]))

    # header tokens: magic, width, height, [maxval]; '#' comments to EOL
    pos = 2
    tokens = []
    need = 2 if kind in (1, 4) else 3
    while len(tokens) < need:
        if pos >= len(data):
            raise ValueError("truncated PNM header")
        c = data[pos]
        if c in b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
        elif c in b" \t\r\n":
            pos += 1
        else:
            start = pos
            while pos < len(data) and data[pos] not in b" \t\r\n#":
                pos += 1
            tokens.append(int(data[start:pos]))
    w, h = tokens[0], tokens[1]
    maxval = tokens[2] if need == 3 else 1
    if kind in (1, 2, 3):                       # ascii
        vals = np.array(data[pos:].split(), np.int32)
    else:                                       # binary: one ws after header
        pos += 1
        if kind == 4:                           # 1 bit/pixel, row-padded
            row_bytes = (w + 7) // 8
            raw = np.frombuffer(data, np.uint8, h * row_bytes, pos)
            bits = np.unpackbits(raw.reshape(h, row_bytes), axis=1)[:, :w]
            vals = bits.astype(np.int32).reshape(-1)
        elif maxval > 255:
            n = w * h * (3 if kind == 6 else 1)
            vals = np.frombuffer(data, ">u2", n, pos).astype(np.int32)
        else:
            n = w * h * (3 if kind == 6 else 1)
            vals = np.frombuffer(data, np.uint8, n, pos).astype(np.int32)
    channels = 3 if kind in (3, 6) else 1
    vals = vals[:w * h * channels]
    if kind in (1, 4):                          # bitmap: 1 = black
        img = np.where(vals == 1, 0, 255).astype(np.uint8)
    else:
        img = (vals * 255 // max(maxval, 1)).clip(0, 255).astype(np.uint8)
    img = img.reshape(h, w, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=2)
    return img


# ----------------------------------------------------------------------- PSD

def _unpack_rle(data: bytes, pos: int, expected: int) -> np.ndarray:
    """PackBits decode of one scanline run."""
    out = np.empty(expected, np.uint8)
    o = 0
    while o < expected:
        n = data[pos]
        pos += 1
        if n < 128:                             # copy n+1 literal bytes
            cnt = n + 1
            out[o:o + cnt] = np.frombuffer(data, np.uint8, cnt, pos)
            pos += cnt
            o += cnt
        elif n > 128:                           # repeat next byte 257-n
            cnt = 257 - n
            out[o:o + cnt] = data[pos]
            pos += 1
            o += cnt
        # n == 128: no-op
    return out


def decode_psd(data: bytes) -> np.ndarray:
    if data[:4] != b"8BPS":
        raise ValueError("not a PSD file")
    version, = struct.unpack_from(">H", data, 4)
    if version != 1:
        raise ValueError(f"unsupported PSD version {version}")
    channels, h, w, depth, mode = struct.unpack_from(">HIIHH", data, 12)
    if depth not in (8, 16):
        raise ValueError(f"unsupported PSD depth {depth}")
    if mode not in (1, 3):                      # grayscale / RGB
        raise ValueError(f"unsupported PSD color mode {mode}")
    pos = 26
    for _ in range(3):                          # skip colour-mode data,
        ln, = struct.unpack_from(">I", data, pos)   # resources, layers
        pos += 4 + ln
    compression, = struct.unpack_from(">H", data, pos)
    pos += 2
    n_px = w * h
    planes = []
    if compression == 0:                        # raw planar
        for c in range(channels):
            if depth == 16:
                p = (np.frombuffer(data, ">u2", n_px, pos) >> 8).astype(
                    np.uint8)
                pos += 2 * n_px
            else:
                p = np.frombuffer(data, np.uint8, n_px, pos)
                pos += n_px
            planes.append(p.reshape(h, w))
    elif compression == 1:                      # RLE (8-bit rows only)
        counts = np.frombuffer(data, ">u2", channels * h, pos).astype(int)
        pos += 2 * channels * h
        ci = 0
        for c in range(channels):
            rows = []
            for y in range(h):
                rows.append(_unpack_rle(data, pos, w))
                pos += counts[ci]
                ci += 1
            planes.append(np.stack(rows))
    else:
        raise ValueError(f"unsupported PSD compression {compression}")
    if mode == 1:                               # grayscale
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    return np.stack(planes[:3], axis=2)         # drop alpha like req_comp=3


# ----------------------------------------------------------------------- GIF

def _lzw_decode(min_code_size: int, data: bytes, max_px: int) -> np.ndarray:
    """GIF LZW: decode the concatenated sub-block payload to indices."""
    clear = 1 << min_code_size
    end = clear + 1
    dictionary = [bytes([i]) for i in range(clear)] + [b"", b""]
    code_size = min_code_size + 1
    out = bytearray()
    prev = None
    acc = 0
    nbits = 0
    pos = 0
    while pos < len(data) and len(out) < max_px:
        acc |= data[pos] << nbits               # LSB-first packing
        nbits += 8
        pos += 1
        while nbits >= code_size and len(out) < max_px:
            code = acc & ((1 << code_size) - 1)
            acc >>= code_size
            nbits -= code_size
            if code == clear:
                dictionary = dictionary[:clear + 2]
                code_size = min_code_size + 1
                prev = None
                continue
            if code == end:
                return np.frombuffer(bytes(out), np.uint8)
            if prev is None:
                entry = dictionary[code]
            elif code < len(dictionary):
                entry = dictionary[code]
                dictionary.append(prev + entry[:1])
            else:                               # KwKwK case
                entry = prev + prev[:1]
                dictionary.append(entry)
            out += entry
            prev = entry
            if (len(dictionary) == (1 << code_size)
                    and code_size < 12):
                code_size += 1
    return np.frombuffer(bytes(out), np.uint8)


def decode_gif(data: bytes) -> np.ndarray:
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gpal = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gpal = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n
    transparent = -1
    while pos < len(data):
        b = data[pos]
        if b == 0x21:                           # extension
            label = data[pos + 1]
            pos += 2
            if label == 0xF9:                   # graphic control
                sz = data[pos]
                gflags = data[pos + 1]
                if gflags & 1:
                    transparent = data[pos + 4]
                pos += 1 + sz
            while data[pos] != 0:               # skip sub-blocks
                pos += 1 + data[pos]
            pos += 1
        elif b == 0x2C:                         # image descriptor
            ix, iy, iw, ih, iflags = struct.unpack_from("<HHHHB",
                                                        data, pos + 1)
            pos += 10
            pal = gpal
            if iflags & 0x80:
                n = 2 << (iflags & 7)
                pal = np.frombuffer(data, np.uint8, 3 * n,
                                    pos).reshape(n, 3)
                pos += 3 * n
            if pal is None:
                raise ValueError("GIF image without a palette")
            min_code = data[pos]
            pos += 1
            payload = bytearray()
            while data[pos] != 0:
                ln = data[pos]
                payload += data[pos + 1:pos + 1 + ln]
                pos += 1 + ln
            pos += 1
            idx = _lzw_decode(min_code, bytes(payload), iw * ih)
            if idx.size < iw * ih:
                idx = np.concatenate(
                    [idx, np.zeros(iw * ih - idx.size, np.uint8)])
            idx = idx.reshape(ih, iw)
            if iflags & 0x40:                   # interlaced
                de = np.empty_like(idx)
                rows = np.concatenate([np.arange(0, ih, 8),
                                       np.arange(4, ih, 8),
                                       np.arange(2, ih, 4),
                                       np.arange(1, ih, 2)])
                de[rows] = idx
                idx = de
            rgb = pal[np.minimum(idx, len(pal) - 1)]
            if transparent >= 0:                # first frame: opaque black
                rgb = np.where((idx == transparent)[:, :, None], 0, rgb)
            img = np.zeros((h, w, 3), np.uint8)
            img[iy:iy + ih, ix:ix + iw] = rgb[:h - iy, :w - ix]
            return img                          # first frame only
        elif b == 0x3B:                         # trailer
            break
        else:
            raise ValueError(f"corrupt GIF block {b:#x}")
    raise ValueError("GIF contains no image data")


def read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_pnm(f.read())


def read_psd(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_psd(f.read())


def read_gif(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gif(f.read())
