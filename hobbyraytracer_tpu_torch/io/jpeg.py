"""Dependency-free baseline JPEG decoder (stb_image decode-breadth parity).

A copy of hobbyraytracer_tpu/io/jpeg.py, faults included (the MCU layout
of a single-component scan in _decode_scan), so that both packages decode the
same files to the same arrays.

The reference's texture loader accepts JPEG through stb_image
(dependencies/stb/stb/stb_image.h — stb decodes baseline + progressive
JPEG natively; texture.cpp:30-51 is the call site). This module decodes,
without Pillow, the format class stb actually ships in practice:

- baseline sequential DCT (SOF0) and extended sequential (SOF1),
  8-bit samples, Huffman entropy coding
- 1 component (grayscale) or 3 components (JFIF YCbCr), any sampling
  factors up to 4 (4:4:4, 4:2:2, 4:2:0, ...)
- restart intervals (DRI / RSTn), 16-bit quantization tables,
  0xFF00 byte stuffing, trailing-garbage tolerance

Progressive (SOF2) and arithmetic-coded (SOF9+) streams raise
ValueError — callers (io/images.read_jpg) fall back to Pillow when it is
importable, else degrade exactly like a missing texture (debug cyan,
texture.cpp:56-57).

Decode pipeline: marker parse -> per-MCU Huffman decode (pure python
bit reader; texture decode is host-side and not perf-critical, SURVEY.md
#32) -> vectorized numpy dequantize + de-zigzag + 8x8 IDCT (one einsum
over all blocks of a component) -> plane assembly -> chroma upsample ->
JFIF YCbCr->RGB.
"""
from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# orthonormal 8-point DCT-II basis: IDCT(X) = C.T @ X @ C
_C = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos(np.pi * (2 * _n + 1) * _k / 16.0) * (
            np.sqrt(0.125) if _k == 0 else 0.5)


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment with 0xFF00
    unstuffing; stops (returns -1 forever) at any real marker."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None  # marker byte that ended the segment

    def _fill(self) -> bool:
        d = self.data
        p = self.pos
        if p >= len(d):
            return False
        b = d[p]
        if b == 0xFF:
            if p + 1 < len(d) and d[p + 1] == 0x00:
                self.pos = p + 2            # stuffed literal 0xFF
            else:
                self.marker = d[p + 1] if p + 1 < len(d) else 0xD9
                return False                # real marker: stop
        else:
            self.pos = p + 1
        self.acc = (self.acc << 8) | b
        self.nbits += 8
        return True

    def bit(self) -> int:
        if self.nbits == 0 and not self._fill():
            return 0  # past-the-end padding bits are legal (spec F.2.2.5)
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align_restart(self) -> None:
        """Byte-align and consume one RSTn marker (between restart
        intervals)."""
        self.nbits = 0
        self.acc = 0
        d = self.data
        p = self.pos
        while p + 1 < len(d):
            if d[p] == 0xFF and 0xD0 <= d[p + 1] <= 0xD7:
                self.pos = p + 2
                return
            p += 1
        self.pos = p


class _Huffman:
    """Canonical JPEG Huffman table -> (maxcode/valptr) fast decoder
    (ITU T.81 F.2.2.3)."""

    def __init__(self, counts, symbols):
        self.symbols = symbols
        code = 0
        k = 0
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        for ln in range(1, 17):
            self.valptr[ln] = k
            self.mincode[ln] = code
            n = counts[ln - 1]
            code += n
            k += n
            self.maxcode[ln] = code - 1
            code <<= 1

    def decode(self, br: _BitReader) -> int:
        code = br.bit()
        ln = 1
        while ln < 17:
            if code <= self.maxcode[ln]:
                return self.symbols[self.valptr[ln]
                                    + (code - self.mincode[ln])]
            code = (code << 1) | br.bit()
            ln += 1
        raise ValueError("corrupt JPEG: bad Huffman code")


def _extend(v: int, n: int) -> int:
    """DC/AC value extension (T.81 F.2.2.1): n-bit magnitude to signed."""
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def decode_jpeg(data: bytes) -> np.ndarray:
    """bytes -> (H, W, 3) RGB uint8 (grayscale replicated to 3 channels,
    like stbi_load with req_comp=3)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}            # id -> (64,) int32 natural-order quant table
    huff_dc = {}
    huff_ac = {}
    comps = None       # list of dicts: id, h, v, tq
    w = h = 0
    restart_interval = 0
    out_blocks = None

    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1  # tolerate fill bytes
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2:pos + seglen]
        pos += seglen

        if marker == 0xDB:  # DQT
            bp = 0
            while bp < len(body):
                pq, tq = body[bp] >> 4, body[bp] & 0xF
                bp += 1
                if pq:
                    tab = np.frombuffer(body, ">u2", 64, bp).astype(np.int32)
                    bp += 128
                else:
                    tab = np.frombuffer(body, np.uint8, 64, bp).astype(
                        np.int32)
                    bp += 64
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG] = tab
                qt[tq] = nat
        elif marker == 0xC4:  # DHT
            bp = 0
            while bp < len(body):
                tc, th = body[bp] >> 4, body[bp] & 0xF
                counts = list(body[bp + 1:bp + 17])
                n = sum(counts)
                symbols = list(body[bp + 17:bp + 17 + n])
                (huff_dc if tc == 0 else huff_ac)[th] = _Huffman(
                    counts, symbols)
                bp += 17 + n
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", body, 0)
        elif marker in (0xC0, 0xC1):  # SOF0 baseline / SOF1 ext sequential
            prec, h, w, nc = struct.unpack_from(">BHHB", body, 0)
            if prec != 8:
                raise ValueError(f"unsupported JPEG precision {prec}")
            comps = []
            for i in range(nc):
                cid, hv, tq_i = struct.unpack_from(">BBB", body, 6 + 3 * i)
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 0xF,
                              "tq": tq_i})
        elif marker == 0xC2:
            raise ValueError("progressive JPEG (SOF2) not supported by the "
                             "pure-python decoder")
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"unsupported JPEG SOF marker {marker:#x}")
        elif marker == 0xDA:  # SOS -> entropy-coded segment follows
            if comps is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            ns = body[0]
            scan = []
            for i in range(ns):
                cs, tdta = body[1 + 2 * i], body[2 + 2 * i]
                comp = next(c for c in comps if c["id"] == cs)
                scan.append((comp, huff_dc[tdta >> 4], huff_ac[tdta & 0xF]))
            out_blocks, pos = _decode_scan(data, pos, scan, w, h,
                                           restart_interval)
            break  # one scan = the whole image for sequential JPEG

    if out_blocks is None or not w:
        raise ValueError("corrupt JPEG: no image data")
    return _assemble(out_blocks, comps, qt, w, h)


def _decode_scan(data, pos, scan, w, h, restart_interval):
    """Huffman-decode every MCU of a sequential scan.
    Returns ({comp_id: (rows, cols, 64) int32 zigzag coeffs}, end_pos)."""
    hmax = max(c["h"] for c, _, _ in scan)
    vmax = max(c["v"] for c, _, _ in scan)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    planes = {}
    for c, _, _ in scan:
        planes[c["id"]] = np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                   np.int32)
    br = _BitReader(data, pos)
    pred = {c["id"]: 0 for c, _, _ in scan}
    n_mcu = mcux * mcuy
    for m in range(n_mcu):
        if restart_interval and m and m % restart_interval == 0:
            br.align_restart()
            for k in pred:
                pred[k] = 0
        my, mx = divmod(m, mcux)
        for c, hdc, hac in scan:
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    blk = planes[c["id"]][my * c["v"] + by,
                                          mx * c["h"] + bx]
                    t = hdc.decode(br)
                    diff = _extend(br.bits(t), t) if t else 0
                    pred[c["id"]] += diff
                    blk[0] = pred[c["id"]]
                    k = 1
                    while k < 64:
                        rs = hac.decode(br)
                        r, s = rs >> 4, rs & 0xF
                        if s == 0:
                            if r == 15:  # ZRL: 16 zeros
                                k += 16
                                continue
                            break        # EOB
                        k += r
                        if k > 63:
                            raise ValueError("corrupt JPEG: AC overrun")
                        blk[k] = _extend(br.bits(s), s)
                        k += 1
    return planes, br.pos


def _assemble(planes, comps, qt, w, h):
    """Dequantize + IDCT every component (vectorized), upsample chroma,
    convert to RGB."""
    out = []
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    for c in comps:
        z = planes[c["id"]]                                # (R, C, 64)
        rows, cols = z.shape[:2]
        nat = np.zeros_like(z)
        nat[:, :, ZIGZAG] = z
        nat = nat * qt[c["tq"]][None, None, :]
        blocks = nat.reshape(rows, cols, 8, 8).astype(np.float64)
        # IDCT: C.T @ X @ C for every block at once
        pix = np.einsum("ij,rcjk,kl->rcil", _C.T, blocks, _C) + 128.0
        plane = pix.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        # upsample to full resolution (nearest, like stb's fast path)
        plane = np.repeat(np.repeat(plane, vmax // c["v"], axis=0),
                          hmax // c["h"], axis=1)
        out.append(plane[:h, :w])
    if len(out) == 1:
        g = np.clip(np.round(out[0]), 0, 255).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    if len(out) != 3:
        raise ValueError(f"unsupported JPEG component count {len(out)}")
    y, cb, cr = out[0], out[1] - 128.0, out[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=2)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
