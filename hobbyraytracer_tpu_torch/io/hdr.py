"""Radiance RGBE (.hdr) decode in numpy (read only).

Copy of the reader in hobbyraytracer_tpu/io/hdr.py: the "-Y H +X W"
orientation, flat and new-style RLE scanlines, decoded as stb does,
c = byte * 2^(e-128) / 256.
"""
from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 -> (..., 3) float32."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - 136.0), 0.0)  # 2^(e-128)/256
    return rgbe[..., :3] * scale[..., None]


def read_hdr(path: str) -> np.ndarray:
    """-> (H, W, 3) float32 linear RGB, row 0 = top."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode().split()
    pos = eol + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or not (
                buf[p] == 2 and buf[p + 1] == 2 and
                (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w):
            # flat scanlines for the whole rest
            flat = buf[p:p + (h - y) * w * 4]
            out[y:] = flat.reshape(h - y, w, 4)
            p += (h - y) * w * 4
            break
        p += 4
        for c in range(4):  # RLE per channel
            x = 0
            while x < w:
                count = int(buf[p])
                p += 1
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[p]
                    p += 1
                    x += count - 128
                else:  # literal
                    out[y, x:x + count, c] = buf[p:p + count]
                    p += count
                    x += count
    return _rgbe_to_float(out)
