"""The port's image codecs (io/images.py, io/jpeg.py, io/extra_formats.py,
io/hdr.py), its film outputs and its image textures against the JAX
package's, on the same files.

- Every decode gives the same array as the JAX package's (exact: dtype,
  shape and bytes), through read_image and through the format's own
  reader; every refusal raises the same exception type with the same
  message.
- Every writer writes the same bytes.
- The three faults the JAX package inherited from the reference are copied
  as they are and pinned here: read_jpg falls back to Pillow on a
  ValueError of io/jpeg.py only, a single-component JPEG scan takes the
  SOF's sampling factors for its MCU layout, and a 16-bit RLE PSD decodes
  its rows as 8-bit. Each test shows the port doing what the JAX package
  does on the same input.
- A scene with image textures (a named `image` texture and a path that
  `resolve` auto-creates) builds leaf for leaf as the JAX build does, and
  a file that cannot be read degrades to debug cyan in both.

Pillow only makes inputs (and is the JAX package's own fallback for
progressive JPEG, which the port shares).
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.io import extra_formats as jx
from hobbyraytracer_tpu.io import hdr as jhdr
from hobbyraytracer_tpu.io import images as jim
from hobbyraytracer_tpu.io import jpeg as jjpeg
from hobbyraytracer_tpu.ops import film as jfilm
from hobbyraytracer_tpu.ops import texture as jtex
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.io import extra_formats as px
from hobbyraytracer_tpu_torch.io import hdr as phdr
from hobbyraytracer_tpu_torch.io import images as pim
from hobbyraytracer_tpu_torch.io import jpeg as pjpeg
from hobbyraytracer_tpu_torch.ops import film as pfilm
from hobbyraytracer_tpu_torch.ops import texture as ptex
from hobbyraytracer_tpu_torch.scene import build_scene, convert, load_scene_desc

from _torch_parity import ROOT, assert_tree_close, jax_scene_arrays

torch.set_num_threads(2)

H, W = 13, 17


def _rgb(c=3, seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _smooth(seed=2):
    """Low-frequency RGB content (lossy codecs keep it close)."""
    from PIL import Image
    base = np.random.default_rng(seed).integers(0, 256, (4, 6, 3), np.uint8)
    return np.asarray(Image.fromarray(base).resize((97, 53),
                                                   Image.BILINEAR))


def _pillow(img, fmt, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------ input makers

def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _png(img, filters=(0, 1, 2, 3, 4), bit_depth=8, interlace=0,
         bad_filter=None) -> bytes:
    """A PNG whose rows cycle through `filters` (each row encoded with its
    filter from the raw values), its IDAT split in two chunks."""
    h, w, c = img.shape
    stride = w * c
    raw = img.reshape(h, stride).astype(np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        line = raw[y]
        up = raw[y - 1] if y else np.zeros(stride, np.int32)
        a = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if f == 0:
            enc = line
        elif f == 1:
            enc = line - a
        elif f == 2:
            enc = line - up
        elif f == 3:
            enc = line - ((a + up) >> 1)
        else:
            p = a + up - ul
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, ul))
            enc = line - pred
        tag = f if bad_filter is None or y != 1 else bad_filter
        rows.append(bytes([tag]) + (enc & 0xFF).astype(np.uint8).tobytes())
    z = zlib.compress(b"".join(rows))
    ct = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, ct, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"tEXt", b"Comment\x00made by a test")
            + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def _bmp_top_down(img) -> bytes:
    """A 24-bit BMP stored top-down (negative height)."""
    h, w, _ = img.shape
    pad = (4 - w * 3 % 4) % 4
    body = b"".join(img[y, :, ::-1].tobytes() + b"\0" * pad
                    for y in range(h))
    return (struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, len(body),
                          2835, 2835, 0, 0) + body)


def _psd(img, depth=8, rle=False, mode=3) -> bytes:
    """A PSD composite (Pillow cannot write PSD): planar RAW, or PackBits
    RLE with one literal byte a run (so that an 8-bit reader of a 16-bit
    row stops on a run boundary)."""
    h, w, c = img.shape
    head = (b"8BPS" + struct.pack(">H", 1) + b"\0" * 6
            + struct.pack(">HIIHH", c, h, w, depth, mode)
            + struct.pack(">I", 0) * 3)
    planes = [img[:, :, k] for k in range(c)]
    if depth == 16:
        planes = [(p.astype(">u2") * 257) for p in planes]
    if not rle:
        return head + struct.pack(">H", 0) + b"".join(
            p.astype(p.dtype).tobytes() for p in planes)
    rows = [b"".join(bytes([0, b]) for b in p[y].tobytes())
            for p in planes for y in range(h)]
    counts = b"".join(struct.pack(">H", len(r)) for r in rows)
    return head + struct.pack(">H", 1) + counts + b"".join(rows)


def _pnm_ascii(magic, img, maxval=255) -> bytes:
    h, w = img.shape[:2]
    head = f"P{magic}\n# a comment\n{w} {h}\n"
    if magic != 1:
        head += f"{maxval}\n"
    return (head + " ".join(str(int(v)) for v in img.ravel())
            + "\n").encode()


def _pnm16(img) -> bytes:
    h, w, c = img.shape
    magic = 6 if c == 3 else 5
    return (f"P{magic}\n{w} {h}\n65535\n".encode()
            + (img.astype(">u2") * 257 + 3).astype(">u2").tobytes())


def _gray_jpeg_2x2() -> bytes:
    """A grayscale baseline JPEG whose SOF declares 2x2 sampling for its one
    component. T.81 lays a single-component scan out one block an MCU
    whatever the factors; the reference's decoder takes the 2x2 MCU."""
    g = _smooth()[:32, :32, 0]
    data = bytearray(_pillow(g, "JPEG", quality=90))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 9] == 1 and data[sof + 11] == 0x11
    data[sof + 11] = 0x22
    return bytes(data)


def _cases():
    """name -> (extension, bytes) of every input the decoders take."""
    rgb, smooth = _rgb(), _smooth()
    cases = {
        "png_gray": (".png", _png(_rgb(1))),
        "png_gray_alpha": (".png", _png(_rgb(2))),
        "png_rgb": (".png", _png(rgb)),
        "png_rgba": (".png", _png(_rgb(4))),
        "png_paeth_only": (".png", _png(rgb, filters=(4,))),
        "png_pillow": (".png", _pillow(smooth, "PNG", optimize=True)),
        "tga_bottom_left": (".tga", _pillow(rgb, "TGA")),
        "tga_rgba": (".tga", _pillow(_rgb(4), "TGA")),
        "bmp_pillow": (".bmp", _pillow(rgb, "BMP")),
        "bmp_top_down": (".bmp", _bmp_top_down(rgb)),
        "jpg_444": (".jpg", _pillow(smooth, "JPEG", quality=90,
                                    subsampling=0)),
        "jpg_422": (".jpeg", _pillow(smooth, "JPEG", quality=90,
                                     subsampling=1)),
        "jpg_420": (".jpg", _pillow(smooth, "JPEG", quality=75,
                                    subsampling=2)),
        "jpg_gray": (".jpg", _pillow(smooth[:, :, 1], "JPEG", quality=85)),
        "jpg_restart": (".jpg", _pillow(smooth, "JPEG", quality=90,
                                        subsampling=0,
                                        restart_marker_blocks=2)),
        "jpg_progressive": (".jpg", _pillow(smooth, "JPEG", quality=90,
                                            progressive=True)),
        "jpg_gray_2x2": (".jpg", _gray_jpeg_2x2()),
        # an arithmetic-coding SOF: io/jpeg.py refuses it, Pillow reads it
        "jpg_sof9": (".jpg", _pillow(smooth, "JPEG").replace(
            b"\xff\xc0", b"\xff\xc9", 1)),
        "ppm_p6": (".ppm", _pillow(rgb, "PPM")),
        "pgm_p5": (".pgm", _pillow(rgb[:, :, 0], "PPM")),
        "pbm_p4": (".pbm", _pillow(_pil_bits(rgb), "PPM")),
        "pnm_p1": (".pbm", _pnm_ascii(1, rgb[:, :, 0] > 127)),
        "pnm_p2": (".pgm", _pnm_ascii(2, rgb[:, :, 0] // 2, maxval=127)),
        "pnm_p3": (".pnm", _pnm_ascii(3, rgb)),
        "pnm_p5_16": (".pgm", _pnm16(rgb[:, :, :1])),
        "pnm_p6_16": (".ppm", _pnm16(rgb)),
        "psd_raw8": (".psd", _psd(rgb)),
        "psd_raw16": (".psd", _psd(_rgb(4), depth=16)),
        "psd_rle8": (".psd", _psd(rgb, rle=True)),
        "psd_rle16": (".psd", _psd(rgb, depth=16, rle=True)),
        "psd_gray": (".psd", _psd(rgb[:, :, :1], mode=1)),
        "gif": (".gif", _pillow(rgb, "GIF")),
        "gif_interlaced": (".gif", _pillow(rgb, "GIF", interlace=True)),
        "gif_transparent": (".gif", _pillow(rgb, "GIF", transparency=0)),
    }
    return cases


def _pil_bits(rgb):
    from PIL import Image
    return Image.fromarray(rgb[:, :, 0] > 127).convert("1")


_CASE_FILES = _cases()
_CASES = sorted(_CASE_FILES)


def _write(tmp_path, name):
    ext, data = _CASE_FILES[name]
    path = str(tmp_path / (name + ext))
    with open(path, "wb") as f:
        f.write(data)
    return path


def _assert_same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                       b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


def _outcome(fn, *args):
    """('ok', array) or ('raise', exception type, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:   # the outcome under test, whatever it is
        return ("raise", type(e), str(e))


def _assert_same_outcome(port, jax):
    assert port[0] == jax[0], (port, jax)
    if port[0] == "ok":
        _assert_same_array(port[1], jax[1])
    else:
        assert port[1:] == jax[1:]


# ----------------------------------------------------------------- decoders

@pytest.mark.parametrize("name", _CASES)
def test_read_image_matches_jax(tmp_path, name):
    """read_image of every input, exact."""
    path = _write(tmp_path, name)
    got, ref = pim.read_image(path), jim.read_image(path)
    _assert_same_array(got, ref)
    assert got.dtype == np.uint8 and got.ndim == 3


@pytest.mark.parametrize("reader", [
    "images.read_png", "images.read_tga", "images.read_bmp",
    "images.read_jpg", "jpeg.read_jpeg", "extra_formats.read_pnm",
    "extra_formats.read_psd", "extra_formats.read_gif"])
def test_format_readers_match_jax(tmp_path, reader):
    """Each reader on every input of its format, and on the inputs of the
    other formats: the same array or the same exception."""
    mod, fn = reader.split(".")
    port = {"images": pim, "jpeg": pjpeg, "extra_formats": px}[mod]
    jax = {"images": jim, "jpeg": jjpeg, "extra_formats": jx}[mod]
    seen_ok = 0
    for name in _CASES:
        path = _write(tmp_path, name)
        got = _outcome(getattr(port, fn), path)
        _assert_same_outcome(got, _outcome(getattr(jax, fn), path))
        seen_ok += got[0] == "ok"
    assert seen_ok > 0


def test_hdr_reads_as_uint8_like_jax():
    """read_image of a Radiance file: clip(rgb * 255) as uint8."""
    for name in ("hall.hdr", "sky.hdr"):
        path = os.path.join(ROOT, "assets", name)
        _assert_same_array(pim.read_image(path), jim.read_image(path))


def _bad_inputs():
    rgb = _rgb()
    tga_rle = _pillow(rgb, "TGA", rle=True)
    return {
        "unknown.xyz": b"whatever",
        "not_png.png": b"GIF89a" + b"\0" * 40,
        "png16.png": _png(_rgb(3), bit_depth=16),
        "png_interlaced.png": _png(_rgb(3), interlace=1),
        "png_bad_filter.png": _png(_rgb(3), bad_filter=7),
        "tga_rle.tga": tga_rle,
        "bmp32.bmp": _pillow(_rgb(4), "BMP"),
        "not_bmp.bmp": b"XX" + b"\0" * 60,
        "jpeg_empty.jpg": b"",
        "psd_bad_version.psd": _psd(rgb).replace(b"8BPS\x00\x01",
                                                 b"8BPS\x00\x02", 1),
        "psd_depth4.psd": _psd(rgb)[:22] + struct.pack(">H", 4)
        + _psd(rgb)[24:],
        "not_psd.psd": b"8BPX" + b"\0" * 40,
        "not_pnm.ppm": b"P9\n1 1\n255\n\0\0\0",
        "not_gif.gif": b"GIF00a" + b"\0" * 20,
        "missing.png": None,
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_refusals_match_jax(tmp_path, name):
    """A file that the JAX package refuses, the port refuses with the same
    exception type and message (the missing file: the same OSError)."""
    data = _bad_inputs()[name]
    path = str(tmp_path / name)
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
    got = _outcome(pim.read_image, path)
    assert got[0] == "raise", name
    _assert_same_outcome(got, _outcome(jim.read_image, path))


# ------------------------------------------------------ the pinned faults

def test_jpeg_fallback_takes_value_errors_only(tmp_path):
    """images.py:199 (copied): read_jpg falls back to Pillow on a
    ValueError of io/jpeg.py only. A truncated stream raises another
    exception inside the decoder, which skips the fallback and leaves
    read_jpg in both packages with the same type; a progressive stream
    (ValueError) goes to Pillow in both."""
    data = _pillow(_smooth(), "JPEG", quality=90, subsampling=0)
    path = str(tmp_path / "cut.jpg")
    # the first cut (in the tables) at which the decoder raises another
    # exception than ValueError
    cut = next(n for n in range(16, len(data), 8)
               if _outcome(jjpeg.decode_jpeg, data[:n])[0] == "raise"
               and not issubclass(_outcome(jjpeg.decode_jpeg,
                                           data[:n])[1], ValueError))
    with open(path, "wb") as f:
        f.write(data[:cut])
    got, ref = _outcome(pim.read_jpg, path), _outcome(jim.read_jpg, path)
    assert got[0] == ref[0] == "raise"
    assert got[1] is ref[1] and not issubclass(got[1], ValueError)
    _assert_same_outcome(got, ref)
    prog = _write(tmp_path, "jpg_progressive")
    with pytest.raises(ValueError):
        pjpeg.read_jpeg(prog)
    _assert_same_array(pim.read_jpg(prog), jim.read_jpg(prog))


def test_jpeg_single_component_scan_layout_is_the_reference_s(tmp_path):
    """jpeg.py:233 (copied): a grayscale JPEG whose SOF declares 2x2
    sampling decodes with the 2x2 MCU layout, garbled against the same
    stream read as T.81 reads it (Pillow, at 1x1), in both packages
    alike."""
    from PIL import Image
    path = _write(tmp_path, "jpg_gray_2x2")
    got, ref = pim.read_image(path), jim.read_image(path)
    _assert_same_array(got, ref)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    sof = data.index(b"\xff\xc0")
    data[sof + 11] = 0x11
    right = np.asarray(Image.open(io.BytesIO(bytes(data))).convert("RGB"))
    assert got.shape == right.shape
    assert np.abs(got.astype(int) - right.astype(int)).max() > 32


def test_psd_16bit_rle_is_the_reference_s(tmp_path):
    """extra_formats.py:134 (copied): a 16-bit RLE PSD decodes its rows as
    8-bit, garbled against the image it holds, in both packages alike; the
    same image in 16-bit RAW decodes right."""
    rgb = _rgb()
    path = _write(tmp_path, "psd_rle16")
    got, ref = pim.read_image(path), jim.read_image(path)
    _assert_same_array(got, ref)
    assert not np.array_equal(got, rgb)
    raw = str(tmp_path / "raw16.psd")
    with open(raw, "wb") as f:
        f.write(_psd(rgb, depth=16))
    np.testing.assert_array_equal(pim.read_image(raw), rgb)


# ------------------------------------------------------------------ writers

@pytest.mark.parametrize("fmt,shape", [
    ("png", (H, W)), ("png", (H, W, 1)), ("png", (H, W, 2)),
    ("png", (H, W, 3)), ("png", (H, W, 4)), ("tga", (H, W, 3)),
    ("tga", (H, W, 4)), ("bmp", (H, W, 1)), ("bmp", (H, W, 3)),
    ("bmp", (4, 4, 3))])
def test_writers_match_jax_byte_for_byte(tmp_path, fmt, shape):
    """write_png / write_tga / write_bmp write the JAX package's bytes, and
    read back to the image (a one-channel BMP as grey RGB)."""
    img = np.random.default_rng(5).integers(0, 256, shape, np.uint8)
    a, b = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"j.{fmt}")
    assert getattr(pim, f"write_{fmt}")(a, img) == 1
    getattr(jim, f"write_{fmt}")(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = pim.read_image(a)
    want = img.reshape(shape[0], shape[1], -1)
    if fmt == "bmp" and want.shape[2] == 1:
        want = np.repeat(want, 3, axis=2)
    np.testing.assert_array_equal(back, want)


def test_write_hdr_matches_jax(tmp_path):
    """write_hdr (and its RGBE encoding) byte for byte, zeros, tiny and
    large values included; the file reads back within RGBE's precision."""
    rng = np.random.default_rng(6)
    img = (rng.random((9, 33, 3)) * 10.0).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = 1e-38
    img[2, 2] = (1e30, 5.0, 0.0)
    np.testing.assert_array_equal(phdr._float_to_rgbe(img),
                                  jhdr._float_to_rgbe(img))
    a, b = str(tmp_path / "p.hdr"), str(tmp_path / "j.hdr")
    assert phdr.write_hdr(a, img) == 1
    jhdr.write_hdr(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = phdr.read_hdr(a)
    tol = img[3:].max(axis=-1, keepdims=True) / 256.0 + 1e-4
    assert np.all(np.abs(back[3:] - img[3:]) <= tol)


@pytest.mark.parametrize("name", ["o.png", "o.tga", "o.bmp", "o.jpg",
                                  "o"])
def test_output_film_matches_jax(tmp_path, capsys, name):
    """output_film by extension: PNG, TGA, BMP, and any other name as a
    BMP with the reference's message; the same bytes and the same lines
    as the JAX package's."""
    img = np.random.default_rng(7).integers(0, 256, (6, 9, 3), np.uint8)
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    pdir.mkdir()
    jdir.mkdir()
    assert pfilm.output_film(img, str(pdir / name))
    out_p = capsys.readouterr().out.replace(str(pdir), "DIR")
    assert jfilm.output_film(img, str(jdir / name))
    out_j = capsys.readouterr().out.replace(str(jdir), "DIR")
    assert out_p == out_j
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    assert ("DIR/" + name in out_p) == (name not in ("o.png", "o.tga"))
    assert ("File type not supported" in out_p) == (name in ("o.jpg", "o"))


# ----------------------------------------------------------- image textures

_TEXTURE_SCENE = """
film: {{width: 16, height: 16, samples: 1, output: t.png}}
camera:
    position: [0, 2.5, 8.5]
    look_at: [0, 2.5, 0]
    up: [0, 1, 0]
    fov: 45
    aperture: 0.001
    focal_distance: 8.5
    background: [0.2, 0.3, 0.4]
textures:
  - {{name: board, type: image, path: {named}}}
  - {{name: gone, type: image, path: {missing}}}
materials:
  - {{name: wall, type: lambertian, albedo: board}}
  - {{name: floor, type: lambertian, albedo: {auto}}}
  - {{name: blank, type: metal, albedo: gone, roughness: {auto}}}
objects:
  - {{type: xy_rect, x: [-2.5, 2.5], y: [0, 5], k: -2.5, material: wall}}
  - {{type: xz_rect, x: [-2.5, 2.5], z: [-2.5, 2.5], k: 0, material: floor}}
  - {{type: sphere, center: [0, 1, 0], radius: 1, material: blank}}
"""


def _texture_scene(tmp_path):
    named = tmp_path / "board.png"
    pim.write_png(str(named), _rgb(3, seed=8, h=6, w=10))
    auto = tmp_path / "floor.tga"
    pim.write_tga(str(auto), _rgb(3, seed=9, h=5, w=7))
    path = tmp_path / "textured.yaml"
    path.write_text(_TEXTURE_SCENE.format(
        named="board.png", missing="no_such.png", auto="floor.tga"))
    return str(path)


def test_image_texture_scene_builds_as_jax(tmp_path, capsys):
    """Named image textures and a path that `resolve` auto-creates (for an
    albedo and a roughness) load as 8-bit / 255: the scene, the texture
    atlas included, leaf for leaf as the JAX build (exact), and the same
    "Loaded image file" / "ERROR: Could not load image file" lines."""
    path = _texture_scene(tmp_path)
    job_p = build_scene(load_scene_desc(path))
    out_p = capsys.readouterr().out
    job_j = jax_build_scene(jax_load_scene_desc(path))
    out_j = capsys.readouterr().out
    assert out_p == out_j
    assert "Loaded image file: board.png" in out_p
    assert "Loaded image file: floor.tga" in out_p
    assert "ERROR: Could not load image file: no_such.png" in out_p
    arr_p = convert.scene_to_arrays(job_p.scene)
    arr_j = jax_scene_arrays(job_j.scene)
    assert_tree_close(arr_p, arr_j, atol=0.0)
    tex = arr_p["textures"]
    assert int((tex["ttype"] == jtex.TEX_IMAGE).sum()) == 3
    assert int((tex["width"] > 0).sum()) >= 2
    board = _rgb(3, seed=8, h=6, w=10).astype(np.float32) / 255.0
    assert np.isin(board, tex["atlas"]).all()


def test_missing_image_degrades_to_cyan_as_jax(tmp_path):
    """colour_value of the texture whose file is missing: debug cyan in
    both packages; the loaded ones are not cyan."""
    import jax.numpy as jnp

    from hobbyraytracer_tpu.ops import texture as jtex_ops
    path = _texture_scene(tmp_path)
    job_p = build_scene(load_scene_desc(path))
    job_j = jax_build_scene(jax_load_scene_desc(path))
    n = job_p.scene.textures.ttype.shape[0]
    ids = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(10)
    u, v = (rng.random(n).astype(np.float32) for _ in range(2))
    p = rng.random((n, 3)).astype(np.float32)
    c_p = ptex.colour_value(job_p.scene.textures, torch.from_numpy(ids),
                            torch.from_numpy(u), torch.from_numpy(v),
                            torch.from_numpy(p)).numpy()
    c_j = np.asarray(jtex_ops.colour_value(
        job_j.scene.textures, jnp.asarray(ids), jnp.asarray(u),
        jnp.asarray(v), jnp.asarray(p)))
    np.testing.assert_allclose(c_p, c_j, rtol=1e-6, atol=1e-7)
    tt = job_p.scene.textures.ttype.numpy()
    width = job_p.scene.textures.width.numpy()
    cyan = np.asarray(ptex.DEBUG_CYAN, np.float32)
    for i in np.nonzero(tt == ptex.TEX_IMAGE)[0]:
        assert np.array_equal(c_p[i], cyan) == (width[i] == 0), i
    assert (width[tt == ptex.TEX_IMAGE] == 0).sum() == 1
