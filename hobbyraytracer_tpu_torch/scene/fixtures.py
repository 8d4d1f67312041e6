"""Generated scene assets.

A copy of hobbyraytracer_tpu/scene/fixtures.py: both write the
repository's assets/ byte for byte, and against the assets/ on disk (at
FIXTURE_VERSION) they write nothing. The reference's snapshot lacks its
LFS binaries (`teapot.obj`, `old_hall_4k.hdr`), so the fixture scenes use
deterministic procedural stand-ins generated on first use:
- assets/teapot.obj — teapot-class ~6.5k-tri mesh (procgen.teapot)
- assets/hall.hdr   — an equirectangular "hall" environment: sky gradient,
  warm ground bounce, and a few bright window panels for specular interest.
"""
from __future__ import annotations

import os

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets")


def hall_environment(width=512, height=256) -> np.ndarray:
    """(H,W,3) float32 linear radiance, equirect (u: azimuth, v: polar)."""
    v = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]  # 0=up pole
    u = np.linspace(0.0, 1.0, width, endpoint=False,
                    dtype=np.float32)[None, :]
    # sky: blue-grey gradient brightest at horizon
    sky_t = np.clip(v / 0.5, 0.0, 1.0)
    sky = ((1 - sky_t)[..., None] * np.array([0.35, 0.45, 0.70])
           + sky_t[..., None] * np.array([0.9, 0.85, 0.75]))
    # ground: warm bright bounce below the horizon — the big_shiny golden
    # (shiny teapot against the real old_hall_4k.hdr) reads ~0.56
    # tonemapped in its lower third, i.e. ~0.17 linear warm
    ground = np.broadcast_to(np.array([1.40, 1.10, 0.75]),
                             (height, width, 3)).copy()
    img = np.where((v < 0.52)[..., None], sky, ground).astype(np.float32)
    # window panels: 4 bright vertical rectangles around the azimuth
    for i, az in enumerate((0.10, 0.35, 0.60, 0.85)):
        mask = ((np.abs(((u - az + 0.5) % 1.0) - 0.5) < 0.035)
                & (v > 0.28) & (v < 0.50))
        img[mask] = np.array([18.0, 16.0, 13.0], np.float32) * (1.0 - 0.1 * i)
    # global ambient level calibrated so the teapot-box render's tonemapped
    # mean sits near the reference golden Utah-Teapot.png's (the original
    # old_hall_4k.hdr is a DARK interior hall; see tests/test_golden.py)
    return img * np.float32(0.14)


def sky_environment(width=512, height=256) -> np.ndarray:
    """(H,W,3) float32 linear equirect: bright blue daytime sky above a
    dim grey ground — the backdrop of the Awesome-Reflections golden
    (sampleImages/Awesome-Reflections.bmp: sky-white top, mirror floor).
    Sky level ~0.8 linear tonemaps to the golden's ~0.87 top-third."""
    v = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    up = np.clip(1.0 - v / 0.5, 0.0, 1.0)[..., None]     # 1 at zenith
    sky = (up * np.array([0.55, 0.68, 0.95])
           + (1 - up) * np.array([0.95, 0.97, 1.05])) * 0.85
    ground = np.broadcast_to(np.array([0.18, 0.18, 0.20]),
                             (height, width, 3))
    img = np.where((v < 0.5)[..., None],
                   np.broadcast_to(sky, (height, width, 3)),
                   ground).astype(np.float32)
    return np.ascontiguousarray(img)


# bump when a procedural generator changes so cached assets regenerate
FIXTURE_VERSION = 3


def ensure_assets(asset_dir: str = ASSET_DIR) -> dict:
    """Create the generated assets if missing or stale; returns paths."""
    os.makedirs(asset_dir, exist_ok=True)
    ver_path = os.path.join(asset_dir, ".fixture_version")
    stale = True
    if os.path.exists(ver_path):
        try:
            with open(ver_path) as fh:
                stale = int(fh.read().strip()) != FIXTURE_VERSION
        except ValueError:
            pass
    teapot_path = os.path.join(asset_dir, "teapot.obj")
    hires_path = os.path.join(asset_dir, "teapot_hires.obj")
    hall_path = os.path.join(asset_dir, "hall.hdr")
    sky_path = os.path.join(asset_dir, "sky.hdr")
    if not os.path.exists(teapot_path):
        from .procgen import ensure_asset_obj
        ensure_asset_obj(teapot_path, "teapot")
    if not os.path.exists(hires_path):
        from .procgen import ensure_asset_obj
        ensure_asset_obj(hires_path, "teapot_hires")
    if stale or not os.path.exists(hall_path):
        from ..io import hdr
        hdr.write_hdr(hall_path, hall_environment())
    if stale or not os.path.exists(sky_path):
        from ..io import hdr
        hdr.write_hdr(sky_path, sky_environment())
    if stale:
        with open(ver_path, "w") as fh:
            fh.write(str(FIXTURE_VERSION))
    return {"teapot": teapot_path, "teapot_hires": hires_path,
            "hall": hall_path, "sky": sky_path}
