"""The scene as the reference renders it, read from the frozen YAML, OBJ and
HDR files: axis-aligned rects, transformed triangle meshes, lambertian,
metal and diffuse-light materials with constant parameters, and an
environment map (or a solid colour) as the background.

Everything the program derives from these files is derived here again:
the material rows (row 0 the default lambertian), the rect rows, each
mesh's corner arrays, its instance transform (a quaternion from Euler
angles, in float32 on the CPU) and its own clusters for the find, and the
camera basis. A feature outside that set raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import yaml

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIFFUSE_LIGHT = 3
_MTYPE = {"lambertian": MAT_LAMBERTIAN, "metal": MAT_METAL,
          "diffuse_light": MAT_DIFFUSE_LIGHT}
_RECT_AXIS = {"yz_rect": (0, "y", "z"), "xz_rect": (1, "x", "z"),
              "xy_rect": (2, "x", "y")}
MAT_FIELDS = ("albedo", "roughness", "strength", "ior", "metallness")
LEAF = 128


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE file -> (H, W, 3) float32, row 0 the top, as stb
    decodes it: byte * 2^(e - 136)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
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
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or not (
                buf[p] == 2 and buf[p + 1] == 2
                and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w):
            out[y:] = buf[p:p + (h - y) * w * 4].reshape(h - y, w, 4)
            break
        p += 4
        for c in range(4):
            x = 0
            while x < w:
                count = int(buf[p])
                p += 1
                if count > 128:
                    out[y, x:x + count - 128, c] = buf[p]
                    p += 1
                    x += count - 128
                else:
                    out[y, x:x + count, c] = buf[p:p + count]
                    p += count
                    x += count
    rgbe = out.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - 136.0), 0.0)
    return rgbe[..., :3] * scale[..., None]


def read_obj(path: str) -> dict:
    """Wavefront OBJ -> verts (V, 3), normals (V, 3), uvs (V, 2) float32
    and indices (T, 3) int32: one vertex per distinct (v, vt, vn) corner in
    first-use order, polygons as fans, V flipped, missing attributes 0."""
    pos, nrm, uv = [], [], []
    corner_of, out_v, out_n, out_t, tris = {}, [], [], [], []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                pos.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                nrm.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                t = np.float32(parts[2]) if len(parts) > 2 else np.float32(0)
                uv.append([np.float32(parts[1]), np.float32(1.0) - t])
            elif tag == "f":
                ids = []
                for tok in parts[1:]:
                    f3 = (tok.split("/") + ["", ""])[:3]
                    key = tuple(
                        (int(s) - 1 if int(s) > 0 else n + int(s))
                        if s else -1
                        for s, n in zip(f3, (len(pos), len(uv), len(nrm))))
                    if key not in corner_of:
                        corner_of[key] = len(out_v)
                        out_v.append(pos[key[0]])
                        out_t.append(uv[key[1]] if key[1] >= 0 else [0, 0])
                        out_n.append(nrm[key[2]] if key[2] >= 0
                                     else [0, 0, 0])
                    ids.append(corner_of[key])
                for i in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[i], ids[i + 1]))
    if not tris:
        raise ValueError(f"{path}: no faces")
    return {"verts": np.asarray(out_v, np.float32),
            "normals": np.asarray(out_n, np.float32),
            "uvs": np.asarray(out_t, np.float32),
            "indices": np.asarray(tris, np.int32)}


def _adjust_heap(a, hole, n, value, less):
    top, child = hole, hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if less(a[child], a[child - 1]):
            child -= 1
        a[hole] = a[child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        a[hole] = a[child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and less(a[parent], value):
        a[hole] = a[parent]
        hole = parent
        parent = (hole - 1) // 2
    a[hole] = value


def _heap_sort(a, lo, hi, less):
    """__partial_sort(lo, hi, hi): make_heap, then sort_heap."""
    view = a[lo:hi]
    n = len(view)
    for parent in range((n - 2) // 2, -1, -1):
        _adjust_heap(view, parent, n, view[parent], less)
    for last in range(n - 1, 0, -1):
        value = view[last]
        view[last] = view[0]
        _adjust_heap(view, 0, last, value, less)
    a[lo:hi] = view


def std_sort(a: list, less) -> None:
    """libstdc++'s std::sort (introsort: median-of-three pivot, unguarded
    partition, heap sort past 2 log2 n levels, insertion sort below 16),
    in place, step for step, so that equal keys end in the same order."""
    def median_to_first(r, x, y, z):
        if less(a[x], a[y]):
            m = y if less(a[y], a[z]) else (z if less(a[x], a[z]) else x)
        else:
            m = x if less(a[x], a[z]) else (z if less(a[y], a[z]) else y)
        a[r], a[m] = a[m], a[r]

    def loop(lo, hi, depth):
        while hi - lo > 16:
            if depth == 0:
                _heap_sort(a, lo, hi, less)
                return
            depth -= 1
            median_to_first(lo, lo + 1, lo + (hi - lo) // 2, hi - 1)
            i, j = lo + 1, hi
            while True:
                while less(a[i], a[lo]):
                    i += 1
                j -= 1
                while less(a[lo], a[j]):
                    j -= 1
                if not i < j:
                    break
                a[i], a[j] = a[j], a[i]
                i += 1
            loop(i, hi, depth)
            hi = i

    def insert(i, guarded_lo):
        v = a[i]
        if guarded_lo is not None and less(v, a[guarded_lo]):
            a[guarded_lo + 1:i + 1] = a[guarded_lo:i]
            a[guarded_lo] = v
            return
        j = i - 1
        while less(v, a[j]):
            a[j + 1] = a[j]
            j -= 1
        a[j + 1] = v

    n = len(a)
    if n < 2:
        return
    loop(0, n, 2 * (n.bit_length() - 1))
    for i in range(1, min(n, 16)):
        insert(i, 0)
    for i in range(16, n):
        insert(i, None)


def clusters(verts: np.ndarray, indices: np.ndarray) -> list:
    """Triangle ids in groups of at most LEAF, in the order a constrained
    surface-area split makes them (each node picks the axis and the cut, a
    multiple of LEAF, of least SA(left) n_left + SA(right) n_right over the
    triangles sorted by centroid; ties in float32 as the host builder of
    the renderer keeps them), so that the find meets the triangles in the
    renderer's order and exact ties in t resolve alike."""
    tri = verts[indices]                                  # (T, 3, 3)
    cent = ((tri[:, 0] + tri[:, 1]) + tri[:, 2]) / np.float32(3)
    tlo, thi = tri.min(axis=1), tri.max(axis=1)
    order = list(range(len(tri)))
    out = []

    def surface(lo, hi):
        e = hi - lo
        return np.float32(2) * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                                + e[:, 0] * e[:, 2])

    stack = [(0, len(tri))]
    while stack:
        b, e = stack.pop()
        n = e - b
        if n <= LEAF:
            out.append(np.asarray(order[b:e], np.int64))
            continue
        best = (np.float32(1e38), b + n // 2, None)
        cuts = np.arange(LEAF, n, LEAF)
        for ax in range(3):
            key = cent[:, ax].tolist()
            s = order[b:e]
            std_sort(s, lambda p, q, key=key: key[p] < key[q])
            ids = np.asarray(s)
            sa_l = surface(np.minimum.accumulate(tlo[ids]),
                           np.maximum.accumulate(thi[ids]))
            sa_r = surface(np.minimum.accumulate(tlo[ids][::-1]),
                           np.maximum.accumulate(thi[ids][::-1]))[::-1]
            cost = (sa_l[cuts - 1] * cuts.astype(np.float32)
                    + sa_r[cuts] * (n - cuts).astype(np.float32))
            j = int(np.argmin(cost))
            if cost[j] < best[0]:
                best = (cost[j], b + int(cuts[j]), s)
        order[b:e] = best[2]
        stack.append((best[1], e))
        stack.append((b, best[1]))
    return out


def quat_from_euler(degrees) -> np.ndarray:
    """glm::quat(euler) [w, x, y, z] from Euler angles in degrees, with the
    half-angle products in float32 on the CPU."""
    half = torch.as_tensor(np.radians(np.asarray(degrees, np.float32)),
                           dtype=torch.float32) * 0.5
    c, s = torch.cos(half), torch.sin(half)
    cx, cy, cz = c[0], c[1], c[2]
    sx, sy, sz = s[0], s[1], s[2]
    return torch.stack([cx * cy * cz + sx * sy * sz,
                        sx * cy * cz - cx * sy * sz,
                        cx * sy * cz + sx * cy * sz,
                        cx * cy * sz - sx * sy * cz]).numpy()


def camera_basis(cam: dict, aspect: float) -> dict:
    """camera.h:14-30 in float32 NumPy: origin, lower-left corner,
    horizontal and vertical spans."""
    look_from = np.asarray(cam["position"], np.float32)
    look_at = np.asarray(cam["look_at"], np.float32)
    up = np.asarray(cam["up"], np.float32)
    focus = float(cam["focal_distance"])
    theta = np.radians(np.float32(float(cam["fov"])))
    h = np.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect * viewport_height
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    horizontal = focus * viewport_width * u
    vertical = focus * viewport_height * v
    llc = look_from - horizontal / 2.0 - vertical / 2.0 - focus * w
    return {k: np.asarray(a, np.float32) for k, a in (
        ("origin", look_from), ("llc", llc), ("horizontal", horizontal),
        ("vertical", vertical))}


@dataclass
class Mesh:
    verts: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    mat_id: int
    translate: np.ndarray
    scale: np.ndarray
    quat: np.ndarray
    transformed: bool
    groups: list = field(default_factory=list)


@dataclass
class Scene:
    """The host description: film, camera basis, material columns, rect
    rows, meshes and the background (an (H, W, 3) map or an rgb)."""
    width: int
    height: int
    samples: int
    camera: dict
    materials: dict
    rects: dict
    meshes: list
    background: np.ndarray
    background_is_map: bool


def load(yaml_path: str) -> Scene:
    """Read a scene YAML and the files it names (relative to it)."""
    with open(yaml_path) as f:
        root = yaml.safe_load(f)
    base = os.path.dirname(os.path.abspath(yaml_path))
    film, cam = root["film"], root["camera"]
    textures = {t["name"]: t for t in root.get("textures") or []}
    bg = cam["background"]
    if isinstance(bg, (list, tuple)):
        background, is_map = np.asarray(bg, np.float32), False
    else:
        tex = textures[bg]
        if tex["type"] != "environment":
            raise NotImplementedError(f"background texture {tex['type']}")
        background = read_hdr(os.path.join(base, tex["path"]))
        is_map = True

    rows = [dict(mtype=MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))]
    mat_of = {}
    for m in root.get("materials") or []:
        if m["type"] not in _MTYPE:
            raise NotImplementedError(f"material type {m['type']}")
        for key in ("albedo", "roughness", "strength"):
            if key in m and not isinstance(m[key], (int, float, list)):
                raise NotImplementedError(f"textured {key}")
        mat_of[m["name"]] = len(rows)
        rows.append(dict(
            mtype=_MTYPE[m["type"]],
            albedo=tuple(float(x) for x in m["albedo"]),
            roughness=float(m["roughness"]) if m["type"] == "metal" else 0.0,
            strength=(float(m["strength"]) if m["type"] == "diffuse_light"
                      else 1.0)))
    materials = {
        "mtype": np.asarray([r["mtype"] for r in rows], np.int32),
        "albedo": np.asarray([r["albedo"] for r in rows], np.float32),
        "roughness": np.asarray([r.get("roughness", 0.0) for r in rows],
                                np.float32),
        "strength": np.asarray([r.get("strength", 1.0) for r in rows],
                               np.float32),
        "ior": np.full((len(rows),), 1.5, np.float32),
        "metallness": np.zeros((len(rows),), np.float32)}

    rects = {k: [] for k in ("axis", "a0", "a1", "b0", "b1", "k", "mat")}
    meshes = []
    for o in root.get("objects") or []:
        mat = mat_of[o["material"]]
        tr = o.get("transform") or {}
        if o["type"] in _RECT_AXIS:
            if tr:
                raise NotImplementedError("transformed rect")
            axis, a, b = _RECT_AXIS[o["type"]]
            for key, val in (("axis", axis), ("a0", o[a][0]),
                             ("a1", o[a][1]), ("b0", o[b][0]),
                             ("b1", o[b][1]), ("k", o["k"]), ("mat", mat)):
                rects[key].append(val)
        elif o["type"] == "mesh":
            m = read_obj(os.path.join(base, o["path"]))
            rot = (quat_from_euler(tr["rotate"]) if "rotate" in tr
                   else np.asarray([1.0, 0.0, 0.0, 0.0], np.float32))
            mesh = Mesh(m["verts"], m["normals"], m["indices"], mat,
                        np.asarray(tr.get("translate", (0, 0, 0)),
                                   np.float32),
                        np.asarray(tr.get("scale", (1, 1, 1)), np.float32),
                        np.asarray(rot, np.float32), bool(tr))
            mesh.groups = clusters(m["verts"], m["indices"])
            meshes.append(mesh)
        else:
            raise NotImplementedError(f"object type {o['type']}")
    rects = {k: np.asarray(v, np.int32 if k in ("axis", "mat")
                           else np.float32) for k, v in rects.items()}
    width, height = int(film["width"]), int(film["height"])
    return Scene(width, height, int(film["samples"]),
                 camera_basis(cam, width / height), materials, rects,
                 meshes, background, is_map)
