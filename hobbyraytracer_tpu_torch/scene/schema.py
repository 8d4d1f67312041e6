"""YAML scene schema -> normalized host description.

A copy of hobbyraytracer_tpu/scene/schema.py (importing the reference's
`scene` package would import JAX); tests/test_torch_host.py holds the two
copies equal. The schema accepts every object type the reference does;
scene/build.py raises for the ones this port does not render yet.

Mirrors the reference's yaml-cpp loader (Scene::loadScene, scene.cpp:127-374)
including its required-property errors, texture auto-creation, and
skip-with-log behaviors, and extends the grammar to the classes the C++ core
implements but never exposed (SURVEY.md §2.2 gap): dielectric / isotropic /
pbr materials, box / constant_medium / triangle objects.

Schema (superset of the reference):
  film: {width, height, samples, output}                      (required)
  camera: {position, look_at, up, fov, aperture, focal_distance,
           background}                                        (required)
  textures: [{name, type: solid|image|checkered|environment, ...}]
  materials: [{name, type: lambertian|metal|diffuse_light
                          |dielectric|isotropic|pbr, ...}]
  objects: [{type: mesh|sphere|yz_rect|xz_rect|xy_rect
                   |box|constant_medium|triangle,
             material, ..., transform?: {rotate?, scale?, translate?}}]

MatVec3 properties (albedo) accept [r,g,b] or a texture/image-path string;
MatScalar properties (roughness/strength/metallness) accept a float or a
texture/image-path string (value = length(rgb), material.h:49). Both
auto-create an ImageTexture for unknown names (scene.cpp:84-93,110-118).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


class SceneError(Exception):
    """Load failure; the CLI maps this to the reference's exit -1
    (scene.cpp:366-369, main.cpp:155-156)."""


def _require(node: dict, name: str, ctx: str):
    if not isinstance(node, dict) or name not in node:
        raise SceneError(f"Could not find required property: {name}"
                         f" (in {ctx})")
    return node[name]


def _vec3(node: dict, name: str, ctx: str) -> Tuple[float, float, float]:
    v = _require(node, name, ctx)
    if not isinstance(v, (list, tuple)) or len(v) != 3:
        raise SceneError(f"Invalid value for vector 3: {name}")
    return tuple(float(x) for x in v)


def _vec2(node: dict, name: str, ctx: str) -> Tuple[float, float]:
    v = _require(node, name, ctx)
    if not isinstance(v, (list, tuple)) or len(v) != 2:
        raise SceneError(f"Invalid value for vector 2: {name}")
    return tuple(float(x) for x in v)


@dataclass
class TextureDesc:
    name: str
    type: str                      # solid|image|checkered|environment
    colour: Optional[tuple] = None # solid
    even: Optional[tuple] = None   # checkered
    odd: Optional[tuple] = None
    path: Optional[str] = None     # image|environment


@dataclass
class MatValue:
    """MatVec3 / MatScalar: constant or texture reference."""
    constant: Any = None
    texture: Optional[str] = None


@dataclass
class MaterialDesc:
    name: str
    type: str
    albedo: Optional[MatValue] = None
    roughness: Optional[MatValue] = None
    strength: Optional[MatValue] = None
    ior: Optional[MatValue] = None
    metallness: Optional[MatValue] = None


@dataclass
class TransformDesc:
    rotate: Optional[tuple] = None     # euler degrees (scene.cpp:338-341)
    scale: Optional[tuple] = None
    translate: Optional[tuple] = None


@dataclass
class ObjectDesc:
    type: str
    material: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    transform: Optional[TransformDesc] = None


@dataclass
class SceneDesc:
    film: Dict[str, Any]
    camera: Dict[str, Any]
    background: Any                 # (r,g,b) tuple or texture-name str
    textures: List[TextureDesc]
    materials: List[MaterialDesc]
    objects: List[ObjectDesc]
    base_dir: str

    def resolve_path(self, p: str) -> str:
        """Relative asset paths resolve against the scene file's directory
        first, then CWD (the reference uses CWD only)."""
        if os.path.isabs(p):
            return p
        cand = os.path.join(self.base_dir, p)
        return cand if os.path.exists(cand) else p


def _mat_value(node: dict, name: str, ctx: str, scalar: bool) -> MatValue:
    v = _require(node, name, ctx)
    if scalar:
        if isinstance(v, (int, float)):
            return MatValue(constant=float(v))
        return MatValue(texture=str(v))
    if isinstance(v, (list, tuple)):
        if len(v) != 3:
            raise SceneError(f"Invalid size for vector 3: {name}")
        return MatValue(constant=tuple(float(x) for x in v))
    return MatValue(texture=str(v))


def load_scene_desc(path: str) -> SceneDesc:
    try:
        with open(path) as f:
            root = yaml.safe_load(f)
    except (OSError, yaml.YAMLError) as e:
        raise SceneError(str(e))
    if not isinstance(root, dict):
        raise SceneError("scene file is not a mapping")

    print(f"Loading scene: {path}")  # scene.cpp:138

    if "film" not in root:
        raise SceneError("Must specify film descriptor!")  # scene.cpp:151
    film_node = root["film"]
    film = {
        "width": int(_require(film_node, "width", "film")),
        "height": int(_require(film_node, "height", "film")),
        "samples": int(_require(film_node, "samples", "film")),
        "output": str(_require(film_node, "output", "film")),
    }

    if "camera" not in root:
        raise SceneError("Must specify camera descriptor!")  # scene.cpp:170
    cam_node = root["camera"]
    camera = {
        "position": _vec3(cam_node, "position", "camera"),
        "look_at": _vec3(cam_node, "look_at", "camera"),
        "up": _vec3(cam_node, "up", "camera"),
        "fov": float(_require(cam_node, "fov", "camera")),
        "aperture": float(_require(cam_node, "aperture", "camera")),
        "focal_distance": float(_require(cam_node, "focal_distance",
                                         "camera")),
    }

    textures: List[TextureDesc] = []
    names = set()
    for t in root.get("textures", []) or []:
        name = str(_require(t, "name", "texture"))
        if name in names:
            raise SceneError("Texture name already exists!")  # scene.cpp:181
        names.add(name)
        ttype = str(_require(t, "type", "texture"))
        if ttype == "solid":
            textures.append(TextureDesc(name, "solid",
                                        colour=_vec3(t, "colour", name)))
        elif ttype == "image":
            textures.append(TextureDesc(name, "image",
                                        path=str(_require(t, "path", name))))
        elif ttype == "checkered":
            textures.append(TextureDesc(name, "checkered",
                                        even=_vec3(t, "even", name),
                                        odd=_vec3(t, "odd", name)))
        elif ttype == "environment":
            textures.append(TextureDesc(name, "environment",
                                        path=str(_require(t, "path", name))))
        # unknown texture types silently ignored (reference if-chains)

    if "background" not in cam_node:
        raise SceneError("Could not find required property: background")
    bg = cam_node["background"]
    background = (tuple(float(x) for x in bg)
                  if isinstance(bg, (list, tuple)) else str(bg))

    materials: List[MaterialDesc] = []
    for m in root.get("materials", []) or []:
        name = str(_require(m, "name", "material"))
        mtype = str(_require(m, "type", "material"))
        ctx = f"material {name}"
        md = MaterialDesc(name=name, type=mtype)
        if mtype in ("lambertian", "metal", "diffuse_light", "isotropic",
                     "pbr"):
            md.albedo = _mat_value(m, "albedo", ctx, scalar=False)
        if mtype == "metal" or mtype == "pbr":
            md.roughness = _mat_value(m, "roughness", ctx, scalar=True)
        if mtype == "diffuse_light":
            md.strength = _mat_value(m, "strength", ctx, scalar=True)
        if mtype == "dielectric":  # schema extension (material.h:199-242)
            md.ior = _mat_value(m, "ior", ctx, scalar=True)
            md.roughness = (_mat_value(m, "roughness", ctx, scalar=True)
                            if "roughness" in m else MatValue(constant=0.0))
        if mtype == "pbr":
            md.metallness = _mat_value(m, "metallness", ctx, scalar=True)
        materials.append(md)

    objects: List[ObjectDesc] = []
    for o in root.get("objects", []) or []:
        otype = str(_require(o, "type", "object"))
        od = ObjectDesc(type=otype)
        if otype != "constant_medium":
            od.material = str(_require(o, "material", "object"))
        if otype == "mesh":
            od.params["path"] = str(_require(o, "path", "mesh"))
        elif otype == "sphere":
            od.params["center"] = _vec3(o, "center", "sphere")
            od.params["radius"] = float(_require(o, "radius", "sphere"))
        elif otype in ("yz_rect", "xz_rect", "xy_rect"):
            axes = {"yz_rect": ("y", "z"), "xz_rect": ("x", "z"),
                    "xy_rect": ("x", "y")}[otype]
            od.params["a"] = _vec2(o, axes[0], otype)
            od.params["b"] = _vec2(o, axes[1], otype)
            od.params["k"] = float(_require(o, "k", otype))
        elif otype == "box":  # extension (box.h)
            od.params["min"] = _vec3(o, "min", "box")
            od.params["max"] = _vec3(o, "max", "box")
        elif otype == "triangle":  # extension (triangle.h:6-19)
            od.params["v0"] = _vec3(o, "v0", "triangle")
            od.params["v1"] = _vec3(o, "v1", "triangle")
            od.params["v2"] = _vec3(o, "v2", "triangle")
        elif otype == "constant_medium":  # extension (constantMedium.h)
            od.params["density"] = float(_require(o, "density", otype))
            od.params["albedo"] = _mat_value(o, "albedo", otype,
                                             scalar=False)
            b = _require(o, "boundary", otype)
            btype = str(_require(b, "type", "boundary"))
            if btype == "sphere":
                od.params["boundary"] = {
                    "type": "sphere",
                    "center": _vec3(b, "center", "boundary"),
                    "radius": float(_require(b, "radius", "boundary"))}
            elif btype == "box":
                od.params["boundary"] = {
                    "type": "box",
                    "min": _vec3(b, "min", "boundary"),
                    "max": _vec3(b, "max", "boundary")}
            elif btype == "mesh":  # any-Hittable boundary (see ir.Medium)
                od.params["boundary"] = {
                    "type": "mesh",
                    "path": str(_require(b, "path", "boundary"))}
            else:
                raise SceneError(f"unsupported medium boundary: {btype}")
        else:
            # unknown object type: reference leaves `o` null and would
            # crash; we skip with a log (documented divergence)
            print(f"Unknown object type: {otype}, skipping")
            continue

        if "transform" in o and o["transform"] is not None:
            tn = o["transform"]
            od.transform = TransformDesc(
                rotate=_vec3(tn, "rotate", "transform")
                if "rotate" in tn else None,
                scale=_vec3(tn, "scale", "transform")
                if "scale" in tn else None,
                translate=_vec3(tn, "translate", "transform")
                if "translate" in tn else None,
            )
        objects.append(od)

    return SceneDesc(film=film, camera=camera, background=background,
                     textures=textures, materials=materials, objects=objects,
                     base_dir=os.path.dirname(os.path.abspath(path)))
