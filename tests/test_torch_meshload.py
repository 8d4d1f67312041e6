"""The port's mesh import (scene/meshload.py, scene/objloader.py:write_obj)
against the JAX package's, on the same files.

- Every format that JAX meshload.load_mesh takes (OBJ, PLY ascii and
  binary little-endian, STL ascii and binary, glTF with a data URI and
  with an external buffer, GLB, DAE triangles and polylists, 3DS, binary
  FBX) gives the same four arrays (exact: dtype, shape and bytes), on
  files written here from a random mesh.
- Every file the JAX package refuses (big-endian PLY, sparse glTF
  accessors, ASCII FBX, .blend / .x3d, truncated or empty files) the port
  refuses with the same exception type and message.
- A scene whose meshes are a PLY and a GLB builds leaf for leaf as the
  JAX build does; the long-tail scene of chip_smoke.py (a binary PLY
  teapot, an image texture, the lens) builds to the cluster tables the
  JAX package builds from the same files, and to the pinned digest.
- write_obj writes the JAX package's bytes.
"""
import base64
import importlib.util
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu.scene import meshload as jml
from hobbyraytracer_tpu.scene import objloader as jobj
from hobbyraytracer_tpu_torch.scene import build_scene, convert, load_scene_desc
from hobbyraytracer_tpu_torch.scene import meshload as pml
from hobbyraytracer_tpu_torch.scene import objloader as pobj

from _torch_parity import (ROOT, assert_tree_close, jax_camera_arrays,
                           jax_scene_arrays)

torch.set_num_threads(2)


def _mesh(n_verts=40, n_tris=70, seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n_verts, 3)).astype(np.float32)
    normals = rng.normal(size=(n_verts, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    uvs = rng.random((n_verts, 2)).astype(np.float32)
    idx = rng.integers(0, n_verts, (n_tris, 3)).astype(np.int32)
    return verts, normals, uvs, idx


# ------------------------------------------------------------ file writers

def _ply_ascii(m, uv_names=("u", "v"), normals=True, quads=False):
    verts, nrm, uvs, idx = m
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else [])
    props += list(uv_names)
    faces = ([f"4 {a} {b} {c} {a}" for a, b, c in idx] if quads
             else [f"3 {a} {b} {c}" for a, b, c in idx])
    rows = [" ".join(repr(float(x)) for x in
                     [*v, *(n if normals else []), *t])
            for v, n, t in zip(verts, nrm, uvs)]
    text = ("ply\nformat ascii 1.0\ncomment written by a test\n"
            f"element vertex {len(verts)}\n"
            + "".join(f"property float {p}\n" for p in props)
            + f"element face {len(idx)}\n"
            "property list uchar int vertex_indices\nend_header\n"
            + "\n".join(rows + faces) + "\n")
    return text.encode()


def _ply_binary(m, endian="little", double=False, vertex_list=False):
    verts, nrm, uvs, idx = m
    e = "<" if endian == "little" else ">"
    ft = "double" if double else "float"
    props = ("x", "y", "z", "nx", "ny", "nz", "s", "t")
    vals = np.concatenate([verts, nrm, uvs], axis=1).astype(
        e + ("f8" if double else "f4"))
    head = (f"ply\nformat binary_{endian}_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            + "".join(f"property {ft} {p}\n" for p in props)
            + ("property list uchar uchar tag\n" if vertex_list else "")
            + f"element face {len(idx)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    if vertex_list:   # a list in the vertex element: the per-row path
        body = b"".join(row.tobytes() + bytes([1, 7]) for row in vals)
    else:
        body = vals.tobytes()
    faces = np.zeros(len(idx), dtype=[("n", "u1"), ("i", e + "i4", (3,))])
    faces["n"] = 3
    faces["i"] = idx
    return head.encode() + body + faces.tobytes()


def _stl_binary(m, header=b"\0" * 80):
    verts, _, _, idx = m
    tv = verts[idx]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    rec = np.zeros(len(idx), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                    ("attr", "<u2")])
    rec["n"], rec["v"] = n, tv
    return header[:80].ljust(80, b"\0") + struct.pack("<I", len(idx)) + \
        rec.tobytes()


def _stl_ascii(m):
    verts, _, _, idx = m
    out = ["solid t"]
    for tri in verts[idx]:
        out.append(" facet normal 0 0 1\n  outer loop")
        out += ["   vertex " + " ".join(repr(float(x)) for x in v)
                for v in tri]
        out.append("  endloop\n endfacet")
    out.append("endsolid t")
    return ("\n".join(out) + "\n").encode()


def _gltf_doc(m, index_type=5125, uv_u16=False, stride=False):
    verts, nrm, uvs, idx = m
    nv = len(verts)
    if stride:   # interleaved POSITION / NORMAL in one view
        inter = np.concatenate([verts, nrm], axis=1).astype("<f4").tobytes()
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": nv * 24,
                  "byteStride": 24}]
        acc = [{"bufferView": 0, "componentType": 5126, "count": nv,
                "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
                "count": nv, "type": "VEC3"}]
        data = inter
    else:
        data = verts.astype("<f4").tobytes() + nrm.astype("<f4").tobytes()
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": nv * 12},
                 {"buffer": 0, "byteOffset": nv * 12, "byteLength": nv * 12}]
        acc = [{"bufferView": 0, "componentType": 5126, "count": nv,
                "type": "VEC3"},
               {"bufferView": 1, "componentType": 5126, "count": nv,
                "type": "VEC3"}]
    uv_bytes = (np.round(uvs * 65535).astype("<u2").tobytes() if uv_u16
                else uvs.astype("<f4").tobytes())
    views.append({"buffer": 0, "byteOffset": len(data),
                  "byteLength": len(uv_bytes)})
    acc.append({"bufferView": len(views) - 1,
                "componentType": 5123 if uv_u16 else 5126, "count": nv,
                "type": "VEC2", **({"normalized": True} if uv_u16 else {})})
    data += uv_bytes
    itype = {5121: "u1", 5123: "<u2", 5125: "<u4"}[index_type]
    ib = idx.astype(itype).tobytes()
    views.append({"buffer": 0, "byteOffset": len(data),
                  "byteLength": len(ib)})
    acc.append({"bufferView": len(views) - 1, "componentType": index_type,
                "count": idx.size, "type": "SCALAR"})
    data += ib
    # a primitive without indices: its positions, three corners a triangle
    acc.append({"bufferView": 0, "componentType": 5126,
                "count": nv - nv % 3, "type": "VEC3"})
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(data)}], "bufferViews": views,
           "accessors": acc,
           "meshes": [{"primitives": [
               {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                "indices": 3},
               {"attributes": {"POSITION": 0}, "mode": 1}]},   # lines: skip
               {"primitives": [{"attributes": {"POSITION": 4}}]}]}
    return doc, data


def _gltf_data_uri(m, **kw):
    doc, data = _gltf_doc(m, **kw)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(data).decode())
    return json.dumps(doc).encode()


def _glb(m, **kw):
    doc, data = _gltf_doc(m, **kw)
    pj = json.dumps(doc).encode()
    pj += b" " * (-len(pj) % 4)
    bd = data + b"\0" * (-len(data) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 28 + len(pj) + len(bd))
            + struct.pack("<II", len(pj), 0x4E4F534A) + pj
            + struct.pack("<II", len(bd), 0x004E4942) + bd)


def _dae(m, prim="triangles", up="Z_UP"):
    verts, nrm, uvs, idx = m
    f = " ".join

    def src(name, arr, stride):
        return (f'<source id="{name}"><float_array id="{name}a" '
                f'count="{arr.size}">{f(repr(float(x)) for x in arr.ravel())}'
                f'</float_array><technique_common><accessor '
                f'source="#{name}a" count="{len(arr)}" stride="{stride}"/>'
                f'</technique_common></source>')
    corners = f(f"{i} {i} {i}" for i in idx.ravel())
    inputs = ('<input semantic="VERTEX" source="#vv" offset="0"/>'
              '<input semantic="NORMAL" source="#n" offset="1"/>'
              '<input semantic="TEXCOORD" source="#t" offset="2"/>')
    if prim == "triangles":
        body = f'<triangles count="{len(idx)}">{inputs}<p>{corners}</p>' \
               '</triangles>'
    else:
        body = (f'<polylist count="{len(idx)}">{inputs}<vcount>'
                + f("3" for _ in idx) + f'</vcount><p>{corners}</p>'
                '</polylist>')
    return ('<?xml version="1.0"?><COLLADA xmlns="http://www.collada.org/'
            '2005/11/COLLADASchema" version="1.4.1">'
            f'<asset><up_axis>{up}</up_axis></asset><library_geometries>'
            '<geometry id="g"><mesh>' + src("p", verts, 3)
            + src("n", nrm, 3) + src("t", uvs, 2)
            + '<vertices id="vv"><input semantic="POSITION" source="#p"/>'
            '</vertices>' + body + '</mesh></geometry></library_geometries>'
            '</COLLADA>').encode()


def _3ds(m):
    verts, _, uvs, idx = m

    def chunk(cid, payload):
        return struct.pack("<HI", cid, 6 + len(payload)) + payload
    faces = np.concatenate([idx, np.zeros((len(idx), 1), np.int32)],
                           axis=1).astype("<u2")
    obj = chunk(0x4100,
                chunk(0x4110, struct.pack("<H", len(verts))
                      + verts.astype("<f4").tobytes())
                + chunk(0x4140, struct.pack("<H", len(uvs))
                        + uvs.astype("<f4").tobytes())
                + chunk(0x4120, struct.pack("<H", len(idx))
                        + faces.tobytes()))
    two = chunk(0x4000, b"a\0" + obj) + chunk(0x4000, b"b\0" + obj)
    return chunk(0x4D4D, chunk(0x0002, struct.pack("<I", 3))
                 + chunk(0x3D3D, two))


def _fbx_node(name, props=(), children=()):
    """An FBX 7.4 node record builder (f8/i8 arrays zlib-compressed, bytes
    as S, ints as I), placed at a given offset."""
    def at(offset):
        name_b = name.encode()
        pb = b""
        for p in props:
            if isinstance(p, np.ndarray):
                tc = {"f8": b"d", "i8": b"l"}[p.dtype.str[1:]]
                comp = zlib.compress(p.tobytes())
                pb += tc + struct.pack("<III", p.size, 1, len(comp)) + comp
            elif isinstance(p, bytes):
                pb += b"S" + struct.pack("<I", len(p)) + p
            elif isinstance(p, int):
                pb += b"I" + struct.pack("<i", p)
        cb = b""
        o = offset + 13 + len(name_b) + len(pb)
        for child in children:
            c = child(o)
            cb += c
            o += len(c)
        if children:
            cb += b"\0" * 13
        end = offset + 13 + len(name_b) + len(pb) + len(cb)
        return (struct.pack("<III", end, len(props), len(pb))
                + bytes([len(name_b)]) + name_b + pb + cb)
    return at


def _fbx(m, up_axis=2, by="ByPolygonVertex"):
    verts, nrm, uvs, idx = m
    # polygons: the triangles, then a quad of the first four vertices
    pvi = np.concatenate([idx.ravel(), [0, 1, 2, 3]]).astype(np.int64)
    ends = np.r_[np.arange(2, idx.size, 3), len(pvi) - 1]
    pvi[ends] = ~pvi[ends]
    if by == "ByPolygonVertex":
        corner = np.where(pvi < 0, ~pvi, pvi)
        n_arr, uv_arr = nrm[corner], uvs
        uv_children = (_fbx_node("UV", (uv_arr.astype("<f8").ravel(),)),
                       _fbx_node("UVIndex", (corner.astype("<i8"),)))
    else:
        n_arr = nrm
        uv_children = (_fbx_node("UV", (uvs.astype("<f8").ravel(),)),)
    geom = _fbx_node("Geometry", (), (
        _fbx_node("Vertices", (verts.astype("<f8").ravel(),)),
        _fbx_node("PolygonVertexIndex", (pvi.astype("<i8"),)),
        _fbx_node("LayerElementNormal", (), (
            _fbx_node("Normals", (n_arr.astype("<f8").ravel(),)),
            _fbx_node("MappingInformationType", (by.encode(),)))),
        _fbx_node("LayerElementUV", (), uv_children + (
            _fbx_node("MappingInformationType", (by.encode(),)),))))
    settings = _fbx_node("GlobalSettings", (), (_fbx_node(
        "Properties70", (), (_fbx_node(
            "P", (b"UpAxis", b"int", b"Integer", b"", up_axis)),)),))
    data = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for node in (settings, _fbx_node("Objects", (), (geom,))):
        data += node(len(data))
    return data + b"\0" * 13


def _obj(m):
    verts, nrm, uvs, idx = m
    def row(tag, vals):
        return " ".join([tag] + [repr(float(x)) for x in vals])
    lines = [row("v", v) for v in verts] + [row("vt", t) for t in uvs]
    lines += [row("vn", n) for n in nrm]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in tri)
              for tri in idx]
    return ("\n".join(lines) + "\n").encode()


def _files():
    m = _mesh()
    return {
        "ascii.ply": _ply_ascii(m),
        "ascii_st_no_normals.ply": _ply_ascii(m, ("s", "t"), normals=False),
        "ascii_quads.ply": _ply_ascii(m, quads=True),
        "binary.ply": _ply_binary(m),
        "binary_double.ply": _ply_binary(m, double=True),
        "binary_vertex_list.ply": _ply_binary(m, vertex_list=True),
        "binary.stl": _stl_binary(m),
        "binary_solid_header.stl": _stl_binary(m, b"solid but binary"),
        "ascii.stl": _stl_ascii(m),
        "data_uri.gltf": _gltf_data_uri(m),
        "normalized_uv_u8_index.gltf": _gltf_data_uri(
            _mesh(n_verts=40), index_type=5121, uv_u16=True),
        "interleaved_u16_index.glb": _glb(m, index_type=5123, stride=True),
        "container.glb": _glb(m),
        "triangles.dae": _dae(m),
        "polylist_y_up.dae": _dae(m, "polylist", "Y_UP"),
        "two_objects.3ds": _3ds(m),
        "z_up.fbx": _fbx(m),
        "y_up_by_vertex.fbx": _fbx(m, 1, "ByVertice"),
        "mesh.obj": _obj(m),
        "extensionless": _obj(m),
    }


_FILES = sorted(_files())


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:   # the outcome under test, whatever it is
        return ("raise", type(e), str(e))


def _assert_same_mesh(a, b):
    assert sorted(a) == sorted(b) == ["indices", "normals", "uvs", "verts"]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                           y.dtype)
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("name", _FILES)
def test_load_mesh_matches_jax(tmp_path, name):
    """load_mesh of every format: the four arrays exact."""
    path = _write(tmp_path, name, _files()[name])
    got = pml.load_mesh(path)
    _assert_same_mesh(got, jml.load_mesh(path))
    assert got["verts"].dtype == np.float32 and got["indices"].dtype == \
        np.int32 and len(got["indices"]) >= 70


def test_gltf_external_buffer_matches_jax(tmp_path):
    """A .gltf whose buffer is a .bin file beside it."""
    doc, data = _gltf_doc(_mesh())
    doc["buffers"][0]["uri"] = "mesh.bin"
    (tmp_path / "mesh.bin").write_bytes(data)
    path = _write(tmp_path, "ext.gltf", json.dumps(doc).encode())
    _assert_same_mesh(pml.load_mesh(path), jml.load_mesh(path))


def _bad_files():
    m = _mesh()
    doc, data = _gltf_doc(m)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(data).decode())
    sparse = json.loads(json.dumps(doc))
    sparse["accessors"][0]["sparse"] = {"count": 1}
    no_tris = json.loads(json.dumps(doc))
    no_tris["meshes"] = [{"primitives": [{"attributes": {"POSITION": 0},
                                          "mode": 1}]}]
    out_of_range = (m[0], m[1], m[2], m[3] + 1000)
    return {
        "big_endian.ply": _ply_binary(m, "big"),
        "not_ply.ply": b"plx\nformat ascii 1.0\n",
        "unterminated.ply": b"ply\nformat ascii 1.0\nelement vertex 1\n",
        "index_range.ply": _ply_ascii(out_of_range),
        "no_faces.ply": _ply_ascii((m[0], m[1], m[2],
                                    np.zeros((0, 3), np.int32))),
        "empty.stl": b"",
        "sparse.gltf": json.dumps(sparse).encode(),
        "lines_only.gltf": json.dumps(no_tris).encode(),
        "bad_json.gltf": b"{not json",
        "not_glb.glb": b"glTX" + b"\0" * 20,
        "truncated.glb": _glb(m)[:50],
        "no_geometry.dae": b'<?xml version="1.0"?><COLLADA xmlns="http://'
                           b'www.collada.org/2005/11/COLLADASchema"/>',
        "bad_xml.dae": b"<COLLADA><unclosed>",
        "not_3ds.3ds": b"\x00\x00" + b"\0" * 10,
        "truncated.3ds": _3ds(m)[:40],
        "ascii.fbx": b"; FBX 7.4.0 project file\nObjects: {\n}\n",
        "truncated.fbx": _fbx(m)[:60],
        "model.blend": b"BLENDER-v300",
        "model.x3d": b"<X3D/>",
        "missing.obj": None,
    }


@pytest.mark.parametrize("name", sorted(_bad_files()))
def test_refusals_match_jax(tmp_path, name):
    """Each refused file: the same exception type and message."""
    data = _bad_files()[name]
    path = str(tmp_path / name) if data is None else _write(tmp_path, name,
                                                            data)
    got = _outcome(pml.load_mesh, path)
    ref = _outcome(jml.load_mesh, path)
    assert got[0] == ref[0] == "raise", (name, got[0], ref[0])
    assert got[1:] == ref[1:]


@pytest.mark.parametrize("parts", ["all", "normals", "none"])
def test_write_obj_matches_jax(tmp_path, parts):
    """write_obj with normals and uvs, normals only, neither: the JAX
    package's bytes, and the file parses back to the mesh."""
    verts, nrm, uvs, idx = _mesh()
    kw = {"all": dict(normals=nrm, uvs=uvs), "normals": dict(normals=nrm),
          "none": {}}[parts]
    a, b = str(tmp_path / "p.obj"), str(tmp_path / "j.obj")
    pobj.write_obj(a, verts, idx, **kw)
    jobj.write_obj(b, verts, idx, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = pobj.parse_obj(a)
    np.testing.assert_array_equal(back["verts"][back["indices"]],
                                  verts[idx])


_SCENE = """
film: {{width: 16, height: 16, samples: 1, output: m.png}}
camera:
    position: [0, 2.5, 8.5]
    look_at: [0, 2.5, 0]
    up: [0, 1, 0]
    fov: 45
    aperture: 0.001
    focal_distance: 8.5
    background: [0.2, 0.3, 0.4]
materials:
  - {{name: white, type: lambertian, albedo: [0.73, 0.73, 0.73]}}
  - {{name: light, type: diffuse_light, albedo: [1, 1, 1], strength: 4}}
objects:
  - {{type: xz_rect, x: [-1, 1], z: [-1, 1], k: 4.99, material: light}}
  - type: mesh
    path: big.ply
    material: white
    transform: {{rotate: [0, 30, 0], translate: [0, 1, 0], scale: [0.5, 0.5,
                 0.5]}}
  - {{type: mesh, path: small.glb, material: white}}
  - {{type: mesh, path: gone.stl, material: white}}
"""


def test_ply_and_glb_scene_builds_as_jax(tmp_path, capsys):
    """A scene with a clustered PLY mesh (300 triangles), a dense GLB mesh
    (under BVH_MIN_TRIS) and a missing STL: leaf for leaf as the JAX build
    (ints and tables exact, other floats within 1e-6: the transform goes
    through each framework's sin/cos), and the same log lines."""
    _write(tmp_path, "big.ply", _ply_binary(_mesh(200, 300, seed=1)))
    _write(tmp_path, "small.glb", _glb(_mesh(20, 30, seed=2)))
    path = _write(tmp_path, "scene.yaml", _SCENE.format().encode())
    job_p = build_scene(load_scene_desc(path))
    out_p = capsys.readouterr().out
    job_j = jax_build_scene(jax_load_scene_desc(path))
    out_j = capsys.readouterr().out
    assert out_p == out_j and "Couldn't load file: gone.stl" in out_p
    arr_p = convert.scene_to_arrays(job_p.scene)
    assert_tree_close(arr_p, jax_scene_arrays(job_j.scene))
    kinds = [(i["kind"], i["mesh"] is not None and i["mesh"]["use_bvh"])
             for i in arr_p["instances"]]
    assert ("mesh", True) in kinds and ("mesh", False) in kinds


def test_long_tail_scene_builds_as_jax(tmp_path):
    """chip_smoke.py's long-tail scene (its files written by its own
    helpers): the PLY teapot's cluster tables equal the JAX package's
    build of the same files byte for byte and the pinned digest; the
    whole scene and the camera leaf for leaf; the checker texture loaded."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", f"{ROOT}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    path = smoke.long_tail_scene(str(tmp_path))
    job_p = build_scene(load_scene_desc(path))
    job_j = jax_build_scene(jax_load_scene_desc(path))
    arr_p = convert.scene_to_arrays(job_p.scene)
    arr_j = jax_scene_arrays(job_j.scene)
    assert_tree_close(arr_p, arr_j)
    mesh_p = next(i["mesh"] for i in arr_p["instances"] if i["mesh"])
    mesh_j = next(i["mesh"] for i in arr_j["instances"] if i["mesh"])
    for f in ("cluster_id", "tri_soa", "bounds8", "verts", "uvs"):
        assert mesh_p[f].tobytes() == mesh_j[f].tobytes(), f
    mesh = next(i.mesh for i in job_p.scene.instances if i.kind == "mesh")
    assert smoke.table_digest(mesh) == smoke.PLY_TABLE_SHA256
    assert tuple(mesh.tri_soa.shape) == (30, 24, 128)
    assert_tree_close(convert.camera_to_arrays(job_p.camera),
                      jax_camera_arrays(job_j.camera))
    assert float(job_p.camera.lens_radius) == np.float32(
        smoke.LENS_APERTURE / 2)
    tex = arr_p["textures"]
    side = smoke.CHECKER[0]
    assert sorted(tex["width"].tolist()) == [0, side, 512]
