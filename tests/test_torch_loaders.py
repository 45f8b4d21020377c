"""The port's scene loaders against the JAX package's, on the files the
JAX package's loader tests write (test_obj, test_stl, test_ply,
test_gltf, test_scene_json, test_instancing, test_loader_robustness) and
on the files ``scene/files.py`` writes: every array each loader returns
bit for bit, the same exception types on malformed input, the same host
``Scene``, and ``Scene.to_device``'s tables (tri_shade, tri_attr,
sphere_table, the BVH tables and the fat rows) bit for bit with the JAX
``SceneData``'s, the light tables and counts with them (emissive
triangles, delta lights, an environment map, several emissive spheres,
the power table and its alias rows), the texel atlas and its static meta
and the texture gates with them (albedo, cutout, blend, normal, roughness
and metal maps from OBJ/MTL and glTF files)."""

import dataclasses
import json
import struct

import numpy as np
import pytest

from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.scene import description as jdesc
from tyrant_tpu.scene import gltf as jgltf
from tyrant_tpu.scene import instancing as jinst
from tyrant_tpu.scene import obj as jobj
from tyrant_tpu.scene import ply as jply
from tyrant_tpu.scene import stl as jstl
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.scene import load_mesh as jload_mesh
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene import description as tdesc
from tyrant_tpu_torch.scene import files
from tyrant_tpu_torch.scene import gltf as tgltf
from tyrant_tpu_torch.scene import instancing as tinst
from tyrant_tpu_torch.scene import obj as tobj
from tyrant_tpu_torch.scene import ply as tply
from tyrant_tpu_torch.scene import stl as tstl
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene
from tyrant_tpu_torch.scene.scene import load_mesh as tload_mesh

from .test_gltf import TRI_POS, _Bin, _build_test_glb, _glb, _png_bytes
from .test_stl import _write_ascii, _write_binary


def same(a, b, where="value"):
    """a (JAX package) and b (port) equal: arrays bit for bit with the same
    dtype and shape, dataclasses field by field, containers item by item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], where
        for k in fa:
            same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), \
            (where, a, b)


# --------------------------------------------------------------------------
# the files: each maker writes into tmp_path and returns the path to load
# --------------------------------------------------------------------------

def _write(tmp_path, name, data):
    p = tmp_path / name
    if isinstance(data, (bytes, bytearray)):
        p.write_bytes(data)
    else:
        p.write_text(data if isinstance(data, str) else json.dumps(data))
    return str(p)


CUBE_OBJ = """
# cube
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f 1 2 3 4
f 5/1 6/2 7/3 8/4
f 1//1 2//2 6//3 5//4
f -4 -3 -1
"""
TINY_OBJ = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 2 4\n"
PLY_HEAD = ("ply\nformat ascii 1.0\nelement vertex 3\n"
            "property float x\nproperty float y\nproperty float z\n")
PLY_FACE = "element face 1\nproperty list uchar int vertex_indices\n"


def _obj_ggx(tmp_path):  # test_ggx.test_obj_mtl_metallic_loads_ggx
    _write(tmp_path, "m.mtl", "newmtl gold\nKd 1.0 0.77 0.34\nPr 0.22\n"
           "Pm 1.0\nnewmtl matte\nKd 0.5 0.5 0.5\n")
    return _write(tmp_path, "s.obj", "mtllib m.mtl\n"
                  "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                  "usemtl gold\nf 1 2 3\nusemtl matte\nf 2 4 3\n")


def _obj_maps(tmp_path, statement):
    """A textured quad whose MTL names one map (``statement``)."""
    (tmp_path / "t.png").write_bytes(
        _png_bytes(np.full((2, 2, 3), 200, np.uint8)))
    from PIL import Image
    Image.fromarray(np.full((2, 2, 4), 100, np.uint8)).save(tmp_path / "a.png")
    _write(tmp_path, "m.mtl", f"newmtl mat\nKd 0.5 0.5 0.5\nPm 1.0\n"
           f"{statement}\n")
    return _write(tmp_path, "q.obj", "mtllib m.mtl\n"
                  "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                  "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                  "usemtl mat\nf 1/1 2/2 3/3 4/4\n")


def _ply_binary(tmp_path):  # test_ply.test_binary_roundtrip
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1]], np.float32)
    out = (b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
           b"property float x\nproperty float y\nproperty float z\n"
           b"element face 2\nproperty list uchar int vertex_indices\n"
           b"end_header\n" + verts.astype("<f4").tobytes())
    for n, idx in [(3, [0, 1, 2]), (4, [0, 1, 3, 2])]:
        out += np.uint8(n).tobytes() + np.asarray(idx, "<i4").tobytes()
    return _write(tmp_path, "t.ply", out)


def _ply_colors_binary(tmp_path):  # test_ply.test_vertex_colors_binary
    out = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
           b"property float x\nproperty float y\nproperty float z\n"
           b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
           b"element face 1\nproperty list uchar int vertex_indices\n"
           b"end_header\n")
    for vert in ((0, 0, 0), (1, 0, 0), (0, 1, 0)):
        out += struct.pack("<fff3B", *vert, 128, 128, 128)
    return _write(tmp_path, "colb.ply", out + struct.pack("<B3i", 3, 0, 1, 2))


def _cube_soup():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
                  [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6],
                  [3, 0, 4], [3, 4, 7]])
    return v[f]


def _stl(tmp_path, kind):  # test_stl's round trips, header and degenerates
    p = str(tmp_path / f"{kind}.stl")
    tris = _cube_soup()
    if kind == "ascii":
        _write_ascii(p, tris)
    elif kind == "solid_header":
        _write_binary(p, tris, header=b"solid cube exported as binary")
    elif kind == "degenerate":
        tris = np.concatenate([tris, tris[:1] * [1, 1, 0]]).astype(np.float32)
        tris[-1, 2] = tris[-1, 1]
        _write_binary(p, tris)
    else:
        _write_binary(p, tris)
    return p


def _glb_one(tmp_path, name, material, extra=None):
    """One triangle with one material (test_gltf / test_rough_glass /
    test_ior's single-primitive files)."""
    b = _Bin()
    bv = b.add(TRI_POS.tobytes())
    accessors = [{"bufferView": bv, "componentType": 5126, "count": 3,
                  "type": "VEC3"}]
    attrs = {"POSITION": 0}
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "materials": [material]}
    for key, (data, acc) in (extra or {}).items():
        acc = dict(acc, bufferView=b.add(data))
        attrs[key] = len(accessors)
        accessors.append(acc)
    if "TEXCOORD_0" in attrs:
        gltf["images"] = [{"bufferView": b.add(_png_bytes(
            np.full((2, 2, 3), 188, np.uint8))), "mimeType": "image/png"}]
        gltf["textures"] = [{"source": 0}]
    gltf.update(buffers=[{"byteLength": len(b.blob)}], bufferViews=b.views,
                accessors=accessors,
                meshes=[{"primitives": [{"attributes": attrs,
                                         "material": 0}]}])
    return _write(tmp_path, name, _glb(gltf, b.blob))


_UV = (np.array([[0, 0], [1, 0], [0, 1]], np.float32).tobytes(),
       {"componentType": 5126, "count": 3, "type": "VEC2"})


def _gltf_data_uri(tmp_path):  # test_gltf.test_gltf_json_with_data_uri
    import base64
    blob = open(_build_test_glb(tmp_path, lights=False, camera=False),
                "rb").read()
    jlen = struct.unpack_from("<I", blob, 12)[0]
    gltf = json.loads(blob[20:20 + jlen])
    gltf["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                 + base64.b64encode(blob[20 + jlen + 8:])
                                 .decode())
    return _write(tmp_path, "scene.gltf", gltf)


def _glb_noscene(tmp_path):  # test_gltf_no_scenes_key_walks_roots_only
    b = _Bin()
    bv = b.add(TRI_POS.tobytes())
    gltf = {"asset": {"version": "2.0"},
            "buffers": [{"byteLength": len(b.blob)}], "bufferViews": b.views,
            "accessors": [{"bufferView": bv, "componentType": 5126,
                           "count": 3, "type": "VEC3"}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
            "nodes": [{"children": [1], "translation": [5.0, 0.0, 0.0]},
                      {"mesh": 0}]}
    return _write(tmp_path, "noscene.glb", _glb(gltf, b.blob))


def _terrain_soup():
    return terrain(n_quads=10, towers=2)


def _asset_scene(tmp_path, normals=True):
    """scene/files.py's loaded scene at a small size: a PLY terrain, the
    OBJ/MTL asset and the JSON description placing both."""
    ply = tmp_path / "terrain.ply"
    files.write_ply(ply, *_terrain_soup(), normals=normals)
    asset = files.write_asset_obj(tmp_path, n_phi=10, n_theta=6)
    return files.write_description(tmp_path / "scene.json", ply, asset,
                                   [(0, -60, 20), (30, -60, 20),
                                    (-30, -60, 20)], dispersion=0.02)


MAKERS = {
    "obj_cube": lambda p: _write(p, "cube.obj", CUBE_OBJ),
    "obj_tri": lambda p: _write(p, "t.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                "f 1 2 3\n"),
    "obj_ggx": _obj_ggx,
    "obj_vn": lambda p: _write(  # test_smooth_normals.test_obj_vn_parsing
        p, "t.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvn 0.707 0 0.707\n"
        "vn 0 0.707 0.707\nf 1//1 2//2 3//3\n"),
    "obj_map_kd": lambda p: _obj_maps(p, "map_Kd t.png"),
    "obj_map_kn": lambda p: _obj_maps(p, "map_Kn t.png"),
    "obj_map_pr": lambda p: _obj_maps(p, "map_Pr t.png"),
    "obj_map_d": lambda p: _obj_maps(p, "map_Kd t.png\nmap_d a.png\nd 0.5"),
    "obj_map_pm": lambda p: _obj_maps(p, "map_Pr t.png\nmap_Pm t.png"),
    "obj_ke": lambda p: _write(p, "m.mtl", "newmtl e\nKe 4 4 4\n")
    and _write(p, "e.obj", "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
               "usemtl e\nf 1 2 3\n"),
    "asset_obj": lambda p: files.write_asset_obj(p, n_phi=10, n_theta=6),
    "ply_binary": _ply_binary,
    "ply_colors_ascii": lambda p: _write(  # test_ply.test_vertex_colors_ascii
        p, "col.ply", PLY_HEAD + "property uchar red\nproperty uchar green\n"
        "property uchar blue\n" + PLY_FACE + "end_header\n0 0 0 255 0 0\n"
        "1 0 0 255 0 0\n0 1 0 255 0 0\n3 0 1 2\n"),
    "ply_colors_binary": _ply_colors_binary,
    "ply_normals": lambda p: _write(  # test_smooth_normals's PLY
        p, "n.ply", PLY_HEAD + "property float nx\nproperty float ny\n"
        "property float nz\n" + PLY_FACE + "end_header\n0 0 0 0 0 1\n"
        "1 0 0 1 0 0\n0 1 0 0 1 0\n3 0 1 2\n"),
    "ply_terrain": lambda p: files.write_ply(
        p / "terrain.ply", *_terrain_soup(), normals=True)
    and str(p / "terrain.ply"),
    "stl_binary": lambda p: _stl(p, "binary"),
    "stl_ascii": lambda p: _stl(p, "ascii"),
    "stl_solid_header": lambda p: _stl(p, "solid_header"),
    "stl_degenerate": lambda p: _stl(p, "degenerate"),
    "glb_full": lambda p: _build_test_glb(p),
    "gltf_data_uri": _gltf_data_uri,
    "glb_noscene": _glb_noscene,
    "glb_texture_transform": lambda p: _glb_one(
        p, "tt.glb", {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0, "extensions": {
                "KHR_texture_transform": {"offset": [0.25, 0.125],
                                          "scale": [0.5, 0.5]}}},
            "metallicFactor": 0.0}}, {"TEXCOORD_0": _UV}),
    "glb_vertex_colors": lambda p: _glb_one(
        p, "vcol.glb", {"pbrMetallicRoughness": {
            "baseColorFactor": [0.5, 1.0, 1.0, 1.0], "metallicFactor": 0.0}},
        {"COLOR_0": (np.array([[255, 0, 0, 255]] * 3, np.uint8).tobytes(),
                     {"componentType": 5121, "count": 3, "type": "VEC4",
                      "normalized": True})}),
    "glb_emissive_texture": lambda p: _glb_one(
        p, "em.glb", {"emissiveFactor": [2.0, 2.0, 2.0],
                      "emissiveTexture": {"index": 0}}, {"TEXCOORD_0": _UV}),
    "glb_ggx": lambda p: _glb_one(
        p, "ggx.glb", {"doubleSided": True, "pbrMetallicRoughness": {
            "metallicFactor": 1.0, "roughnessFactor": 0.25}}),
    "glb_rough_glass": lambda p: _glb_one(  # test_rough_glass's glTF
        p, "frosted.glb", {"extensions": {"KHR_materials_transmission":
                                          {"transmissionFactor": 1.0}},
                           "pbrMetallicRoughness": {"metallicFactor": 0.0,
                                                    "roughnessFactor": 0.5}}),
    "glb_ior": lambda p: _glb_one(  # test_ior.test_gltf_ior
        p, "ior.glb", {"pbrMetallicRoughness": {"metallicFactor": 0.0,
                                                "roughnessFactor": 0.0},
                       "extensions": {
                           "KHR_materials_transmission":
                               {"transmissionFactor": 1.0},
                           "KHR_materials_ior": {"ior": 1.45}}}),
    "glb_bare": lambda p: files.write_glb(p / "bare.glb", *_terrain_soup()),
    "json_spheres": lambda p: _write(  # test_scene_json's first case
        p, "s.json", {"spheres": [
            {"center": [0, 0, 10], "radius": 2, "material": "glass",
             "color": [0.9, 0.9, 1.0]},
            {"center": [0, 0, 40], "radius": 4, "material": "light",
             "emission": [5, 5, 5]},
            {"center": [9, 0, 10], "radius": 2, "material": "rough_glass",
             "roughness": 0.35},
            {"center": [-9, 0, 10], "radius": 2, "material": "metal"}],
            "default_spheres": False,
            "camera": {"position": [0, -20, 5], "vertical": 0.2,
                       "lens_radius": 0.1},
            "sun": [0.1, 0.4],
            "render": {"bounces": 3, "tonemap": "aces", "dispersion": 0.1}}),
    "json_default_plus": lambda p: _write(
        p, "s.json", {"default_spheres": True,
                      "spheres": [{"center": [9, 9, 9], "radius": 1}]}),
    "json_instanced": lambda p: _write(p, "tri.obj", TINY_OBJ) and _write(
        p, "scene.json", {
            "meshes": [{"name": "tri", "path": "tri.obj", "scale": 2.0}],
            "instances": [{"mesh": "tri"},
                          {"mesh": "tri", "translate": [10, 0, 0],
                           "rotate_z": 90},
                          {"mesh": 0, "matrix": [[0, -1, 0, 5], [1, 0, 0, 0],
                                                 [0, 0, 1, 1]]}],
            "default_spheres": True}),
    "json_identity": lambda p: _write(p, "tri.obj", TINY_OBJ) and _write(
        p, "scene.json", {"meshes": [{"path": "tri.obj"}]}),
    "json_override": lambda p: _write(
        p, "tri.ply", PLY_HEAD + PLY_FACE
        + "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n") and _write(
        p, "s.json", {"meshes": [
            {"name": "a", "path": "tri.ply", "material": "metal",
             "color": [0.9, 0.5, 0.2], "roughness": 0.15},
            {"name": "g", "path": "tri.ply", "material": "glass",
             "ior": 1.55},
            {"name": "c", "path": "tri.ply", "color": [0.1, 0.2, 0.3]}],
            "default_spheres": False}),
    "json_lights": lambda p: _write(p, "s.json", {
        "lights": [{"type": "point", "position": [0, 0, 50],
                    "intensity": [100, 100, 100]}]}),
    "json_asset": _asset_scene,
}


# --------------------------------------------------------------------------
# every loader's arrays, bit for bit
# --------------------------------------------------------------------------

def _loads(path):
    """(name, JAX call, port call) for each loader that reads ``path``."""
    ext = path.rsplit(".", 1)[1]
    calls = []
    if ext == "obj":
        calls += [("load_obj_scene", jobj.load_obj_scene,
                   tobj.load_obj_scene),
                  ("load_obj", jobj.load_obj, tobj.load_obj)]
    elif ext == "ply":
        calls += [(n, getattr(jply, n), getattr(tply, n))
                  for n in ("load_ply", "load_ply_full", "load_ply_attrs")]
    elif ext == "stl":
        calls.append(("load_stl", jstl.load_stl, tstl.load_stl))
    elif ext in ("glb", "gltf"):
        calls += [("load_gltf", jgltf.load_gltf, tgltf.load_gltf),
                  ("load_gltf y-up", lambda q: jgltf.load_gltf(
                      q, y_up_to_z_up=False, scale=2.0),
                   lambda q: tgltf.load_gltf(q, y_up_to_z_up=False,
                                             scale=2.0))]
    elif ext == "json":
        calls.append(("load_description",
                      lambda q: jdesc.load_description(q, builder="numpy"),
                      lambda q: tdesc.load_description(q, builder="numpy")))
    if ext in ("obj", "ply", "stl", "glb", "gltf"):
        calls.append(("MeshAsset.load", lambda q: jinst.MeshAsset.load(q, 1.5),
                      lambda q: tinst.MeshAsset.load(q, 1.5)))
    if ext in ("obj", "ply", "stl"):
        calls.append(("load_mesh", jload_mesh, tload_mesh))
    return calls


def _as_host(x):
    """A loader's result with the Scene's BVH and the camera reduced to
    plain data (the two packages' classes differ in name only)."""
    if hasattr(x, "scene") and hasattr(x, "config"):  # a SceneBundle
        cam = x.camera
        return (_as_host(x.scene), x.sun, x.config, None if cam is None else
                {k: getattr(cam, k) for k in (
                    "position", "up", "horizontal_angle", "vertical_angle",
                    "focal_distance", "lens_radius")})
    if hasattr(x, "tri_vert") and hasattr(x, "bvh"):  # a Scene
        d = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
        d["bvh"] = None if x.bvh is None else dataclasses.asdict(x.bvh)
        d["spheres"] = dataclasses.asdict(x.spheres)
        d["delta_lights"] = None if x.delta_lights is None \
            else dataclasses.asdict(x.delta_lights)
        return d
    return x


@pytest.mark.parametrize("case", sorted(MAKERS))
def test_loader_arrays_bitwise(case, tmp_path):
    path = MAKERS[case](tmp_path)
    calls = _loads(path)
    assert calls
    for name, jcall, tcall in calls:
        same(_as_host(jcall(path)), _as_host(tcall(path)), f"{case} {name}")


def test_accessor_strided_and_sparse():
    """test_gltf's interleaved and sparse accessors through both
    _read_accessor copies."""
    inter = np.zeros((3, 5), np.float32)
    inter[:, :3] = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    inter[:, 3:] = [[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]]
    blob = inter.tobytes()
    g = {"bufferViews": [{"buffer": 0, "byteOffset": 0,
                          "byteLength": len(blob), "byteStride": 20}],
         "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                        "type": "VEC3"},
                       {"bufferView": 0, "byteOffset": 12,
                        "componentType": 5126, "count": 3, "type": "VEC2"}]}
    sblob = np.array([1, 3], np.uint16).tobytes() + b"\0\0\0\0" \
        + np.array([[9, 9, 9], [7, 7, 7]], np.float32).tobytes()
    g2 = {"bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 4},
                          {"buffer": 0, "byteOffset": 8, "byteLength": 24}],
          "accessors": [{"componentType": 5126, "count": 5, "type": "VEC3",
                         "sparse": {"count": 2, "indices": {
                             "bufferView": 0, "componentType": 5123},
                             "values": {"bufferView": 1}}}]}
    for gl, b, i in ((g, blob, 0), (g, blob, 1), (g2, sblob, 0)):
        got = tgltf._read_accessor(gl, [b], i)
        same(jgltf._read_accessor(gl, [b], i), got)
    np.testing.assert_allclose(got[1], 9.0)


# --------------------------------------------------------------------------
# instancing
# --------------------------------------------------------------------------

def _tet(mod):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    return mod.MeshAsset(v0=v[f[:, 0]], v1=v[f[:, 1]], v2=v[f[:, 2]])


def _instancing_case(mod, case):
    """test_instancing's meshes and transforms, built with ``mod``."""
    tet = _tet(mod)
    if case == "transforms":
        xf = mod.translate([3.0, -1.0, 2.0]) @ mod.rotate_y(0.7) \
            @ mod.scale(2.0)
        return [tet], [(0, np.eye(4)), (0, xf)]
    if case == "mirror":
        return [tet], [(0, mod.scale([-1.0, 1.0, 1.0]))]
    if case == "normals":
        tet.tri_vn = np.tile(np.float32([1, 0, 1]) / np.sqrt(2), (4, 3, 1))
        return [tet], [(0, mod.scale([2.0, 1.0, 0.5]))]
    if case == "textures":
        a, b, plain = tet, _tet(mod), _tet(mod)
        for m, val in ((a, 1.0), (b, 0.5)):
            m.textures = [np.full((4, 4, 3), val, np.float32)]
            m.tri_tex = np.zeros(4, np.int32)
            m.tri_uv = np.zeros((4, 3, 2), np.float32)
        return [a, b, plain], [(1, np.eye(4)), (0, np.eye(4)),
                               (2, np.eye(4))]
    a, plain = tet, _tet(mod)  # materials, roughness and IOR merged
    a.tri_refl = np.full(4, 5, np.int32)
    a.tri_rough = np.full(4, 0.15, np.float32)
    a.tri_color = np.tile(np.float32([1, 0.5, 0.25]), (4, 1))
    plain.tri_refl = np.full(4, 2, np.int32)
    plain.tri_ior = np.full(4, 1.6, np.float32)
    return [a, plain], [(0, np.eye(4)), (1, mod.translate([2.5, 0, 0])),
                        (0, mod.translate([0, 2.5, 0]) @ mod.rotate_y(1.1))]


@pytest.mark.parametrize("case", ["transforms", "mirror", "normals",
                                  "textures", "materials"])
def test_instancing_bitwise(case):
    j = jinst.flatten_instances(*_instancing_case(jinst, case))
    t = tinst.flatten_instances(*_instancing_case(tinst, case))
    same(j, t, case)
    js = JScene.from_instances(*_instancing_case(jinst, case),
                               builder="numpy")
    ts = Scene.from_instances(*_instancing_case(tinst, case),
                              builder="numpy")
    same(_as_host(js), _as_host(ts), case)


# --------------------------------------------------------------------------
# Scene.load and the device tables
# --------------------------------------------------------------------------

SCENES = ["obj_tri", "obj_ggx", "obj_vn", "asset_obj", "ply_binary",
          "ply_colors_ascii", "ply_normals", "ply_terrain", "stl_binary",
          "glb_ggx", "glb_rough_glass", "glb_ior", "glb_bare", "glb_noscene",
          "json_spheres", "json_default_plus", "json_instanced",
          "json_identity", "json_override", "json_asset", "obj_ke",
          "json_lights"]
_BVH = ("node_packed", "miss_flat", "tri_packed", "leaf_packed")
_TABLES = ("tri_shade", "tri_attr", "sphere_table", "sphere_center",
           "sphere_radius", "sphere_emission", "tri_lights", "delta_lights",
           "light_powers", "light_alias", "env_data", "env_alias",
           "tex_data")
_FLAGS = ("smooth_normals", "has_ggx", "has_rrefr", "has_var_ior",
          "light_indices", "n_tri_lights", "n_delta_lights", "env_meta",
          "has_envmap", "tri_default_mat", "tex_meta", "has_albedo_tex",
          "has_textures", "has_normal_maps", "has_rough_maps",
          "has_alpha_tex", "has_blend", "has_metal_maps")
# the texture gates by the names of the features they shade
GATES = {"textures": "has_albedo_tex", "alpha maps": "has_alpha_tex",
         "blend": "has_blend", "normal maps": "has_normal_maps",
         "roughness maps": "has_rough_maps", "metal maps": "has_metal_maps"}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def check_tables(jd, td):
    """A port SceneData (on the CPU) against a JAX SceneData, bit for
    bit, with the flags and the fat rows."""
    for k in _BVH:
        np.testing.assert_array_equal(_bits(getattr(td.bvh, k).numpy()),
                                      _bits(np.asarray(getattr(jd.bvh, k))), k)
    for k in _TABLES:
        np.testing.assert_array_equal(_bits(getattr(td, k).numpy()),
                                      _bits(np.asarray(getattr(jd, k))), k)
    for k in _FLAGS:
        assert getattr(td, k) == getattr(jd, k), k
    # the power pick's total (the MIS emitter-hit pdf's denominator)
    np.testing.assert_allclose(td.light_total_power.numpy(),
                               np.asarray(jd.light_powers).sum(),
                               rtol=2.4e-7)
    assert td.light_index == int(jd.light_index)
    jt, tt = JPacketTables(jd.bvh), PacketTables(td.bvh)
    np.testing.assert_array_equal(_bits(tt.rows.numpy()),
                                  _bits(np.asarray(jt.rows)))


@pytest.mark.parametrize("case", SCENES)
def test_scene_load_tables_bitwise(case, tmp_path):
    path = MAKERS[case](tmp_path)
    js = JScene.load(path, builder="numpy") if not path.endswith(".json") \
        else jdesc.load_description(path, builder="numpy").scene
    ts = Scene.load(path, builder="numpy")
    same(_as_host(js), _as_host(ts), case)
    check_tables(js.to_device(), ts.to_device("cpu"))


def test_missing_file_gives_a_scene_without_primitives(tmp_path, capsys):
    ts = Scene.load(str(tmp_path / "absent.ply"))
    assert "not found" in capsys.readouterr().err
    js = JScene.load(str(tmp_path / "absent.ply"))
    assert ts.bvh is None and ts.tri_vert.shape == (0, 3)
    check_tables(js.to_device(), ts.to_device("cpu"))


@pytest.mark.parametrize("case,features", [
    ("obj_map_kd", ["textures"]),
    ("obj_map_d", ["textures", "alpha maps", "blend"]),
    ("obj_map_kn", ["normal maps"]),
    ("obj_map_pr", ["roughness maps"]),
    ("obj_map_pm", ["roughness maps", "metal maps"]),
    ("glb_full", ["textures"]),
    ("glb_emissive_texture", ["textures"])])
def test_unported_features_refused_by_name(case, features, tmp_path):
    """Once refused on upload, now shaded (the name is kept from then):
    the scene loads equal to the JAX package's and uploads with tables,
    atlas and meta bit for bit the JAX package's, exactly the named
    features' gates on."""
    path = MAKERS[case](tmp_path)
    js = JScene.load(path, builder="numpy") if not path.endswith(".json") \
        else jdesc.load_description(path, builder="numpy").scene
    ts = Scene.load(path, builder="numpy")
    same(_as_host(js), _as_host(ts), case)
    td = ts.to_device("cpu")
    check_tables(js.to_device(), td)
    assert [k for k, g in GATES.items() if getattr(td, g)] == features
    assert td.tex_data.shape[0] > 1 and len(td.tex_meta[0]) == 6


def test_envmap_and_several_lights_refused(tmp_path):
    """Once refused on upload, now shaded: a JSON description with two
    emissive spheres and one with an envmap from a file upload with
    tables bit for bit the JAX package's (the name is kept from when the
    port refused them)."""
    lights = {"spheres": [
        {"center": [0, 0, 40], "radius": 4, "material": "light",
         "emission": [5, 5, 5]},
        {"center": [9, 0, 40], "radius": 4, "material": "light"}],
        "default_spheres": False}
    path = _write(tmp_path, "l.json", lights)
    sc = Scene.load(path)
    td = sc.to_device("cpu")
    assert td.light_indices == (0, 1) and td.n_tri_lights == 0
    check_tables(jdesc.load_description(path, builder="numpy")
                 .scene.to_device(), td)
    np.save(tmp_path / "env.npy", np.ones((4, 8, 3), np.float32))
    sc = Scene.load(None, envmap=str(tmp_path / "env.npy"))
    js = JScene.load(None, envmap=str(tmp_path / "env.npy"))
    assert sc.envmap.shape == (4, 8, 3)
    td = sc.to_device("cpu")
    assert td.has_envmap and td.env_meta == (4.0, 8.0)
    assert td.env_data.shape == (33, 4) and td.env_alias.shape == (32, 12)
    check_tables(js.to_device(), td)


# --------------------------------------------------------------------------
# malformed input: the same exception types
# --------------------------------------------------------------------------

_BAD = [  # (loader, file name, contents) of test_loader_robustness et al.
    ("ply", "a.ply", b"ply\nformat ascii 1.0\n"),
    ("ply", "b.ply", b"not a ply\n"),
    ("ply", "c.ply", b"ply\nformat binary_little_endian 1.0\n"
     b"element vertex 10\nproperty float x\nproperty float y\n"
     b"property float z\nend_header\n\x00\x00"),
    ("ply", "d.ply", PLY_HEAD + PLY_FACE + "end_header\n0 0 0\n"),
    ("glb", "a.glb", b"XXXX" + b"\x00" * 20),
    ("glb", "b.glb", b"glTF\x02\x00\x00\x00\xff\x00\x00\x00"),
    ("glb", "c.glb", b"glTF\x07\x00\x00\x00\x14\x00\x00\x00"),
    ("glb", "d.gltf", '{"asset":{"version":"2.0"},"buffers":[{"uri":'
     '"missing.bin","byteLength":4}],"scenes":[{"nodes":[]}],"scene":0}'),
    ("obj", "a.obj", "# nothing\n"),
    ("obj", "b.obj", "v 0 0 0\nf 1 2 9\n"),
    ("stl", "a.stl", b"x" * 80 + struct.pack("<I", 5) + b"\0" * 10),
    ("json", "a.json", {"mesh": []}),
    ("json", "b.json", {"spheres": [{"center": [0, 0, 0], "radius": 1,
                                     "material": "velvet"}]}),
    ("json", "c.json", {"instances": [{"mesh": 0}]}),
    ("json", "d.json", {"render": {"samples": 4}}),
    ("json", "e.json", {"meshes": [{"path": "absent.obj"}]}),
    ("json", "f.json", {"lights": [{"type": "laser"}]}),
]
_LOADERS = {"ply": (jply.load_ply, tply.load_ply),
            "glb": (jgltf.load_gltf, tgltf.load_gltf),
            "obj": (jobj.load_obj_scene, tobj.load_obj_scene),
            "stl": (jstl.load_stl, tstl.load_stl),
            "json": (jdesc.load_description, tdesc.load_description)}


@pytest.mark.parametrize("kind,name,data", _BAD,
                         ids=[f"{k}-{n}" for k, n, _ in _BAD])
def test_malformed_files_raise_alike(kind, name, data, tmp_path):
    path = _write(tmp_path, name, data)
    jload, tload = _LOADERS[kind]
    with pytest.raises(Exception) as want:
        jload(path)
    with pytest.raises(type(want.value)) as got:
        tload(path)
    assert str(got.value) == str(want.value)


def test_malformed_mtl_degrades_alike(tmp_path):
    _write(tmp_path, "m.mtl", "newmtl x\nKd not a number\n")
    path = _write(tmp_path, "c.obj", "mtllib m.mtl\nv 0 0 0\nv 1 0 0\n"
                  "v 0 1 0\nusemtl x\nf 1 2 3\n")
    same(jobj.load_obj_scene(path), tobj.load_obj_scene(path))
    assert tobj.load_obj_scene(path).faces.shape == (1, 3)


def test_interop_carries_a_loaded_scene(tmp_path):
    """A JAX SceneData of the loaded scene, carried over as numpy with its
    flags (interop.scene_from_numpy), equals the port's own upload."""
    from tyrant_tpu_torch import interop
    jd = jdesc.load_description(_asset_scene(tmp_path),
                                builder="numpy").scene.to_device()
    leaves = {k: np.asarray(getattr(jd.bvh, k)) for k in _BVH}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    td, tables = interop.scene_from_numpy(
        leaves, np.asarray(JPacketTables(jd.bvh).rows), "cpu",
        flags={k: getattr(jd, k) for k in interop.SCENE_FLAGS},
        aux={k: getattr(jd, k) for k in interop.SCENE_AUX})
    check_tables(jd, td)
    assert td.has_ggx and td.has_rrefr and td.has_var_ior \
        and td.smooth_normals
    with pytest.raises(ValueError, match="unknown scene flags"):
        interop.scene_from_numpy(leaves, np.asarray(tables.rows), "cpu",
                                 flags={"has_fog": True})


def test_instanced_closest_hit():
    """test_instancing's rays aimed at each of two instances hit at the
    transformed location, through the port's plain walk."""
    import torch

    from tyrant_tpu_torch.ops.traverse import closest_hit
    sd = Scene.from_instances([_tet(tinst)], [
        (0, np.eye(4)), (0, tinst.translate([10.0, 0, 0]))],
        builder="numpy").to_device("cpu")
    o = torch.tensor([[0.25, 0.25, 5.0], [10.25, 0.25, 5.0],
                      [5.0, 0.25, 5.0]])
    t, _ = closest_hit(o, torch.tensor([[0.0, 0.0, -1.0]] * 3), sd.bvh)
    t = t.numpy()
    assert t[0] < 1e19 and t[1] < 1e19
    np.testing.assert_allclose(t[0], t[1], rtol=1e-5)
    assert t[2] > 1e19
