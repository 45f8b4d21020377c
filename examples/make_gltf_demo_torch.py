"""Generate a self-contained demo .glb and render it with the PyTorch/CUDA
port; the counterpart of ``make_gltf_demo.py``.

Builds a small glTF 2.0 binary programmatically (no external assets): a
checker-textured ground, a ring of metallic/glass/diffuse boxes, an
emissive panel, two punctual lights and a camera — then renders it through
the port's CLI (scene/gltf.py loader).  The texture PNG is encoded with
zlib (``viewer._to_png_bytes``), so writing the file needs no Pillow; the
loader decodes textures with Pillow.

    python examples/make_gltf_demo_torch.py [--out demo.glb]
      [--render out.png] [--steps 64] [--device cuda]

The GLB exercises most of the loader surface: embedded PNG textures,
pbrMetallicRoughness, emissive + KHR_materials_emissive_strength,
KHR_materials_transmission, doubleSided, node TRS instancing, and
KHR_lights_punctual.
"""

import argparse
import json
import os
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tyrant_tpu_torch.viewer import _to_png_bytes as _png  # noqa: E402


def _box(sx, sy, sz):
    """Axis-aligned box as 8 verts + 12 tris (outward CCW winding)."""
    s = np.array([sx, sy, sz], np.float32) * 0.5
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * s
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # -x +x
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # -y +y
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # -z +z
    ], np.uint16)
    return v, f


def build_glb(path):
    blob = b""
    views = []

    def add(data, target=None):
        nonlocal blob
        blob += b"\0" * ((-len(blob)) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob += data
        return len(views) - 1

    accessors = []

    def acc(view, ctype, count, atype):
        accessors.append({"bufferView": view, "componentType": ctype,
                          "count": count, "type": atype})
        return len(accessors) - 1

    # ground: one quad with a generated checker texture
    g = 14.0
    gpos = np.array([[-g, 0, -g], [g, 0, -g], [g, 0, g], [-g, 0, g]],
                    np.float32)
    gidx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    guv = np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32)
    checker = np.zeros((64, 64, 3), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    checker[...] = np.where(((yy // 8 + xx // 8) % 2)[..., None],
                            np.array([235, 235, 235], np.uint8),
                            np.array([40, 44, 60], np.uint8))
    a_gpos = acc(add(gpos.tobytes()), 5126, 4, "VEC3")
    a_gidx = acc(add(gidx.tobytes()), 5123, 6, "SCALAR")
    a_guv = acc(add(guv.tobytes()), 5126, 4, "VEC2")
    bv_png = add(_png(checker))

    bv, bf = _box(1.0, 1.0, 1.0)
    a_bpos = acc(add(bv.tobytes()), 5126, len(bv), "VEC3")
    a_bidx = acc(add(bf.reshape(-1).tobytes()), 5123, bf.size, "SCALAR")
    pv, pf = _box(3.0, 2.0, 0.2)
    a_ppos = acc(add(pv.tobytes()), 5126, len(pv), "VEC3")
    a_pidx = acc(add(pf.reshape(-1).tobytes()), 5123, pf.size, "SCALAR")

    materials = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 1.0}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.95, 0.64, 0.3, 1],
                                  "metallicFactor": 1.0,
                                  "roughnessFactor": 0.15}},
        {"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                  "metallicFactor": 0.0},
         "extensions": {"KHR_materials_transmission":
                        {"transmissionFactor": 1.0}}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.25, 0.5, 0.9, 1],
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.8}},
        {"emissiveFactor": [1.0, 0.85, 0.6],
         "extensions": {"KHR_materials_emissive_strength":
                        {"emissiveStrength": 10.0}}},
    ]
    meshes = [
        {"primitives": [{"attributes": {"POSITION": a_gpos,
                                        "TEXCOORD_0": a_guv},
                         "indices": a_gidx, "material": 0}]},
        {"primitives": [{"attributes": {"POSITION": a_bpos},
                         "indices": a_bidx, "material": 1}]},
        {"primitives": [{"attributes": {"POSITION": a_bpos},
                         "indices": a_bidx, "material": 2}]},
        {"primitives": [{"attributes": {"POSITION": a_bpos},
                         "indices": a_bidx, "material": 3}]},
        {"primitives": [{"attributes": {"POSITION": a_ppos},
                         "indices": a_pidx, "material": 4}]},
    ]
    nodes = [{"mesh": 0}]
    # ring of boxes (mesh id cycles metal / glass / diffuse)
    for k in range(7):
        th = 2 * np.pi * k / 7
        q = [0.0, float(np.sin(th / 2)), 0.0, float(np.cos(th / 2))]
        nodes.append({"mesh": 1 + k % 3,
                      "translation": [4.5 * float(np.cos(th)), 0.75,
                                      4.5 * float(np.sin(th))],
                      "rotation": q,
                      "scale": [1.5, 1.5, 1.5]})
    # emissive panel standing at the back
    nodes.append({"mesh": 4, "translation": [0.0, 1.6, -7.0]})
    # punctual lights: warm point over the ring + a blue spot from the side
    lights = [
        {"type": "point", "color": [1.0, 0.7, 0.4], "intensity": 60.0},
        {"type": "spot", "color": [0.4, 0.6, 1.0], "intensity": 250.0,
         "spot": {"innerConeAngle": 0.25, "outerConeAngle": 0.45}},
    ]
    nodes.append({"translation": [0.0, 5.0, 0.0],
                  "extensions": {"KHR_lights_punctual": {"light": 0}}})
    # spot at (9, 6, 9) aimed at the origin: -Z -> normalize(-pos)
    d = np.array([-9.0, -6.0, -9.0])
    d /= np.linalg.norm(d)
    # rotation taking (0,0,-1) to d: axis-angle via quaternion
    z = np.array([0.0, 0.0, -1.0])
    axis = np.cross(z, d)
    c = float(z @ d)
    qw = float(np.sqrt((1 + c) / 2))
    qv = axis / max(2 * qw, 1e-9)
    nodes.append({"translation": [9.0, 6.0, 9.0],
                  "rotation": [float(qv[0]), float(qv[1]), float(qv[2]), qw],
                  "extensions": {"KHR_lights_punctual": {"light": 1}}})
    # camera on a crane looking into the ring
    cpos = np.array([10.0, 6.5, 10.0])
    fwd = -cpos / np.linalg.norm(cpos)
    axis = np.cross(z, fwd)
    c = float(z @ fwd)
    qw = float(np.sqrt((1 + c) / 2))
    qv = axis / max(2 * qw, 1e-9)
    nodes.append({"camera": 0, "translation": cpos.tolist(),
                  "rotation": [float(qv[0]), float(qv[1]), float(qv[2]), qw]})

    gltf = {
        "asset": {"version": "2.0", "generator": "tyrant_tpu_torch demo"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "images": [{"bufferView": bv_png, "mimeType": "image/png"}],
        "textures": [{"source": 0}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.8, "znear": 0.01}}],
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
        "extensionsUsed": ["KHR_lights_punctual",
                           "KHR_materials_emissive_strength",
                           "KHR_materials_transmission"],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    blob += b"\0" * ((-len(blob)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, total)
                + struct.pack("<I", len(js)) + b"JSON" + js
                + struct.pack("<I", len(blob)) + b"BIN\0" + blob)
    print(f"wrote {path} ({total} bytes)")


def render(glb, png, steps=64, width=640, height=400, rays=262144,
           device="cuda") -> None:
    """Render the .glb with ``cli render``."""
    from tyrant_tpu_torch.cli import main as cli_main
    cli_main(["render", "--scene", glb,
              "--width", str(width), "--height", str(height),
              "--rays", str(rays), "--steps", str(steps),
              "--out", png, "--device", device])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="demo.glb")
    ap.add_argument("--render", default=None, metavar="PNG",
                    help="also render the scene to this PNG")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--rays", type=int, default=262144)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    build_glb(args.out)
    if args.render:
        render(args.out, args.render, args.steps, args.width, args.height,
               args.rays, args.device)


if __name__ == "__main__":
    main()
