"""glTF 2.0 loader (.glb and .gltf) — pure numpy + PIL, no extra deps.

The port's own copy of the JAX package's loader; its arrays equal the
original's bit for bit (tests/test_torch_loaders.py).  It maps the glTF
scene graph onto the scene machinery:

  * meshes / primitives      -> ``instancing.MeshAsset`` (one per primitive)
  * node hierarchy           -> ``(mesh_id, world 4x4)`` instances, flattened
                                world-space by ``Scene.from_instances``
  * pbrMetallicRoughness     -> DIFF (metallic <= 0.5) or the GGX rough
                                conductor (metallic > 0.5, ``roughnessFactor``)
  * baseColorTexture         -> albedo atlas entry (sRGB-decoded)
  * metallicRoughnessTexture -> roughness map (G channel, linear)
  * normalTexture            -> tangent-space normal map (linear)
  * per-texel metalness      -> the mr texture's B channel (x factor)
                                drives a stochastic DIFF/GGX lobe pick
                                (appendix B mix(dielectric, metal, m))
  * COLOR_0 vertex colors    -> per-triangle mean albedo x base color
                                (flat; same policy as PLY scanned colors)
  * sampler wrap modes       -> repeat / clamp-to-edge / mirrored repeat
                                per texture (static select in the tap)
  * KHR_texture_transform    -> baked into the per-triangle UVs at load
                                (one transform per primitive: baseColor's
                                wins if slots disagree)
  * emissiveFactor (x KHR_materials_emissive_strength) -> LIGHT triangles
                                (area lights with NEE); emissiveTexture
                                modulates direct-hit emission
  * alphaMode "MASK"         -> combined rgb+alpha atlas entry (the map_d
                                0.5-cutout path)
  * alphaMode "BLEND"        -> stochastic transparency: shade with
                                probability alpha, pass through with 1-alpha
                                (unbiased; constant baseColorFactor alpha
                                rides a synthesized 1x1 texel)
  * KHR_materials_transmission (factor > 0.5) -> REFR glass, or the
                                RREFR frosted-glass BSDF when
                                roughnessFactor > 0.05
  * KHR_materials_ior         -> per-triangle glass eta for smooth REFR
                                (rough glass keeps the reference's 1.2)
  * doubleSided              -> a flipped-winding duplicate of each triangle
                                (traversal backface-culls per the reference,
                                loader.h:28; the duplicate restores two-sided
                                visibility at 2x triangle cost)
  * KHR_lights_punctual      -> DeltaLights (point / spot / directional)
  * the first camera node    -> a ``Camera`` pose (position + look direction)

Axis convention: glTF is +Y-up right-handed; this framework's sky model is
+Z-up (sky.py, sunsky.cu:5).  ``y_up_to_z_up=True`` (default) rotates the
whole scene by +90 deg about X — (x, y, z) -> (x, -z, y) — so glTF "up"
agrees with the atmosphere's.

Not supported (documented degradations): the dielectric specular lobe
(the 0.04-F0 half of dielectric_brdf — non-metal texels shade pure
DIFF), per-texture-slot UV transforms
(see KHR_texture_transform above), skinning /
morph targets / animations (static pose only), TEXCOORD_1,
non-TRIANGLES primitive modes (raised), baseColorFactor alpha combined
with a base texture (texel alpha wins under BLEND),
``alphaCutoff`` values other than 0.5 (the shade-time cutout threshold is
fixed, render.py PASS pseudo-material).
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import struct
from typing import Optional

import numpy as np

# material codes (scene.scene; duplicated to avoid a circular import, like
# scene/obj.py does)
_DIFF, _SPEC, _REFR, _PHONG, _LIGHT, _GGX, _RREFR = 0, 1, 2, 3, 4, 5, 8

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_LANES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}

# +90 deg about X: glTF +Y (up) -> +Z (this framework's up, sky.py)
_YUP_TO_ZUP = np.array([[1.0, 0.0, 0.0],
                        [0.0, 0.0, -1.0],
                        [0.0, 1.0, 0.0]], np.float64)


@dataclasses.dataclass
class GltfScene:
    """Everything extracted from one glTF file, in this framework's terms."""

    meshes: list                       # [instancing.MeshAsset]
    instances: list                    # [(mesh_id, world [4,4])]
    lights: list                       # DeltaLights spec dicts (may be [])
    camera: Optional[dict] = None      # {"position", "target", "yfov_deg"}
    # shared texture images; tri_tex/tri_ntex/tri_rtex ids in ALL assets
    # index this one list (assets carry textures=None — see load_gltf)
    textures: Optional[list] = None
    # per-texture (wrapS, wrapT) parallel to ``textures``: 0 repeat,
    # 1 clamp-to-edge, 2 mirrored repeat (glTF sampler modes)
    tex_wraps: Optional[list] = None


def _read_glb(path: str):
    """GLB container: 12-byte header + (length, type, data) chunks."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"glTF":
        raise ValueError(f"{path}: not a GLB file (bad magic)")
    version, total = struct.unpack_from("<II", data, 4)
    if version != 2:
        raise ValueError(f"{path}: GLB version {version}, only 2 supported")
    off = 12
    gltf = None
    bin_chunk = None
    while off + 8 <= min(total, len(data)):
        clen, ctype = struct.unpack_from("<I4s", data, off)
        chunk = data[off + 8:off + 8 + clen]
        if ctype == b"JSON":
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == b"BIN\x00" and bin_chunk is None:
            bin_chunk = chunk
        off += 8 + clen + ((4 - clen % 4) % 4 if clen % 4 else 0)
    if gltf is None:
        raise ValueError(f"{path}: GLB has no JSON chunk")
    return gltf, bin_chunk


def _load_buffers(gltf: dict, base_dir: str, bin_chunk):
    bufs = []
    for i, b in enumerate(gltf.get("buffers", [])):
        uri = b.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError(f"buffer {i}: no uri and no GLB BIN chunk")
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            bufs.append(base64.b64decode(b64))
        else:
            from urllib.parse import unquote
            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(gltf: dict, bufs, idx: int) -> np.ndarray:
    """Decode accessor ``idx`` to a [count, lanes] array (denormalised to
    f32 for normalized integer attributes)."""
    acc = gltf["accessors"][idx]
    lanes = _TYPE_LANES[acc["type"]]
    dt = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]
    itemsize = dt.itemsize * lanes

    if "bufferView" in acc:
        bv = gltf["bufferViews"][acc["bufferView"]]
        buf = bufs[bv.get("buffer", 0)]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or itemsize
        if stride == itemsize:
            arr = np.frombuffer(buf, dt, count * lanes, start)
            arr = arr.reshape(count, lanes).copy()
        else:
            nbytes = stride * (count - 1) + itemsize
            raw = np.frombuffer(buf, np.uint8, nbytes, start)
            take = (np.arange(count)[:, None] * stride
                    + np.arange(itemsize)).reshape(-1)
            arr = raw[take].copy().view(dt).reshape(count, lanes)
    else:
        arr = np.zeros((count, lanes), dt)

    sp = acc.get("sparse")
    if sp:
        sidx = _sparse_array(gltf, bufs, sp["indices"], sp["count"],
                             np.dtype(_COMPONENT_DTYPES[
                                 sp["indices"]["componentType"]]), 1)
        svals = _sparse_array(gltf, bufs, sp["values"], sp["count"], dt,
                              lanes)
        arr[sidx.reshape(-1).astype(np.int64)] = svals

    if acc.get("normalized") and dt.kind in "iu":
        info = np.iinfo(dt)
        arr = arr.astype(np.float32) / float(info.max)
        if dt.kind == "i":
            arr = np.maximum(arr, -1.0)
    return arr


def _sparse_array(gltf, bufs, spec, count, dt, lanes):
    bv = gltf["bufferViews"][spec["bufferView"]]
    buf = bufs[bv.get("buffer", 0)]
    start = bv.get("byteOffset", 0) + spec.get("byteOffset", 0)
    return np.frombuffer(buf, dt, count * lanes, start).reshape(count, lanes)


def _decode_image(gltf: dict, bufs, base_dir: str, img_idx: int,
                  srgb: bool, want_alpha: bool = False) -> np.ndarray:
    """Decode image source ``img_idx`` to [H, W, 3|4] f32."""
    from PIL import Image
    img = gltf["images"][img_idx]
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        raw = bufs[bv.get("buffer", 0)][bv.get("byteOffset", 0):
                                        bv.get("byteOffset", 0)
                                        + bv["byteLength"]]
        pil = Image.open(io.BytesIO(raw))
    else:
        uri = img["uri"]
        if uri.startswith("data:"):
            pil = Image.open(io.BytesIO(base64.b64decode(
                uri.split(",", 1)[1])))
        else:
            from urllib.parse import unquote
            pil = Image.open(os.path.join(base_dir, unquote(uri)))
    with pil:
        mode = "RGBA" if want_alpha else "RGB"
        arr = np.asarray(pil.convert(mode), np.uint8).astype(np.float32)
    arr /= 255.0
    if srgb:
        # match scene/texture.load_texture: gamma-2.2 decode of the colour
        # channels; alpha (coverage) stays linear
        arr[..., :3] = arr[..., :3] ** 2.2
    return arr


def _trs_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF matrices are column-major
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[0, 0], m[1, 1], m[2, 2] = node["scale"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _material_record(gltf: dict, mat_idx: Optional[int]) -> dict:
    """Flatten one glTF material to the fields the shade path consumes."""
    rec = {"refl": _DIFF, "color": (1.0, 1.0, 1.0), "rough": 1.0,
           "base_tex": None, "mr_tex": None, "n_tex": None,
           "alpha_mask": False, "blend": False, "alpha": 1.0,
           "metallic": 1.0, "ior": None,
           "double_sided": False, "uv_xform": None}
    if mat_idx is None:
        return rec
    m = gltf["materials"][mat_idx]
    rec["double_sided"] = bool(m.get("doubleSided", False))
    pbr = m.get("pbrMetallicRoughness", {})
    bc = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    rec["color"] = tuple(float(c) for c in bc[:3])
    rec["alpha"] = float(bc[3]) if len(bc) > 3 else 1.0
    metallic = float(pbr.get("metallicFactor", 1.0))
    rec["metallic"] = metallic
    rec["rough"] = float(pbr.get("roughnessFactor", 1.0))
    if "baseColorTexture" in pbr:
        rec["base_tex"] = pbr["baseColorTexture"]["index"]
    if "metallicRoughnessTexture" in pbr:
        rec["mr_tex"] = pbr["metallicRoughnessTexture"]["index"]
    if "normalTexture" in m:
        rec["n_tex"] = m["normalTexture"]["index"]
    # KHR_texture_transform: one transform per PRIMITIVE (UVs are baked
    # per-triangle at load, shared by every texture slot), taken from the
    # first slot carrying it in baseColor > normal > metallicRoughness
    # order — differing per-slot transforms are a documented degradation
    for info in (pbr.get("baseColorTexture"), m.get("normalTexture"),
                 pbr.get("metallicRoughnessTexture"),
                 m.get("emissiveTexture")):
        tt = (info or {}).get("extensions", {}).get("KHR_texture_transform")
        if tt is not None:
            rec["uv_xform"] = (tuple(tt.get("offset", (0.0, 0.0))),
                               float(tt.get("rotation", 0.0)),
                               tuple(tt.get("scale", (1.0, 1.0))))
            break
    if m.get("alphaMode", "OPAQUE") in ("MASK", "BLEND"):
        rec["alpha_mask"] = True
        # BLEND -> stochastic transparency (render.py): shade with
        # probability alpha instead of the 0.5 MASK cutout
        rec["blend"] = m["alphaMode"] == "BLEND"

    ext = m.get("extensions", {})
    emissive = np.asarray(m.get("emissiveFactor", (0.0, 0.0, 0.0)),
                          np.float64)
    emissive = emissive * float(ext.get(
        "KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0))
    transmission = float(ext.get(
        "KHR_materials_transmission", {}).get("transmissionFactor", 0.0))
    if "KHR_materials_ior" in ext:
        # the extension's own default is 1.5; absent extension keeps the
        # reference's 1.2 (render.py REFR) for golden parity
        rec["ior"] = float(ext["KHR_materials_ior"].get("ior", 1.5))
    if emissive.max() > 0.0:
        rec["refl"] = _LIGHT
        rec["color"] = tuple(float(c) for c in emissive)
        if "emissiveTexture" in m:
            # texture-modulated area light: the emissive texel rides the
            # albedo slot (LIGHT triangles emit color_tri = factor x
            # texel on direct hits, render.py); NEE and the power table
            # integrate factor x texture MEAN (scene.py), so both MIS
            # strategies agree on total power — per-point NEE texel
            # lookup would need UVs in the light rows (documented
            # approximation)
            rec["base_tex"] = m["emissiveTexture"]["index"]
    elif transmission > 0.5:
        # roughnessFactor > ~0 makes the glass frosted (RREFR: the REFR
        # math through a VNDF-sampled microfacet, render.py)
        rec["refl"] = _REFR if rec["rough"] < 0.05 else _RREFR
    elif metallic > 0.5:
        rec["refl"] = _GGX
    return rec


def load_gltf(path: str, y_up_to_z_up: bool = True,
              scale: float = 1.0) -> GltfScene:
    """Parse a .glb / .gltf file into meshes + instances + lights + camera."""
    from .instancing import MeshAsset

    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, bin_chunk = _read_glb(path)
    else:
        with open(path, "r", encoding="utf-8") as f:
            gltf = json.load(f)
        bin_chunk = None
    bufs = _load_buffers(gltf, base_dir, bin_chunk)

    # image sources any MASK/BLEND material taps for coverage: these decode
    # once as RGBA; an OPAQUE material sharing the image reuses the same
    # atlas entry when nothing can be cut at the 0.5 threshold, else gets
    # its own alpha-neutralised copy (glTF says OPAQUE ignores alpha)
    alpha_srcs = set()
    for m in gltf.get("materials", []):
        if m.get("alphaMode", "OPAQUE") in ("MASK", "BLEND"):
            bct = m.get("pbrMetallicRoughness", {}).get("baseColorTexture")
            if bct is not None and bct["index"] < len(gltf.get("textures",
                                                               [])):
                src = gltf["textures"][bct["index"]].get("source")
                if src is not None:
                    alpha_srcs.add(src)

    # --- textures: decode lazily, dedup by (image index, decode mode) ---
    textures: list = []
    tex_wraps: list = []   # (wrapS, wrapT) parallel to ``textures``
    tex_cache: dict = {}
    raw_cache: dict = {}
    _WRAP = {10497: 0, 33071: 1, 33648: 2}  # repeat / clamp / mirror

    def _sampler_wraps(tex_idx: int):
        smp_i = gltf["textures"][tex_idx].get("sampler")
        if smp_i is None:
            return (0, 0)
        smp = gltf.get("samplers", [])[smp_i]
        return (_WRAP.get(smp.get("wrapS", 10497), 0),
                _WRAP.get(smp.get("wrapT", 10497), 0))

    def texture_id(tex_idx: Optional[int], mode: str,
                   metal_factor: float = 1.0) -> int:
        """mode: 'srgb' (albedo), 'srgba' (albedo+coverage), 'linear'
        (normal map), 'rough_g' (metallicRoughness repacked as
        ch0 = G roughness, ch1 = B metalness x metallicFactor)."""
        if tex_idx is None:
            return -1
        src = gltf["textures"][tex_idx].get("source")
        if src is None:
            return -1
        wr = _sampler_wraps(tex_idx)
        # wraps join the dedup key: two textures sharing an image under
        # different samplers need separate atlas entries
        key = (src, mode, round(metal_factor, 5), wr) if mode == "rough_g" \
            else (src, mode, wr)
        try:
            if mode in ("srgb", "srgba") and src in alpha_srcs:
                if src not in raw_cache:  # one decode for both users
                    raw_cache[src] = _decode_image(gltf, bufs, base_dir,
                                                   src, srgb=True,
                                                   want_alpha=True)
                img = raw_cache[src]
                if mode == "srgb" and float(img[:, :, 3].min()) < 0.5:
                    img = img.copy()
                    img[:, :, 3] = 1.0  # OPAQUE user: neutralise cutout
                else:
                    key = (src, "srgba", wr)  # fully-opaque alpha: shareable
                if key in tex_cache:
                    return tex_cache[key]
            elif key in tex_cache:
                return tex_cache[key]
            elif mode == "rough_g":
                img = _decode_image(gltf, bufs, base_dir, src, srgb=False)
                # glTF packs roughness in G, metalness in B: the shade
                # path reads roughness from channel 0 and per-texel
                # metalness (x metallicFactor, baked here) from channel 1
                # of the SAME texel row (render.py — zero extra gathers)
                img = np.stack([img[:, :, 1],
                                img[:, :, 2] * np.float32(metal_factor),
                                img[:, :, 1]], axis=2)
            elif mode == "srgba":
                img = _decode_image(gltf, bufs, base_dir, src, srgb=True,
                                    want_alpha=True)
            else:
                img = _decode_image(gltf, bufs, base_dir, src,
                                    srgb=(mode == "srgb"))
            tex_cache[key] = len(textures)
            textures.append(np.ascontiguousarray(img))
            tex_wraps.append(wr)
        except Exception as e:  # undecodable image: degrade like obj.py
            import sys
            print(f"warning: glTF texture {src} failed to decode "
                  f"({e}); shading untextured", file=sys.stderr)
            tex_cache[key] = -1
        return tex_cache[key]

    # --- meshes: one MeshAsset per (mesh, primitive) ---
    assets: list = []
    mesh_asset_ids: list = []  # per glTF mesh: list of asset indices
    for mesh in gltf.get("meshes", []):
        ids = []
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            if mode != 4:
                raise ValueError(
                    f"{path}: primitive mode {mode} unsupported "
                    "(only TRIANGLES)")
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, bufs, attrs["POSITION"])
            # NB: ``scale`` is folded into the ROOT matrix (below), not the
            # vertices — node translations, lights and the camera must all
            # scale together or the layout distorts
            pos = pos[:, :3].astype(np.float32)
            if "indices" in prim:
                faces = _read_accessor(gltf, bufs, prim["indices"])
                faces = faces.reshape(-1).astype(np.int64)
            else:
                faces = np.arange(pos.shape[0], dtype=np.int64)
            faces = faces[:faces.shape[0] - faces.shape[0] % 3]
            faces = faces.reshape(-1, 3)
            n_tris = faces.shape[0]
            if n_tris == 0:
                continue

            rec = _material_record(gltf, prim.get("material"))

            uv = None
            if "TEXCOORD_0" in attrs:
                vt = _read_accessor(gltf, bufs, attrs["TEXCOORD_0"])
                vt = vt[:, :2].astype(np.float32)
                if rec["uv_xform"] is not None:
                    # KHR_texture_transform in glTF UV space (before the
                    # v-flip below): uv' = T(offset) R(rot) S(scale) [u,v,1]
                    # with R = [[c,s],[-s,c]] (Khronos sample-viewer matrix)
                    (ou, ov), rot, (su, sv) = rec["uv_xform"]
                    c, s = np.cos(rot), np.sin(rot)
                    u_s, v_s = su * vt[:, 0], sv * vt[:, 1]
                    vt = np.stack([c * u_s + s * v_s + ou,
                                   -s * u_s + c * v_s + ov],
                                  axis=1).astype(np.float32)
                # glTF v runs top-down; the atlas sampler flips v at sample
                # time for OBJ's bottom-up convention (texture.py), so
                # pre-flip here to land in OBJ convention
                vt = np.stack([vt[:, 0], 1.0 - vt[:, 1]], axis=1)
                uv = vt[faces]                      # [T, 3, 2]
            vn = None
            if "NORMAL" in attrs:
                nr = _read_accessor(gltf, bufs, attrs["NORMAL"])
                vn = nr[:, :3].astype(np.float32)[faces]  # [T, 3, 3]
            vcol = None
            if "COLOR_0" in attrs:
                # vertex colors are linear per spec (normalized u8/u16
                # decode in _read_accessor); shaded as per-triangle mean
                # albedo multiplied into the base color factor (flat —
                # same policy as PLY scanned colors, scene/scene.py)
                vc = _read_accessor(gltf, bufs, attrs["COLOR_0"])
                vcol = vc[:, :3].astype(np.float32)[faces].mean(axis=1)

            tex = texture_id(rec["base_tex"],
                             "srgba" if rec["alpha_mask"] else "srgb")
            blend_on = rec["blend"] and rec["refl"] in (_DIFF, _GGX)
            if blend_on and tex < 0 and rec["alpha"] < 1.0:
                # constant-alpha BLEND with no base texture: a shared 1x1
                # white RGBA texel carries the factor alpha (the coverage
                # taps shade already pays; rgb=1 keeps the color factor).
                # LIMITATION: with a base texture, the factor alpha is
                # ignored (texel alpha wins) — scaling would need a
                # per-material texture copy.
                key = ("const_alpha", round(rec["alpha"], 6))
                if key not in tex_cache:
                    tex_cache[key] = len(textures)
                    textures.append(np.asarray(
                        [[[1.0, 1.0, 1.0, rec["alpha"]]]], np.float32))
                    tex_wraps.append((0, 0))
                tex = tex_cache[key]
                if uv is None:
                    # the atlas taps need UVs; for a 1x1 texel any
                    # parameterisation works
                    uv = np.zeros((n_tris, 3, 2), np.float32)
            blend_on = blend_on and tex >= 0
            ntex = texture_id(rec["n_tex"], "linear")
            # per-texel metalness (glTF appendix B: material =
            # mix(dielectric, metal, metalness)): a DIFF/GGX primitive
            # with a metallicRoughness texture and metallicFactor > 0
            # becomes a stochastic DIFF/GGX mixture — shade picks the
            # conductor lobe with probability metalness (texel B x
            # factor, baked into the repacked map's channel 1)
            metal_on = (rec["mr_tex"] is not None
                        and rec["refl"] in (_DIFF, _GGX)
                        and rec["metallic"] > 0.0)
            if metal_on:
                rec["refl"] = _GGX  # engages roughness taps + GGX machinery
            rtex = (texture_id(rec["mr_tex"], "rough_g",
                               metal_factor=rec["metallic"]
                               if metal_on else 1.0)
                    if rec["refl"] in (_GGX, _RREFR) else -1)
            metal_on = metal_on and rtex >= 0

            v0 = pos[faces[:, 0]]
            v1 = pos[faces[:, 1]]
            v2 = pos[faces[:, 2]]
            if rec["double_sided"] and rec["refl"] != _LIGHT:
                # traversal backface-culls (loader.h:28 parity); a flipped-
                # winding duplicate restores two-sided visibility.  LIGHT
                # primitives skip it: emissive triangles are already
                # two-sided in shade (NEE flips the emitter normal toward
                # the shading point, render.py), so a duplicate would
                # double-count their power in NEE
                v0 = np.concatenate([v0, v0])
                v1, v2 = (np.concatenate([v1, v2]),
                          np.concatenate([v2, v1]))
                if uv is not None:
                    uv = np.concatenate([uv, uv[:, [0, 2, 1]]])
                if vn is not None:
                    vn = np.concatenate([vn, -vn[:, [0, 2, 1]]])
                if vcol is not None:
                    vcol = np.concatenate([vcol, vcol])
                n_tris *= 2

            base_col = np.tile(np.asarray(rec["color"], np.float32),
                               (n_tris, 1))
            if vcol is not None and rec["refl"] != _LIGHT:
                base_col = base_col * vcol
            asset = MeshAsset(
                v0=v0, v1=v1, v2=v2,
                tri_refl=np.full(n_tris, rec["refl"], np.int32),
                tri_color=base_col,
                tri_rough=np.full(n_tris,
                                  max(0.03, min(rec["rough"], 1.0)),
                                  np.float32),
                tri_uv=uv,
                tri_tex=(np.full(n_tris, tex, np.int32)
                         if tex >= 0 else None),
                tri_ntex=(np.full(n_tris, ntex, np.int32)
                          if ntex >= 0 else None),
                tri_rtex=(np.full(n_tris, rtex, np.int32)
                          if rtex >= 0 else None),
                textures=None,
                tri_vn=vn,
                tri_blend=(np.full(n_tris, True)
                           if blend_on else None),
                tri_metal=(np.full(n_tris, True)
                           if metal_on else None),
                tri_ior=(np.full(n_tris, rec["ior"], np.float32)
                         if rec["ior"] is not None
                         and rec["refl"] in (_REFR, _RREFR) else None))
            ids.append(len(assets))
            assets.append(asset)
        mesh_asset_ids.append(ids)

    # NB: texture ids in tri_tex/tri_ntex/tri_rtex are GLOBAL into
    # ``textures``; assets carry textures=None so flatten_instances'
    # per-mesh id offsetting (instancing.py) is a no-op, and the caller
    # attaches the shared list to the flattened result (load_gltf_bundle).

    # --- scene graph walk: instances + lights + camera ---
    root = np.eye(4)
    root[:3, :3] = ((_YUP_TO_ZUP if y_up_to_z_up else np.eye(3))
                    * float(scale))
    instances: list = []
    lights: list = []
    camera: Optional[dict] = None
    ext_lights = (gltf.get("extensions", {})
                  .get("KHR_lights_punctual", {}).get("lights", []))

    def walk(node_idx: int, parent: np.ndarray):
        nonlocal camera
        node = gltf["nodes"][node_idx]
        world = parent @ _trs_matrix(node)
        if "mesh" in node:
            for aid in mesh_asset_ids[node["mesh"]]:
                instances.append((aid, world.copy()))
        light_idx = (node.get("extensions", {})
                     .get("KHR_lights_punctual", {}).get("light"))
        if light_idx is not None and light_idx < len(ext_lights):
            lights.append(_punctual_spec(ext_lights[light_idx], world))
        if "camera" in node and camera is None:
            cam_def = gltf.get("cameras", [])
            if node["camera"] < len(cam_def):
                pos = world[:3, 3]
                fwd = world[:3, :3] @ np.array([0.0, 0.0, -1.0])
                n = np.linalg.norm(fwd)
                persp = cam_def[node["camera"]].get("perspective", {})
                camera = {
                    "position": pos.astype(np.float32).tolist(),
                    "target": (pos + fwd / max(n, 1e-12)).astype(
                        np.float32).tolist(),
                    "yfov_deg": float(np.degrees(
                        persp.get("yfov", np.radians(70.0)))),
                }
        for child in node.get("children", []):
            walk(child, world)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [])
    if scene_idx < len(scenes):
        roots = scenes[scene_idx].get("nodes", [])
    else:
        # no usable "scenes" entry: walk every node that is not some other
        # node's child (walking ALL nodes would visit children twice, once
        # with the parent transform and once spuriously from the origin)
        children = {c for nd in gltf.get("nodes", [])
                    for c in nd.get("children", [])}
        roots = [i for i in range(len(gltf.get("nodes", [])))
                 if i not in children]
    for n in roots:
        walk(n, root)

    return GltfScene(meshes=assets, instances=instances, lights=lights,
                     camera=camera, textures=textures or None,
                     tex_wraps=tex_wraps or None)


def _punctual_spec(light: dict, world: np.ndarray) -> dict:
    """KHR_lights_punctual -> DeltaLights spec dict (scene.DeltaLights)."""
    color = np.asarray(light.get("color", (1.0, 1.0, 1.0)), np.float64)
    intensity = float(light.get("intensity", 1.0))
    rgb = (color * intensity).tolist()
    pos = world[:3, 3].tolist()
    # punctual lights emit down the node's -Z
    d = world[:3, :3] @ np.array([0.0, 0.0, -1.0])
    d = (d / max(np.linalg.norm(d), 1e-12)).tolist()
    kind = light.get("type", "point")
    if kind == "point":
        return {"type": "point", "position": pos, "intensity": rgb}
    if kind == "directional":
        return {"type": "directional", "direction": d, "intensity": rgb}
    spot = light.get("spot", {})
    outer = np.degrees(float(spot.get("outerConeAngle", np.pi / 4)))
    outer = min(outer, 89.9)
    inner = min(np.degrees(float(spot.get("innerConeAngle", 0.0))), outer)
    return {"type": "spot", "position": pos, "direction": d,
            "intensity": rgb, "inner_deg": inner, "outer_deg": outer}


def load_gltf_asset(path: str, scale: float = 1.0,
                    y_up_to_z_up: bool = True):
    """One instanceable ``MeshAsset`` from a glTF file: the whole scene
    graph pre-flattened (instancing.MeshAsset.load's .glb/.gltf branch, so
    JSON scene descriptions can instance glTF assets under further
    transforms)."""
    from .instancing import flatten_instances

    g = load_gltf(path, y_up_to_z_up=y_up_to_z_up, scale=scale)
    if not g.instances:
        raise ValueError(f"{path}: no renderable TRIANGLES instances")
    flat = flatten_instances(g.meshes, g.instances)
    # load_gltf's texture ids are global into g.textures (every sub-asset
    # carries textures=None, so flatten applied zero offsets); attaching
    # the list here makes those ids LOCAL to this merged asset, which is
    # exactly what a second flatten_instances pass expects
    flat.textures = g.textures
    flat.tex_wraps = g.tex_wraps
    return flat


def load_gltf_bundle(path: str, builder: str = "auto", scale: float = 1.0,
                     y_up_to_z_up: bool = True, bvh_cfg=None):
    """Build a ready-to-render SceneBundle (scene + optional camera) the
    same shape the JSON description loader returns (description.py), so
    the CLI and API treat .glb/.gltf like any other composed scene."""
    from ..camera import Camera
    from .description import SceneBundle
    from .scene import DeltaLights, Scene, Spheres

    from .instancing import flatten_instances

    g = load_gltf(path, y_up_to_z_up=y_up_to_z_up, scale=scale)
    if not g.instances:
        raise ValueError(f"{path}: no renderable TRIANGLES instances")
    dl = DeltaLights.from_specs(g.lights) if g.lights else None
    # glTF scenes carry their own content: no reference spheres.  The
    # atmosphere still lights light-less files (sun NEE is always active).
    empty = np.zeros((0, 3), np.float32)
    spheres = Spheres(center=empty, radius=np.zeros(0, np.float32),
                      color=empty.copy(), emission=empty.copy(),
                      refl=np.zeros(0, np.int32))
    if bvh_cfg is None:
        from ..config import BVHConfig
        bvh_cfg = BVHConfig()
    flat = flatten_instances(g.meshes, g.instances)
    scene = Scene.from_triangles(
        flat.v0, flat.v1, flat.v2, spheres=spheres, builder=builder,
        bvh_cfg=bvh_cfg,
        tri_refl=flat.tri_refl, tri_color=flat.tri_color,
        tri_uv=flat.tri_uv, tri_tex=flat.tri_tex,
        textures=g.textures,  # global ids: see load_gltf
        texture_wraps=g.tex_wraps,
        tri_vn=flat.tri_vn, tri_rough=flat.tri_rough,
        tri_ntex=flat.tri_ntex, tri_rtex=flat.tri_rtex,
        tri_blend=flat.tri_blend,
        tri_metal=flat.tri_metal,
        tri_ior=flat.tri_ior,
        delta_lights=dl)
    scene.stats["instances"] = len(g.instances)
    scene.stats["unique_meshes"] = len(g.meshes)
    camera = None
    if g.camera is not None:
        camera = Camera()
        camera.position = np.asarray(g.camera["position"], np.float32)
        camera.look_at(g.camera["target"])
    return SceneBundle(scene=scene, camera=camera)
