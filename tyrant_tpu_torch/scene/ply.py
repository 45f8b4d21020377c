"""PLY mesh loader (pure numpy; ``native/ply_loader.cpp`` is the fast
path for positions and faces).

Supports ascii 1.0 and binary_little_endian 1.0, arbitrary extra vertex
properties (skipped, or read as normals and colours by
:func:`load_ply_attrs`), and polygon faces, fan-triangulated.

The port's own copy of the JAX package's loader; its arrays equal the
original's bit for bit (tests/test_torch_loaders.py).
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _strip_comment(line: str) -> str:
    # cube.ply uses `{ ... }` trailing comments on header lines
    if "{" in line:
        line = line[:line.index("{")]
    return line.strip()


def load_ply(path: str):
    """Returns (vertices [V,3] float32, faces [F,3] int32)."""
    return load_ply_attrs(path)[:2]


def load_ply_full(path: str):
    """Returns (vertices [V,3] f32, faces [F,3] i32, normals [V,3] f32 or
    None).  Vertex normals (nx/ny/nz properties) feed smooth shading
    (beyond-reference: the reference requests Assimp GenSmoothNormals,
    Scene.cpp:5, then never reads the result, static_mesh.cpp:18)."""
    return load_ply_attrs(path)[:3]


def load_ply_attrs(path: str):
    """Returns (vertices, faces, normals or None, colors [V,3] f32 or
    None).  Vertex colors (``red/green/blue`` properties — the standard
    scanned-mesh attribute) decode to LINEAR light: 8-bit values are
    treated as sRGB (gamma-2.2, matching scene/texture.load_texture),
    float values as already linear."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for raw in header.splitlines():
        line = _strip_comment(raw)
        if not line:
            continue
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                continue
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_TYPES[parts[3]], True,
                                        _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False,
                                        None))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")

    vertices = None
    normals = None
    colors = None
    faces = []

    def _decode_colors(stacked, dtype):
        c = stacked.astype(np.float32)
        dt = np.dtype(dtype)
        if dt.kind in "iu":
            c = c / float(np.iinfo(dt).max)
            if dt.itemsize == 1:
                c = c ** 2.2  # 8-bit scanner colors are sRGB
            # 16/32-bit integer colors are conventionally already linear
        return c

    if fmt == "ascii":
        # cube.ply carries `{ ... }` comments on body lines too
        if b"{" in body:
            body = b"\n".join(
                line[:line.index(b"{")] if b"{" in line else line
                for line in body.splitlines())
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(tokens[pos:pos + count * width], dtype=np.float32)
                arr = arr.reshape(count, width)
                names = [p[0] for p in props]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                vertices = arr[:, [xi, yi, zi]].astype(np.float32)
                if all(k in names for k in ("nx", "ny", "nz")):
                    normals = arr[:, [names.index("nx"), names.index("ny"),
                                      names.index("nz")]].astype(np.float32)
                if all(k in names for k in ("red", "green", "blue")):
                    ri = names.index("red")
                    colors = _decode_colors(
                        arr[:, [ri, names.index("green"),
                                names.index("blue")]],
                        props[ri][1])
                pos += count * width
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    idx = [int(t) for t in tokens[pos:pos + n]]
                    pos += n
                    for k in range(1, n - 1):  # fan triangulation
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                # skip unknown element (assume non-list scalar rows)
                pos += count * len(props)
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex" and not any(p[2] for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                vertices = np.stack([arr["x"], arr["y"], arr["z"]],
                                    axis=1).astype(np.float32)
                if all(k in dt.names for k in ("nx", "ny", "nz")):
                    normals = np.stack([arr["nx"], arr["ny"], arr["nz"]],
                                       axis=1).astype(np.float32)
                if all(k in dt.names for k in ("red", "green", "blue")):
                    colors = _decode_colors(
                        np.stack([arr["red"], arr["green"], arr["blue"]],
                                 axis=1),
                        dt["red"])
            elif name == "face":
                # faces: one list property (vertex indices)
                lp = [p for p in props if p[2]][0]
                cnt_dt = np.dtype("<" + lp[3])
                idx_dt = np.dtype("<" + lp[1])
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, idx_dt, n, off).astype(np.int64)
                    off += idx_dt.itemsize * n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                # generic skip (handles list props row by row)
                if any(p[2] for p in props):
                    for _ in range(count):
                        for pname, pdt, is_list, cnt_t in props:
                            if is_list:
                                cdt = np.dtype("<" + cnt_t)
                                n = int(np.frombuffer(body, cdt, 1, off)[0])
                                off += cdt.itemsize + np.dtype("<" + pdt).itemsize * n
                            else:
                                off += np.dtype("<" + pdt).itemsize
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    off += dt.itemsize * count

    if vertices is None:
        raise ValueError(f"{path}: no vertex element")
    return (vertices, np.asarray(faces, dtype=np.int32).reshape(-1, 3),
            normals, colors)
