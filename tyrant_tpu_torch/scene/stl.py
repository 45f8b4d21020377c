"""STL loader (binary + ASCII, pure numpy).

STL stores a bare triangle soup (no shared vertex indexing), so loading
deduplicates exact-equal vertices to produce the (vertices, faces) form
the rest of the pipeline expects.

The port's own copy of the JAX package's loader; its arrays equal the
original's bit for bit (tests/test_torch_loaders.py).
"""

from __future__ import annotations

import numpy as np


def _dedup(tris: np.ndarray):
    """[F, 3, 3] triangle soup -> (vertices [V,3] f32, faces [F,3] i32),
    joining bitwise-identical vertices (Assimp JoinIdenticalVertices)."""
    flat = tris.reshape(-1, 3).astype(np.float32)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces (repeated vertex after dedup)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]


def load_stl(path: str):
    """Returns (vertices [V,3] float32, faces [F,3] int32)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    # ASCII files start with "solid" (case-insensitive in the wild), but
    # some binary exporters also write "solid" in the 80-byte header —
    # verify with the binary size equation
    if head.lower() == b"solid":
        n = None
        if len(data) >= 84:
            n = int.from_bytes(data[80:84], "little")
        if n is None or len(data) != 84 + 50 * n:
            return _load_ascii(data.decode("ascii", errors="replace"), path)
    if len(data) < 84:
        raise ValueError(f"{path}: truncated STL")
    n = int.from_bytes(data[80:84], "little")
    if len(data) < 84 + 50 * n:
        raise ValueError(f"{path}: binary STL claims {n} triangles but "
                         f"holds {(len(data) - 84) // 50}")
    # 50-byte records: normal[3]f32, v0[3]f32, v1[3]f32, v2[3]f32, u16 attr
    rec = np.frombuffer(data, np.uint8, count=50 * n, offset=84)
    rec = rec.reshape(n, 50)[:, :48].copy()
    tris = rec.view(np.float32).reshape(n, 4, 3)[:, 1:4, :]
    return _dedup(tris)


def _load_ascii(text: str, path: str):
    tris = []
    cur = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            cur.append((float(parts[1]), float(parts[2]), float(parts[3])))
            if len(cur) == 3:
                tris.append(cur)
                cur = []
    if not tris:
        raise ValueError(f"{path}: no triangles in ASCII STL")
    return _dedup(np.asarray(tris, np.float32))
