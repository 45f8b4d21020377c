"""Minimal OpenEXR 2.0 image IO (beyond-reference).

The reference can only blit LDR to a GL surface (kernel.cu:648-662).  PFM
(utils/pfm.py) already archives linear radiance, but OpenEXR is what
production compositors (Nuke, Fusion, Blender, tev, oiiotool) actually
expect, so this writes real ``.exr`` files with zero dependencies: a
single-part scanline image, NO_COMPRESSION, INCREASING_Y, RGB(A) channels
in HALF (default — the film-industry norm) or FLOAT.

Format reference: the public OpenEXR file-layout documentation
(openexr.com, "Technical Introduction to OpenEXR").  Only the small
subset this module writes is implemented in the reader — enough for
round-trips and for ingesting uncompressed EXRs from other tools.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630          # 0x01312f76 little-endian on disk
_VERSION = 2               # single-part scanline, no flags

# channel pixel types (file order is uint32 LE)
_UINT, _HALF, _FLOAT = 0, 1, 2
_NP_OF_TYPE = {_HALF: np.dtype("<f2"), _FLOAT: np.dtype("<f4"),
               _UINT: np.dtype("<u4")}


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(names, pixel_type: int) -> bytes:
    """EXR channel list: entries MUST be sorted alphabetically by name."""
    out = b""
    for n in sorted(names):
        out += n + b"\0"
        out += struct.pack("<i", pixel_type)      # pixel type
        out += struct.pack("<BBBB", 0, 0, 0, 0)   # pLinear + reserved
        out += struct.pack("<ii", 1, 1)           # x/y sampling
    return out + b"\0"


def write_exr(path: str, img: np.ndarray, *, half: bool = True) -> None:
    """Write a [H, W, 3] (RGB) or [H, W, 4] (RGBA) float image as an
    uncompressed scanline EXR.  ``half=True`` stores 16-bit half floats
    (the production norm, half the bytes); ``half=False`` stores exact
    float32."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"EXR wants [H,W,3] or [H,W,4], got {img.shape}")
    h, w, nc = img.shape
    names = [b"R", b"G", b"B"] + ([b"A"] if nc == 4 else [])
    by_name = dict(zip(names, range(nc)))
    ptype = _HALF if half else _FLOAT
    dtype = _NP_OF_TYPE[ptype]

    header = b""
    header += _attr(b"channels", b"chlist", _chlist(names, ptype))
    header += _attr(b"compression", b"compression", b"\0")  # NO_COMPRESSION
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")      # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"                                         # end of header

    # one scanline per chunk under NO_COMPRESSION; chunk = y, size, then
    # each channel's W values in alphabetical channel order
    order = [by_name[n] for n in sorted(names)]
    line_bytes = w * dtype.itemsize
    chunk_size = 8 + len(order) * line_bytes
    data_start = 8 + len(header) + 8 * h   # magic+version, header, offsets
    offsets = struct.pack("<%dQ" % h,
                          *(data_start + y * chunk_size for y in range(h)))

    planes = img.astype(dtype)  # [H, W, C]
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, len(order) * line_bytes))
            for c in order:
                f.write(planes[y, :, c].tobytes())


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while (b := f.read(1)) != b"\0":
            if not b:
                raise ValueError("EXR: truncated header")
            name += b
        if not name:
            return attrs
        typ = b""
        while (b := f.read(1)) != b"\0":
            typ += b
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name] = (typ, f.read(size))


def _parse_chlist(data: bytes):
    chans, i = [], 0
    while data[i] != 0:
        j = data.index(b"\0", i)
        name = data[i:j]
        ptype = struct.unpack_from("<i", data, j + 1)[0]
        chans.append((name.decode(), ptype))
        i = j + 1 + 16  # type(4) + pLinear/reserved(4) + sampling(8)
    return chans


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline EXR to float32 [H, W, 3] or
    [H, W, 4].  Supports the subset ``write_exr`` emits (plus FLOAT/HALF
    files from other tools as long as they are NO_COMPRESSION,
    INCREASING_Y).  Channels other than R/G/B/A are ignored; a missing
    channel reads as 0 (alpha as 1)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file (magic {magic:#x})")
        if version & 0x200:  # multi-part bit
            raise ValueError(f"{path}: multi-part EXR not supported")
        attrs = _read_attrs(f)
        if attrs[b"compression"][1] != b"\0":
            raise ValueError(f"{path}: only NO_COMPRESSION EXRs supported")
        if attrs[b"lineOrder"][1] != b"\0":
            raise ValueError(f"{path}: only INCREASING_Y EXRs supported")
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs[b"dataWindow"][1])
        w, h = x1 - x0 + 1, y1 - y0 + 1
        chans = _parse_chlist(attrs[b"channels"][1])  # file (alpha) order
        f.read(8 * h)  # offset table (chunks are contiguous; not needed)

        planes = {}
        for y in range(h):
            _, _ = struct.unpack("<ii", f.read(8))
            for name, ptype in chans:
                if ptype not in _NP_OF_TYPE:
                    raise ValueError(f"{path}: unsupported pixel type "
                                     f"{ptype} for channel {name}")
                dt = _NP_OF_TYPE[ptype]
                row = np.frombuffer(f.read(w * dt.itemsize), dtype=dt)
                planes.setdefault(name, []).append(row)

    def plane(name, fill):
        if name in planes:
            return np.stack(planes[name]).astype(np.float32)
        return np.full((h, w), fill, np.float32)

    rgb = [plane(n, 0.0) for n in ("R", "G", "B")]
    if "A" in planes:
        rgb.append(plane("A", 1.0))
    return np.ascontiguousarray(np.stack(rgb, axis=2))
