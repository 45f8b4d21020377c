"""Portable FloatMap (PFM) HDR image IO (beyond-reference).

The reference can only blit LDR to a GL surface (kernel.cu:648-662);
production pipelines archive the LINEAR radiance so grading/compositing
happen before any tonemap.  PFM is the dependency-free HDR container
(one ASCII header + raw float32 scanlines, bottom-to-top), readable by
OpenEXR-era tooling, ImageMagick, OpenCV and tev.
"""

from __future__ import annotations

import numpy as np


def write_pfm(path: str, img: np.ndarray) -> None:
    """Write a [H, W, 3] (color 'PF') or [H, W] (grayscale 'Pf') float32
    image.  Negative scale marks little-endian, per the spec."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    elif img.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"PFM wants [H,W,3] or [H,W], got {img.shape}")
    h, w = img.shape[0], img.shape[1]
    with open(path, "wb") as f:
        f.write(header + b"\n%d %d\n-1.0\n" % (w, h))
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file to float32 [H, W, 3] (grayscale is replicated)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file (magic {magic!r})")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if magic == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4),
                             dtype="<f4" if scale < 0 else ">f4",
                             count=count)
    img = data.reshape(h, w, -1)
    img = np.flipud(img).astype(np.float32)
    if abs(scale) not in (0.0, 1.0):
        img = img * abs(scale)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)
