"""Checkpoint and resume of a progressive render, the port of
``tyrant_tpu/checkpoint.py``'s ``.npz`` backend.

``save_state`` writes every RenderState field under the JAX package's
name and in its dtype (uint32 ``frame``, ``shadow_rays``, ``sample_base``
and ``sample_idx``; int32 ``n_carried`` and ``start_position``; the
rest as the arrays are), with JSON metadata (camera pose, sun, config),
to one compressed ``.npz`` file; ``load_state`` reads it back onto a
device, filling the fields that older files lack with the JAX package's
defaults.  So a file either package writes loads in the other, and a
resumed render continues bit for bit.

    from tyrant_tpu_torch.checkpoint import load_state, save_state
    save_state("render.npz", renderer.state, {"sun": [0.05, 0.3]})
    renderer.state, meta = load_state("render.npz", renderer.device)

Not ported: the orbax backend (``save_orbax``/``load_orbax``), which needs
a package the card's machine does not have.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .device import resolve
from .interop import state_from_numpy
from .render import RenderState

_FIELDS = ["accum", "origin", "direction", "direct", "pending", "pixel",
           "bounces", "last_specular", "n_carried", "start_position",
           "frame", "shadow_rays", "moment2", "pixel_perm", "bsdf_pdf",
           "sample_base", "sample_idx"]
# the JAX package's dtype of each field held in another one here
_SAVED_DTYPES = dict(frame=np.uint32, shadow_rays=np.uint32,
                     sample_base=np.uint32, sample_idx=np.uint32,
                     n_carried=np.int32, start_position=np.int32)
# fields added after the first format; absent from old files
_OPTIONAL = {"shadow_rays": np.asarray(0, np.uint32),
             "moment2": np.zeros((1, 4), np.float32),
             "pixel_perm": np.zeros((1,), np.int32),
             "bsdf_pdf": np.ones((1,), np.float32),
             "sample_base": np.asarray(0, np.uint32),
             "sample_idx": np.zeros((1,), np.uint32)}


def _saved(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    dtype = _SAVED_DTYPES.get(name)
    if dtype is None:
        return a
    if dtype is np.uint32:
        a = a & 0xFFFFFFFF  # the counters wrap as the JAX uint32 ones do
    return a.astype(dtype)


def save_state(path: str, state: RenderState, metadata: dict | None = None):
    """Write ``state`` and JSON-serialisable ``metadata`` to one .npz
    file, atomically (a temporary file, then a rename)."""
    arrays = {f: _saved(f, getattr(state, f)) for f in _FIELDS}
    arrays["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_state(path: str, device="cuda"):
    """(RenderState on ``device``, metadata dict) from a file that
    :func:`save_state` or the JAX package's ``save_state`` wrote."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__metadata__"]).decode() or "{}")
        fields = {f: z[f] if f in z else _OPTIONAL[f] for f in _FIELDS}
    return state_from_numpy(fields, resolve(device)), meta
