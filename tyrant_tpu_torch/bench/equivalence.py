"""The equivalence gate: the traversal kernels against the plain
depth-first walk on one scene, the port of ``bench.py:check_equivalence``.

Modes "mono" (``csrc/traverse.cu``) and "wave" (``csrc/traverse_wave.cu``):
closest ids exactly equal to the walk's, t within rtol 1e-4 on hits, any-hit
flags exactly equal.  Mode "stream" (``csrc/stream.cu``, ``cap_mult=8``): ids
equal except epsilon ties (an id differs and |dt| > 1e-3 is a mismatch: the
accept rule is order-dependent for hits closer than EPSILON, and breadth
first visits in another order), t within rtol 1e-4 and atol 1e-3.  Left out
of the JAX gate: its TPU table placements ("vmem" / "hbm", treelets) and
the ``normals=`` check, which the port does not have.

On CUDA tensors this certifies the kernels on the card; on CPU tensors
every mode runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import traverse as walk
from ..ops.kernels import stream as kstream
from ..ops.kernels import traverse as ktrav
from ..scene.scene import Scene

TIE = 1e-3


def gate_rays(bvh, n_rays: int, seed: int = 2024):
    """bench.py's rays: half box-random (origins up to 20% outside the
    root box, random directions), half aimed into the middle of the box.
    Returns numpy (origin, direction, root lo, root hi)."""
    node = bvh.node_packed.cpu().numpy()
    lo, hi = node[0, 0:3], node[0, 3:6]
    r = np.random.default_rng(seed)
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n_rays, 3))).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    half = n_rays // 2
    tgt = lo + (hi - lo) * r.uniform(0.2, 0.8, (half, 3))
    d2 = (tgt - o[half:]).astype(np.float32)
    d[half:] = d2 / np.linalg.norm(d2, axis=1, keepdims=True)
    return o, d, lo, hi


def check_equivalence(scene, n_rays: int = 65_536, device="cuda") -> str:
    """Run the gate on ``scene`` (a host :class:`Scene`, or a SceneData
    already on ``device``).  Returns "ok", or the modes' results joined
    by ";" with each mismatch or error named."""
    dev = torch.device(device)
    sd = scene.to_device(dev) if isinstance(scene, Scene) else scene
    tables = ktrav.PacketTables(sd.bvh)
    if not tables.supported:
        return "skipped (tables unsupported)"
    o_np, d_np, lo, hi = gate_rays(sd.bvh, n_rays)
    o, d = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)

    t_ref, id_ref = (x.cpu().numpy() for x in walk.closest_hit(o, d, sd.bvh))
    hits = id_ref >= 0
    maxd_np = np.where(hits, t_ref * 0.999, (hi - lo).max()).astype(np.float32)
    maxd = torch.from_numpy(maxd_np).to(dev)
    occ_ref = walk.any_hit(o, d, maxd, sd.bvh).cpu().numpy()

    msgs = []
    for mode, wave in (("mono", False), ("wave", True)):
        t_k, id_k = (x.cpu().numpy() for x in ktrav.closest_hit_packets(
            o, d, tables, wave=wave))
        if (id_ref != id_k).any():
            msgs.append(f"{mode}:closest-id mismatch on "
                        f"{int((id_ref != id_k).sum())}/{n_rays}")
            continue
        if hits.any() and not np.allclose(t_ref[hits], t_k[hits], rtol=1e-4):
            msgs.append(f"{mode}:closest-t mismatch")
            continue
        occ_k = ktrav.any_hit_packets(o, d, maxd, tables,
                                      wave=wave).cpu().numpy()
        if (occ_ref != occ_k).any():
            msgs.append(f"{mode}:anyhit mismatch on "
                        f"{int((occ_ref != occ_k).sum())}/{n_rays}")
            continue
        msgs.append(f"{mode}:ok")
    try:
        t_s, id_s = (x.cpu().numpy() for x in kstream.closest_hit_stream(
            o, d, tables, cap_mult=8))
    except Exception as e:  # reported in the result, never passed as ok
        msgs.append(f"stream:error {type(e).__name__}: {e}"[:200])
    else:
        with np.errstate(invalid="ignore"):
            bad = (id_ref != id_s) & ~(np.abs(t_ref - t_s) <= TIE)
        if bad.any():
            msgs.append(f"stream:closest-id mismatch on "
                        f"{int(bad.sum())}/{n_rays}")
        elif hits.any() and not np.allclose(t_ref[hits], t_s[hits],
                                            rtol=1e-4, atol=1e-3):
            msgs.append("stream:closest-t mismatch")
        else:
            msgs.append("stream:ok")
    return "ok" if all(m.endswith(":ok") for m in msgs) else ";".join(msgs)
