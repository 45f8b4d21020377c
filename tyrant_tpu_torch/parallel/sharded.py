"""Strip-parallel rendering, the port of ``tyrant_tpu/parallel/sharded.py``.

The image is cut into row strips, one for each entry of a device list (a
"mesh"); each strip runs the whole wavefront on its own rows, with its own
carried rays, start position, frame counter and accumulation buffer.  The
scene (triangles and BVH, read-only after loading) is uploaded once to
each distinct device and shared by the strips on it.  Nothing crosses
devices in the step; the one cross-device operation is the framebuffer
gather at display time (:func:`assemble_image`).

The JAX package runs this as one program over a device mesh
(``shard_map``).  Here one process drives the list: every step launches
each strip's :func:`~tyrant_tpu_torch.render.render_step` in turn, eagerly,
with ``local_height = height / D`` and ``row_offset = i * local_height``
for strip ``i``, which place its rays in the image and key its random
streams exactly as the JAX shard ``i`` does.  A device may appear more
than once (``["cuda:0"] * 2``: two strips on one card), which is how the
path runs on a machine with one GPU; ``["cpu"] * 8`` runs it on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import adaptive as adaptive_mod
from .. import sky as skymod
from ..config import RenderConfig
from ..device import resolve
from ..ops import kernels
from ..ops.kernels.traverse import PacketTables
from ..ops.tonemap import resolve as resolve_image
from ..render import RenderState, init_state, render_step
from ..scene.scene import Scene, SceneData


def make_mesh(devices=None) -> list[torch.device]:
    """The strips' devices, one a strip: ``devices`` (names or
    torch.device, repeats allowed), by default every visible CUDA device
    (raises when there is none).  A bare "cuda" becomes the current CUDA
    device's index."""
    if devices is None:
        resolve("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("the mesh needs at least one device")
    return mesh


def _local_height(cfg: RenderConfig, mesh) -> int:
    if cfg.height % len(mesh):
        raise ValueError(f"height {cfg.height} must divide across "
                         f"{len(mesh)} devices")
    return cfg.height // len(mesh)


def init_sharded_state(cfg: RenderConfig, mesh) -> list[RenderState]:
    """One fresh strip state a mesh entry, on its device: ``height / D``
    rows each, the adaptive visit order in local pixel ids."""
    local_h = _local_height(cfg, mesh)
    return [init_state(cfg, dev, local_height=local_h) for dev in mesh]


@dataclasses.dataclass
class Replica:
    """What the strips on one device share: the scene's tensors, its
    traversal tables and the sun direction."""

    scene: SceneData
    tables: PacketTables
    sun_dir: torch.Tensor


def _on(dev: torch.device):
    """The device's context for a kernel launch (CUDA launches go to the
    current device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def make_sharded_step(cfg: RenderConfig, mesh,
                      sky_params: skymod.SkyParams | None = None):
    """Returns step(states, replicas, cameras, launches=None) -> the
    strips' next states: ``states`` one a mesh entry, ``replicas`` and
    ``cameras`` (the pose's :class:`~tyrant_tpu_torch.camera.CameraParams`)
    by device.  Strip ``i`` steps with ``row_offset = i * height / D``; a
    strip's accumulation is updated in place, as by ``render_step``.
    ``launches``: one dict a strip, to which each strip's kernel launches
    are added (by the names of ``ops.kernels.launch_counts``)."""
    local_h = _local_height(cfg, mesh)
    sky_params = sky_params or skymod.SkyParams(cfg.sky)

    def step(states, replicas, cameras, launches=None):
        out = []
        for i, (st, dev) in enumerate(zip(states, mesh)):
            rep = replicas[dev]
            before = kernels.launch_counts() if launches is not None \
                else None
            with _on(dev):
                out.append(render_step(
                    st, rep.scene, cameras[dev], rep.sun_dir, cfg=cfg,
                    tables=rep.tables, sky_params=sky_params,
                    local_height=local_h, row_offset=i * local_h))
            if before is not None:
                for k, v in kernels.launch_counts().items():
                    if v != before[k]:
                        launches[i][k] = launches[i].get(k, 0) + v - before[k]
        return out

    return step


def assemble_image(states, cfg: RenderConfig) -> torch.Tensor:
    """The framebuffer gather: the strips' accumulation buffers
    concatenated in strip order on the first strip's device (the one
    cross-device copy), resolved to the display image [H, W, 3]."""
    dev = states[0].accum.device
    accum = torch.cat([st.accum.to(dev) for st in states])
    return resolve_image(accum, cfg.width, cfg.height, operator=cfg.tonemap,
                         exposure=cfg.exposure)


class ShardedRenderer:
    """Host wrapper mirroring :class:`~tyrant_tpu_torch.render.Renderer`
    over a device list (:func:`make_mesh`, in the JAX package's ``mesh``
    place): ``ShardedRenderer(scene, cfg, devices=["cuda:0", "cuda:1"])
    .step(cam, n)``.

    ``scene`` is a host :class:`Scene`, uploaded once to each distinct
    device, or a :class:`SceneData` already on the mesh's one device,
    with its ``tables`` (or None to build them).  The strips step eagerly
    (no captured graph), and a new pose re-initialises every strip, as in
    the JAX package.  Under adaptive sampling each strip's visit order is
    rebuilt from its own moments, in local ids."""

    def __init__(self, scene, cfg: RenderConfig, devices=None,
                 sun_position=(0.05, 0.3), *,
                 tables: PacketTables | None = None):
        self.cfg = cfg
        self.mesh = make_mesh(devices)
        self.local_height = _local_height(cfg, self.mesh)
        self.sky_params = skymod.SkyParams(cfg.sky)
        self.sun_position = tuple(sun_position)
        distinct = list(dict.fromkeys(self.mesh))
        self.replicas: dict[torch.device, Replica] = {}
        for dev in distinct:
            if isinstance(scene, Scene):
                sd, tb = scene.to_device(dev), None
            else:
                if len(distinct) > 1 or scene.bvh.node_packed.device != dev:
                    raise ValueError("a SceneData serves one device: pass "
                                     "the host Scene to upload it to each")
                sd, tb = scene, tables
            tb = tb if tb is not None else PacketTables(sd.bvh)
            if not tb.supported:
                raise ValueError("the scene's fat-row table is unsupported")
            self.replicas[dev] = Replica(
                sd, tb, skymod.sun_direction_from_position(self.sun_position,
                                                           dev))
        self._step = make_sharded_step(cfg, self.mesh, self.sky_params)
        self.states = init_sharded_state(cfg, self.mesh)
        self._last_pose = None
        self._sched = adaptive_mod.PermScheduler(cfg.adaptive_interval) \
            if cfg.adaptive_sampling == "on" else None

    def step(self, camera, n_steps: int = 1) -> list[RenderState]:
        """``n_steps`` steps of every strip at ``camera``'s pose (a new
        pose starts every strip afresh); returns the strips' states."""
        pose = camera.pose_key()
        if self._last_pose is not None and pose != self._last_pose:
            self.states = init_sharded_state(self.cfg, self.mesh)
        self._last_pose = pose
        cams = {dev: camera.to_device(self.cfg, dev) for dev in self.replicas}
        for _ in range(n_steps):
            self.states = self._step(self.states, self.replicas, cams)
        if self._sched is not None:
            phase = self._sched.tick(n_steps)
            if phase is not None:
                self.states = [self._rebuilt(st, dev, phase)
                               for st, dev in zip(self.states, self.mesh)]
        return self.states

    def _rebuilt(self, st: RenderState, dev, phase: float) -> RenderState:
        """The strip's state with its visit order rebuilt from its own
        accumulation and moments."""
        with _on(dev):
            perm = adaptive_mod.build_perm(
                st.accum, st.moment2,
                torch.tensor(phase, dtype=torch.float32, device=dev),
                gamma=self.cfg.adaptive_gamma)
        return dataclasses.replace(st, pixel_perm=perm)

    def image(self) -> torch.Tensor:
        return assemble_image(self.states, self.cfg)
