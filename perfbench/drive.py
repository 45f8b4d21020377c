"""The general traffic generator: it reads a traffic mix
(``perfbench/traffic/<mix>.json``) and drives a Renderer through it.

A mix is a list of segments, each holding the camera for a share of the
window: pinned to one pose, or flying from a pose along a scripted flight
that repeats every ``lap_frames`` frames.  A frame moves the camera (a new
pose resets the accumulation), runs one step and, when the mix displays,
resolves ``image(uint8=True)`` and copies it to host memory, as a viewer
shows it.  A mix that displays runs a closed loop (the next
frame starts when the last is on the host); one that does not runs steps
back to back, the host kept at most two steps ahead of the device.

The flight is a frozen copy of ``tyrant_tpu_torch/bench/interactive.py``'s
``fly_path`` with the camera's ``move`` and ``look``
(``tyrant_tpu_torch/camera.py``); the poses are upstream's
PERFORMANCE_TEST poses as the mix files list them.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
HALF_PI = 3.1415926535897932 / 2
AHEAD = 2  # steps the host may run ahead of the device in an open loop


@dataclasses.dataclass(frozen=True)
class Pose:
    position: tuple
    horizontal_angle: float
    vertical_angle: float


def _direction(h: float, v: float) -> np.ndarray:
    cv, sv = math.cos(v), math.sin(v)
    ch, sh = math.cos(h), math.sin(h)
    d = np.array([cv * sh, cv * ch, sv], np.float32)
    return d / np.linalg.norm(d)


def fly(pose: Pose, i: int, flight: dict) -> Pose:
    """Frame ``i``'s move of the scripted flight: forward with a strafe
    (the camera's move, speed ``delta``), then a turn with the pitch
    swaying (its look: 0.012 rad a unit, pitch clamped short of the
    poles)."""
    pos = np.asarray(pose.position, np.float32)
    speed = flight["delta"]
    d = _direction(pose.horizontal_angle, pose.vertical_angle)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    disp = np.cross(d, up)
    disp = disp / np.linalg.norm(disp)
    pos = (pos + d * (flight["forward"] * speed)
           + disp * (flight["strafe"] * speed)
           + np.array([0, 0, 0.0 * speed], np.float32))
    dy = flight["look_dy_amp"] * np.sin(i * flight["look_dy_freq"])
    h = pose.horizontal_angle + flight["look_dx"] * 0.012
    v = pose.vertical_angle - dy * 0.012
    v = max(-HALF_PI + 1e-3, min(v, HALF_PI - 1e-3))
    return Pose(tuple(float(x) for x in pos.astype(np.float32)), h, v)


class Segment:
    """One stretch of the window: its share and the pose of each frame."""

    def __init__(self, spec: dict):
        self.share = float(spec["share"])
        start = Pose(tuple(float(x) for x in
                           np.asarray(spec["position"], np.float32)),
                     float(spec["angles"][0]), float(spec["angles"][1]))
        flight = spec.get("flight")
        if flight is None:
            self.poses = [start]
        else:
            self.poses, p = [], start
            for i in range(int(flight["lap_frames"])):
                p = fly(p, i, flight)
                self.poses.append(p)

    def pose(self, k: int) -> Pose:
        return self.poses[k % len(self.poses)]


class Mix:
    def __init__(self, data: dict):
        self.display = bool(data["display"])
        self.segments = [Segment(s) for s in data["segments"]]
        total = sum(s.share for s in self.segments)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"the segments' shares sum to {total}, not 1")

    @classmethod
    def load(cls, name: str, directory: Path = TRAFFIC_DIR) -> "Mix":
        return cls(json.loads((directory / f"{name}.json").read_text()))


@dataclasses.dataclass
class Window:
    """What the window did: ``frames`` (one step each) completed in
    ``seconds`` of wall time, ``shadow_rays`` valid NEE shadow rays among
    them, ``frame_s`` each displayed frame's time from the camera move to
    its pixels on the host, ``spans`` the host spans of a traced run, and
    ``kept`` the displayed frames kept for the check: (frame index, index
    of its step among all the Renderer's steps, pose, [H, W, 3] uint8)."""

    frames: int = 0
    seconds: float = 0.0
    shadow_rays: int = 0
    frame_s: list = dataclasses.field(default_factory=list)
    segment_frames: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(list))
    kept: list = dataclasses.field(default_factory=list)
    last_pose: Pose | None = None
    t_start: float = 0.0

    def mean_span_ms(self, name: str) -> float | None:
        """The mean of the host spans ``name`` in milliseconds."""
        s = self.spans.get(name)
        return 1e3 * sum(s) / len(s) if s else None


class Driver:
    """Drives one Renderer through a mix.  ``steps`` counts every step the
    Renderer took; ``all_fresh`` stays true while every step began from a
    reset (a new pose a step), so its scan start and frame counter follow
    from ``steps`` alone."""

    def __init__(self, renderer, mix: Mix, camera_factory):
        self.ren = renderer
        self.mix = mix
        self.camera = camera_factory
        self.dev = renderer.device
        self.steps = 0
        self.all_fresh = True
        self._pose = None
        self._host = [None, None]
        self._turn = 0
        self._fetched = torch.cuda.Event() if self.dev.type == "cuda" \
            else None

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def shadow_rays(self) -> int:
        return int(self.ren.state.shadow_rays)

    def _step(self, pose: Pose):
        if self._pose is not None and pose == self._pose:
            self.all_fresh = False
        self._pose = pose
        self.ren.step(self.camera(pose), 1)
        self.steps += 1

    def display(self):
        """The frame's 8-bit image in host memory, fetched as the viewer
        fetches it: a copy into a pinned buffer (two, used in turn, so the
        last frame's stays whole), then a wait for it."""
        img = self.ren.image(uint8=True)
        if img.device.type != "cuda":
            return img.clone()
        k = self._turn = self._turn ^ 1
        if self._host[k] is None or self._host[k].shape != img.shape:
            self._host[k] = torch.empty(img.shape, dtype=img.dtype,
                                        pin_memory=True)
        self._host[k].copy_(img, non_blocking=True)
        self._fetched.record()
        self._fetched.synchronize()
        return self._host[k]

    def step_at(self, pose: Pose) -> None:
        """One frame's steps at ``pose``, outside the window."""
        with record_function("perfbench.step"):
            self._step(pose)

    def warm_up(self) -> None:
        """Two frames of every segment, so that each shape the window uses
        (the captured step and image, the pose change) ran once eagerly
        and once replayed."""
        for seg in self.mix.segments:
            for k in range(2):
                self._step(seg.pose(k))
                if self.mix.display:
                    self.display()
        self.sync()

    def window(self, seconds: float, keep=frozenset(),
               spans: bool = False) -> Window:
        """Run the mix for ``seconds``.  ``keep``: indices of displayed
        frames to keep (the last is always kept); ``spans``: record the
        host spans of each frame's step (with a device synchronise after
        it) and of its display."""
        w = Window()
        self.sync()
        shadow0 = self.shadow_rays()
        t0 = w.t_start = time.perf_counter()
        ends, acc = [], 0.0
        for seg in self.mix.segments:
            acc += seg.share
            ends.append(t0 + acc * seconds)
        pending = collections.deque()
        last = None
        for seg, t_end in zip(self.mix.segments, ends):
            k = 0
            while True:
                pose = seg.pose(k)
                if self.mix.display:
                    tf = time.perf_counter()
                    g = self.steps
                    with record_function("perfbench.step"):
                        self._step(pose)
                    if spans:
                        self.sync()
                        w.spans["step"].append(time.perf_counter() - tf)
                    td = time.perf_counter()
                    with record_function("perfbench.display"):
                        img = self.display()
                    now = time.perf_counter()
                    if spans:
                        w.spans["display"].append(now - td)
                    w.frame_s.append(now - tf)
                    if w.frames in keep:
                        w.kept.append((w.frames, g, pose, img.clone()))
                    last = (w.frames, g, pose, img)
                else:
                    with record_function("perfbench.step"):
                        self._step(pose)
                    if self.dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        pending.append(ev)
                        if len(pending) > AHEAD:
                            pending.popleft().synchronize()
                    now = time.perf_counter()
                w.frames += 1
                w.last_pose = pose
                k += 1
                if now >= t_end:
                    w.segment_frames.append(k)
                    break
        self.sync()
        w.seconds = time.perf_counter() - t0
        w.shadow_rays = self.shadow_rays() - shadow0
        if last is not None and (not w.kept or w.kept[-1][0] != last[0]):
            w.kept.append((*last[:3], last[3].clone()))
        return w

    def frames(self, count: int, segment: int = -1) -> None:
        """``count`` more frames of one segment, untimed (the profiled
        window of a traced run)."""
        seg = self.mix.segments[segment]
        for k in range(count):
            with record_function("perfbench.step"):
                self._step(seg.pose(k))
            if self.mix.display:
                with record_function("perfbench.display"):
                    self.display()
