"""Profiling helpers, the port of ``tyrant_tpu/utils/profiling.py``: a
``torch.profiler`` trace written for Chrome or Perfetto, a synchronised
median timer, and the per-stage timing of one render step."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str = "build/tyrant_trace"):
    """Profile the enclosed code (the host and, when CUDA is there, the
    device) and write ``log_dir/trace.json``, a Chrome trace that
    ``chrome://tracing`` and Perfetto open.  Yields ``log_dir``."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_device(out):
    """The CUDA device of the first CUDA tensor in ``out`` (a tensor, or
    tuples, lists, dicts and dataclasses of them), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


def time_blocked(fn, *args, reps: int = 3, warmup: int = 1, **kw):
    """(median seconds of ``fn(*args, **kw)``, its last output).  When the
    output holds a CUDA tensor, each call is timed by CUDA events on its
    device's current stream, recorded around it, and waited for; otherwise
    by the host clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        if dev is None:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        out = fn(*args, **kw)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return times[len(times) // 2], out


def stage_profile(renderer, camera, n_steps: int = 5) -> dict:
    """Median ms of each stage of one wavefront step at ``camera``'s pose
    (raygen, extend, shade, connect, each fed the one before) and of a
    whole :func:`~tyrant_tpu_torch.render.render_step`, each over
    ``n_steps`` calls.  Every stage reads a copy of ``renderer.state``, so
    the renderer's own state does not advance."""
    from ..render import (RenderState, _connect, _intersect_scene,
                          _pick_wave, _raygen, _salted_frame, _shade,
                          merge_queue, render_step)

    cfg = renderer.cfg
    cam = camera.to_device(cfg, renderer.device)
    state = RenderState(**{f.name: getattr(renderer.state, f.name).clone()
                           for f in dataclasses.fields(RenderState)})
    scene, tables = renderer.scene, renderer.tables
    perm = state.pixel_perm if cfg.adaptive_sampling == "on" else None
    frame = _salted_frame(cfg, state.frame)

    t_raygen, _ = time_blocked(
        lambda: _raygen(cfg, cam, state.start_position, frame, perm=perm,
                        sample_base=state.sample_base), reps=n_steps)
    rays = merge_queue(cfg, state, cam)
    t_extend, ext = time_blocked(
        lambda: _intersect_scene(rays["origin"], rays["direction"], scene,
                                 tables, wave=_pick_wave(cfg, "extend")),
        reps=n_steps)
    t_shade, sh = time_blocked(
        lambda: _shade(cfg, scene, renderer.sky_params, renderer.sun_dir,
                       rays, *ext, frame), reps=n_steps)
    t_connect, _ = time_blocked(
        lambda: _connect(scene, sh[3], tables,
                         wave=_pick_wave(cfg, "connect")), reps=n_steps)
    t_full, _ = time_blocked(
        lambda: render_step(state, scene, cam, renderer.sun_dir, cfg=cfg,
                            tables=tables, sky_params=renderer.sky_params),
        reps=n_steps)

    total = t_raygen + t_extend + t_shade + t_connect
    return {
        "raygen_ms": t_raygen * 1e3,
        "extend_ms": t_extend * 1e3,
        "shade_ms": t_shade * 1e3,
        "connect_ms": t_connect * 1e3,
        "stage_sum_ms": total * 1e3,
        "full_step_ms": t_full * 1e3,
        "mrays_per_s_segments": cfg.num_rays / t_full / 1e6,
    }
