"""Run one cell of the benchmark of tyrant_tpu_torch on the card.

    python3 perfbench/run.py --workload perftest_1m.poses --seed 7 \\
        --seconds 20 --trace 0

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic mix
(``perfbench/traffic/<mix>.json``), and each metric is a reader of its own
(``perfbench/end_to_end/<name>.py``, ``perfbench/layer_metrics/<name>.py``)
with a ``read(ctx)`` that returns a number, or None where it finds nothing
to read.  The configuration file names its scene generator
(``scene.generator``, ``perfbench/scenes/<name>.py``, default
``terrain_spheres``) and its plain reference (``reference``,
``perfbench/reference/<name>.py``, default ``pathtracer``).  Nothing here
names a cell, a scene or a reference.

A run builds the configuration's scene and Renderer (set-up), warms up
every shape the mix uses, drives the mix for ``--seconds``, and checks
what the timed path produced against the plain reference
(:mod:`perfbench.check`).  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` records host spans in the window, profiles a few
steady steps after it and reports the per-layer metrics, the device's busy
seconds and a breakdown.  The last line of standard output is one JSON
object; the numbers compared for ``correct`` come last there and as the
last lines of standard error.  Without a card, or with fewer cards than
the cell asks for, the run fails and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tyrant_tpu")
STEP_SLOTS = 16384      # queue slots sampled for a step checked from the
                        # window's state (and its shadow-ray estimate)
CHECK_SLOTS = 2048      # ... for the window's last frame, from a reset
FRAME_SLOTS = 1024      # ... for each other kept displayed frame
FRAME_EXTRA = 64        # pixels drawn from the whole frame besides
KEEP_FRAMES = 3         # displayed frames kept besides the last
KEEP_RANGE = 150        # ... drawn among the window's first frames
PROFILE_STEPS = 3       # profiled steps a pose (open-loop mixes)
PROFILE_FRAMES = 8      # profiled frames (mixes that display)
STAGE_STEPS = 2         # profiled eager steps for the stage split
TRACE_DIR = ROOT / "build" / "perfbench"


def log(*a):
    print("#", *a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's (``tyrant_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(manifest: dict, workload: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def metrics_of(manifest: dict, key: str, cell: str) -> list[dict]:
    """The metrics of one kind (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, or list no cells."""
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]


def module(kind: str, name: str, directory: Path = HERE):
    """The module ``<directory>/<kind>/<name>.py``, loaded by its path.  A
    name with no file raises, naming the path."""
    path = directory / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r}: {path} "
                                "does not exist")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, directory: Path = HERE):
    """The ``read`` function of ``<directory>/<kind>/<name>.py``."""
    return module(kind, name, directory).read


def scene_generator(config: dict, root: Path = ROOT):
    """The module whose ``make(scene) -> dict`` makes the configuration's
    scene: ``perfbench/scenes/<scene.generator>.py``."""
    return module("scenes", config["scene"].get("generator",
                                                "terrain_spheres"),
                  root / "perfbench")


def reference_module(config: dict, root: Path = ROOT):
    """The module whose ``make_step`` is the configuration's plain
    reference: ``perfbench/reference/<reference>.py``."""
    return module("reference", config.get("reference", "pathtracer"),
                  root / "perfbench")


def run_seed(seed: int) -> int:
    """The run's RenderConfig.seed: never 0 (that takes the unsalted
    streams, another count of operations), inside 31 bits."""
    return 1 + seed % ((1 << 31) - 2)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    render: dict                   # the RenderConfig fields of the run
    window: object = None
    setup_s: float = 0.0
    trace: object = None           # the profiled steps or frames
    windows: list = dataclasses.field(default_factory=list)
    profiled_steps: int = 0
    profiled_shadow_rays: int = 0
    stage_trace: object = None     # the eager steps of the stage split
    stage_steps: int = 0
    triangles: int = 0


def build(config: dict, seed: int, device, tiny: dict | None = None,
          root: Path = ROOT):
    """The configuration's scene, made by its generator
    (:func:`scene_generator`), and Renderer.  ``tiny`` overrides groups of
    the scene (such as ``terrain``) and the render fields (the CPU tests'
    small runs).  Returns (renderer, the generator's keyword arguments of
    ``Scene.from_triangles``, render fields, setup split)."""
    t = time.perf_counter()
    import torch
    from tyrant_tpu_torch.config import RenderConfig
    from tyrant_tpu_torch.render import Renderer
    from tyrant_tpu_torch.scene.scene import Scene
    gen = scene_generator(config, root)
    split = {"import_s": time.perf_counter() - t}
    t = time.perf_counter()
    sc = dict(config["scene"])
    render = dict(config["render"])
    for key, over in (tiny or {}).items():
        if key == "render":
            render.update(over)
        else:
            sc[key] = {**sc[key], **over}
    kw = gen.make(sc)
    split["terrain_s"] = time.perf_counter() - t   # the generator's scene
    t = time.perf_counter()
    scene = Scene.from_triangles(**kw, builder=sc.get("builder", "native"))
    split["bvh_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = RenderConfig(**render, seed=run_seed(seed))
    ren = Renderer(scene, cfg, device=device,
                   sun_position=tuple(sc["sun_position"]))
    if ren.device.type == "cuda":
        torch.cuda.synchronize(ren.device)
    split["tables_upload_s"] = time.perf_counter() - t
    return ren, kw, render, split


def camera_factory():
    import numpy as np
    from tyrant_tpu_torch.camera import Camera

    def make(pose):
        return Camera(position=np.asarray(pose.position, np.float32),
                      horizontal_angle=pose.horizontal_angle,
                      vertical_angle=pose.vertical_angle)
    return make


def _pixel_rows(t, pixels):
    return t[pixels.to(t.device)].detach().clone()


def checked_step(driver, pose, render: dict, rng, check):
    """One more frame of the timed path at the window's last pose, from the
    window's state: what the reference needs to follow its step, and what
    it produced at the sampled pixels."""
    import torch
    ren = driver.ren
    st = ren.state
    n_carried = int(st.n_carried)
    start, frame = int(st.start_position), int(st.frame)
    shadow0 = int(st.shadow_rays)
    dev = st.accum.device
    pix_all = check.queue_pixels(render, start, n_carried, st.pixel, dev)
    slots = check.sample_slots(rng, render["num_rays"], STEP_SLOTS, dev)
    u, j, mask = check.select(pix_all, slots, st.accum.shape[0])
    fresh = j < render["num_rays"] - n_carried
    carried = {k: getattr(st, k)[j].detach().clone() for k in
               ("origin", "direction", "direct", "pending", "pixel",
                "bounces", "last_specular")}
    before = _pixel_rows(st.accum, u)
    driver.step_at(pose)
    after_state = ren.state
    return check.Checked(
        pixels=u.cpu(), slots=j.cpu(), fresh=fresh.cpu(),
        carried={k: v.cpu() for k, v in carried.items()}, start=start,
        frame=frame, pose=(pose.position, pose.horizontal_angle,
                           pose.vertical_angle),
        before=before.cpu(), after=_pixel_rows(after_state.accum, u).cpu(),
        surv=check.survivors(after_state, mask),
        sampled=torch.searchsorted(j, slots).cpu(),
        shadow=int(after_state.shadow_rays) - shadow0,
        n_rays=render["num_rays"])


def fresh_frame(render: dict, rng, check, g: int, pose, image, dev,
                state=None, n_slots: int = FRAME_SLOTS):
    """A displayed frame whose step ran from a reset as the Renderer's
    ``g``-th step: its scan start and frame counter follow from ``g``; the
    pixels are sampled from its slots and the whole frame.  With
    ``state`` (the Renderer's state right after that step) the step's
    accumulation and survivors are judged too."""
    import torch
    n, w, h = render["num_rays"], render["width"], render["height"]
    total = w * h
    start = (g * n) % total
    pix_all = check.queue_pixels(render, start, 0, None, dev)
    slots = check.sample_slots(rng, n, n_slots, dev)
    extra = torch.as_tensor(rng.choice(total, size=min(FRAME_EXTRA, total),
                                       replace=False), device=dev)
    u = torch.unique(torch.cat([pix_all[slots], extra]))
    mask = torch.zeros(total, dtype=torch.bool, device=dev)
    mask[u] = True
    j = torch.nonzero(mask[pix_all]).squeeze(1)
    zeros = torch.zeros((j.shape[0], 3))
    carried = dict(origin=zeros, direction=zeros, direct=zeros,
                   pending=zeros,
                   pixel=torch.zeros(j.shape[0], dtype=torch.int32),
                   bounces=torch.zeros(j.shape[0], dtype=torch.int32),
                   last_specular=torch.zeros(j.shape[0], dtype=torch.bool))
    c = check.Checked(
        pixels=u.cpu(), slots=j.cpu(),
        fresh=torch.ones(j.shape[0], dtype=torch.bool), carried=carried,
        start=start, frame=1 + g,
        pose=(pose.position, pose.horizontal_angle, pose.vertical_angle),
        before=torch.zeros((u.shape[0], 4)),
        image=image.reshape(-1, 3)[u.cpu()].clone())
    if state is not None:
        c.after = _pixel_rows(state.accum, u).cpu()
        c.surv = check.survivors(state, mask)
    return c


def keep_frames(rng, mix) -> frozenset:
    """The displayed frames of the window kept for the check (the last is
    kept besides), drawn from the seed."""
    if not mix.display:
        return frozenset()
    return frozenset(int(k) for k in rng.choice(KEEP_RANGE, size=KEEP_FRAMES,
                                                replace=False))


def shown_whole(driver, pose, render: dict, check):
    """The frame shown after enough more steps at ``pose`` (no reset) for
    every pixel to have had a ray, with the accumulation it was resolved
    from: a frame one step from a reset may show few lit pixels, this one
    shows the whole view."""
    total = render["width"] * render["height"]
    for _ in range(-(-total // render["num_rays"])):
        driver.step_at(pose)
    image = driver.display().clone()
    return check.Shown(accum=driver.ren.state.accum.detach().cpu(),
                       image=image)


def collect(driver, w, render: dict, rng):
    """What the timed path produced, at a sample of pixels drawn from the
    seed: (checked steps, checked displayed frames, a whole shown frame or
    None).  A mix that moves the camera every frame and displays has its
    kept frames checked, the last of them (the window's last frame) with
    its step's accumulation and survivors; any other mix has one more
    frame checked at the window's last pose, from the window's state.  A
    mix that displays then has a whole frame shown at that pose."""
    from perfbench import check
    dev = driver.dev
    steps, frames = [], []
    if not (driver.mix.display and driver.all_fresh):
        steps.append(checked_step(driver, w.last_pose, render, rng, check))
    else:
        for idx, g, pose, img in w.kept:
            last = idx == w.kept[-1][0]
            c = fresh_frame(render, rng, check, g, pose, img, dev,
                            state=driver.ren.state if last else None,
                            n_slots=CHECK_SLOTS if last else FRAME_SLOTS)
            frames.append(c)
            if last:
                steps.append(c)
    shown = shown_whole(driver, w.last_pose, render, check) \
        if driver.mix.display else None
    return steps, frames, shown


def reference_step(scene_kw: dict, config: dict, render: dict, device,
                   dtype=None, root: Path = ROOT):
    """The plain reference of the configuration's step on ``device``, in
    float32 or ``dtype``: its reference module's ``make_step`` over the
    scene its generator made (``scene_kw``)."""
    import torch
    return reference_module(config, root).make_step(
        scene_kw, config, render, device, dtype or torch.float32)


def judge_program(steps_checked, frames_checked, shown, scene_kw, config,
                  render, seed: int, device, root: Path = ROOT) -> dict:
    """The compared numbers of the program's outputs."""
    from perfbench import check
    refs = check.follow_all(
        reference_step(scene_kw, config, render, device, root=root),
        steps_checked + frames_checked, run_seed(seed))
    nums = check.judge(steps_checked, frames_checked,
                       check.program_outcomes(steps_checked + frames_checked),
                       refs)
    if shown is not None:
        nums["display_off_pct"] = check.display_off(shown, device)
    return nums


def profile_window(fn, path: Path):
    """Run ``fn`` under the profiler (host and device) and load its
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import Trace
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the first session sets tracing up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        out = fn()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    tr = Trace.load(path)
    path.unlink()
    return tr, out


def traced(ctx: Context, driver, workload: str):
    """The profiled windows of a traced run: a few steady steps a segment
    (open loop) or frames (display), and for open loops the stage split
    of a short eager pass at the first segment's pose, sharing the scene's
    device tables."""
    import torch
    from torch.profiler import record_function
    from tyrant_tpu_torch.render import Renderer

    mix = driver.mix

    def steps():
        shadow = 0
        for seg in mix.segments:
            driver.step_at(seg.pose(0))
            driver.sync()
            s0 = driver.shadow_rays()
            with record_function("perfbench.window"):
                for _ in range(PROFILE_STEPS):
                    driver.step_at(seg.pose(0))
                driver.sync()
            shadow += driver.shadow_rays() - s0
        return shadow

    def frames():
        with record_function("perfbench.window"):
            driver.frames(PROFILE_FRAMES)
            driver.sync()
        return 0

    ctx.trace, ctx.profiled_shadow_rays = profile_window(
        frames if mix.display else steps,
        TRACE_DIR / f"{workload}.trace.json")
    ctx.windows = ctx.trace.windows()
    log("profiled kernels:", {n[:60]: round(v, 1) for n, v in
                              ctx.trace.by_name(ctx.windows).items()
                              if "traverse" in n or "accum" in n})
    ctx.profiled_steps = (PROFILE_FRAMES if mix.display
                          else PROFILE_STEPS * len(mix.segments))
    if mix.display:
        return
    ren = driver.ren
    eager = Renderer(ren.scene, dataclasses.replace(
        ren.cfg, fuse_step_chains="off"), device=ren.device,
        tables=ren.tables, sun_position=ren.sun_position)
    cam = driver.camera(mix.segments[0].pose(0))
    eager.step(cam, 2)
    torch.cuda.synchronize()

    def stage():
        with record_function("perfbench.window"):
            eager.step(cam, STAGE_STEPS)
            torch.cuda.synchronize()
    ctx.stage_trace, _ = profile_window(
        stage, TRACE_DIR / f"{workload}.stage.json")
    ctx.stage_steps = STAGE_STEPS
    del eager


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", tiny: dict | None = None, root: Path = ROOT,
        torch_import_s: float = 0.0) -> dict:
    """One run of a cell, as the command line gives it, on ``device``
    (the card; the CPU tests pass "cpu" and a ``tiny`` size), from the
    checkout at ``root``.  Returns the result line's object."""
    import numpy as np
    import torch

    from perfbench import check
    from perfbench.drive import Driver, Mix

    manifest = load_manifest(root)
    cell, conf = find(manifest, workload)
    config = json.loads((root / conf["file"]).read_text())
    mix = Mix.load(cell["traffic"], root / "perfbench" / "traffic")
    rng = np.random.default_rng(seed % (1 << 64))
    reference_module(config, root)  # a missing reference fails in set-up

    ren, scene_kw, render, split = build(config, seed, device, tiny, root)
    split["torch_import_s"] = torch_import_s
    driver = Driver(ren, mix, camera_factory())
    t = time.perf_counter()
    driver.warm_up()
    split["warm_up_s"] = time.perf_counter() - t
    nvcc = sys.modules.get("tyrant_tpu_torch.ops.kernels.build")
    if nvcc is not None and nvcc.build_seconds is not None:
        split["nvcc_s"] = nvcc.build_seconds  # a build in this process
    w = driver.window(seconds, keep=keep_frames(rng, mix), spans=trace)
    setup_s = w.t_start - T_PROCESS
    dev = ren.device
    if dev.type == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        memory_peak, kind = 0, "cpu"

    steps_checked, frames_checked, shown = collect(driver, w, render, rng)
    ctx = Context(render=render, window=w, setup_s=setup_s,
                  triangles=len(scene_kw["v0"]))
    if trace:
        traced(ctx, driver, workload)

    # the program's state goes before the reference runs
    del driver, ren
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nums = judge_program(steps_checked, frames_checked, shown, scene_kw,
                         config, render, seed, dev, root)
    log(f"reference {time.perf_counter() - t:.3f} s")
    lims = check.limits(root / "perfbench" / "limits.json")
    checks = {k: {"value": v, "limit": lims[k]} for k, v in nums.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, kind_key, workload):
        sub = "layer_metrics" if trace else "end_to_end"
        value = reader(sub, m["name"], root / "perfbench")(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": w.frames, "failed": 0,
           "metrics": metrics, "device": device_info}
    if trace:
        from perfbench.trace import breakdown, length
        device_info["busy_s"] = length(ctx.trace.busy(ctx.windows)) * 1e-6
        device_info["window_s"] = length(ctx.windows) * 1e-6
        out["breakdown"] = breakdown(ctx.trace, ctx.windows)
    out["setup_split"] = split
    out["window"] = {"seconds": w.seconds, "frames": w.frames,
                     "shadow_rays": w.shadow_rays,
                     "segment_frames": w.segment_frames,
                     "frame_ms_quartiles": (
                         [q * 1e3 for q in statistics.quantiles(w.frame_s,
                                                                n=4)]
                         if len(w.frame_s) > 1 else None)}
    if w.frame_s:
        ends = np.cumsum(w.frame_s)
        out["window"]["frames_by_second"] = np.bincount(
            ends.astype(int)).tolist()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t = time.perf_counter()
    import torch
    torch.cuda.is_available()
    torch_import_s = time.perf_counter() - t
    # one process with one host thread for PyTorch's own CPU work: the
    # frame loop is one thread of launches, and spare workers only add
    # noise beside it
    torch.set_num_threads(1)
    manifest = load_manifest()
    cell, _ = find(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch_import_s=torch_import_s)
    from perfbench.roofline import power_limit
    log("card:", power_limit())
    bad = forbidden_modules()
    if bad:
        log("loaded modules of JAX or the JAX package:", ", ".join(bad))
        return 3
    print(json.dumps(out), flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
