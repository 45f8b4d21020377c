"""How ``correct`` is decided: the program's outputs at a sample drawn from
the run's seed, against the configuration's plain reference (its
``reference``, by default :mod:`perfbench.reference.pathtracer`) computed
from the benchmark's own scene, poses and sun.  The reference's step has
``sc.device``, ``sc.dtype``, ``cfg``, ``camera_rays`` and ``run`` as
:class:`perfbench.reference.pathtracer.Step` has; the helpers every scene
shares (the pixel scan, the camera basis, the salted frame and the 8-bit
tone map) are ``pathtracer``'s.

Three numbers are compared, each against its limit in
``perfbench/limits.json``:

- ``pixels_off_pct``, the share of the sampled pixels that are off.

  - A checked step of the timed path, at the timed sizes: for a sample of
    pixels, every queue slot that renders one of them (fresh camera rays
    and carried rays alike) is followed by the reference through extend,
    shade, connect and roulette.  A pixel is off when what the step added
    to its accumulation (radiance and path count) differs from the sum of
    its ended paths' flushes, or when the rays it carries on differ (in
    count, bounces, specular flag, origin, direction, throughput or
    pending radiance) from the reference's survivors.
  - A displayed frame of the window, one step from a reset (mixes that
    move the camera every frame): a pixel is off when its 8-bit value
    differs from the reference's tone-mapped one, which the same float32
    arithmetic gives exactly.

- ``shadow_count_z`` (a step checked from the window's state): how far
  the program's count of the step's valid NEE shadow rays
  (``RenderState.shadow_rays``, which ``mrays_per_s`` reads) lies from the
  reference's estimate over a uniform sample of the queue's slots, in
  standard errors of that sample (without replacement, with one slot
  added for a near-tie).

- ``display_off_pct`` (mixes that display): after the window, the camera
  stays at its last pose until every pixel has had a ray, and a frame is
  shown: the share of its pixels, of those that show anything, whose
  8-bit value differs from the reference's resolve of the program's whole
  accumulation, the one the frame was resolved from (that accumulation's
  steps are judged at the sampled pixels above).  The same float32
  arithmetic on the same device gives it exactly.

The tolerances inside a pixel's test are float32 rounding with a wide
margin (``RTOL`` and a few units in the last place of the accumulated
sum); what separates a sound run from a faulty or lower-precision one is
the share of pixels off.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from .reference import pathtracer as ref

RTOL = 1e-3          # relative gap a float field may show
ULPS = 16 * 2.0 ** -23  # the accumulation's rounding, of its magnitude
ABS = 1e-9
IMAGE_LEVELS = 0     # the 8-bit display values are compared exactly
FIELDS = ("origin", "direction", "direct", "pending")
FIELD_FLOOR = {"origin": 1.0, "direction": 1.0, "direct": 1e-6,
               "pending": 1e-6}
LIMITS = Path(__file__).resolve().parent / "limits.json"


def limits(path: Path = LIMITS) -> dict:
    """The limit of each compared number."""
    return json.loads(path.read_text())["limits"]


@dataclasses.dataclass
class Checked:
    """One checked step: what the reference needs to follow it and what
    the judged side produced at the sampled pixels.

    ``pixels`` [U] the sampled pixels (sorted); ``slots`` [J] every queue
    slot of the step whose ray renders one of them, ``fresh`` [J] whether
    the slot took a fresh camera ray, ``carried`` the carried slots' ray
    fields (the program's state before the step, the start that the
    reference cannot rebuild); ``start``, ``frame``, ``pose`` the step's
    scan start, frame counter (unsalted) and camera; ``before`` [U, 4] the
    accumulation before the step.  Judged outputs: ``after`` [U, 4], the
    survivors whose pixel is sampled (``surv``), and for a displayed frame
    the 8-bit values ``image`` [U, 3], shown from a reset.  A step checked
    from the window's state also has ``sampled``, the positions in
    ``slots`` of the slots drawn uniformly from the queue of ``n_rays``,
    and ``shadow``, the program's count of its valid shadow rays."""

    pixels: torch.Tensor
    slots: torch.Tensor
    fresh: torch.Tensor
    carried: dict
    start: int
    frame: int
    pose: tuple
    before: torch.Tensor
    after: torch.Tensor | None = None
    surv: dict | None = None
    image: torch.Tensor | None = None
    sampled: torch.Tensor | None = None
    shadow: int | None = None
    n_rays: int = 0


def sample_slots(rng: np.random.Generator, n_rays: int, count: int,
                 device) -> torch.Tensor:
    return torch.as_tensor(np.sort(rng.choice(n_rays, size=min(count, n_rays),
                                              replace=False)),
                           dtype=torch.int64, device=device)


def queue_pixels(cfg: dict, start: int, n_carried: int,
                 carried_pixel: torch.Tensor | None, device) -> torch.Tensor:
    """The pixel of every queue slot in a step: a fresh camera ray's for
    the front ``num_rays - n_carried`` slots (the reference's own scan), a
    carried ray's own for the tail."""
    n = cfg["num_rays"]
    slots = torch.arange(n, dtype=torch.int64, device=device)
    pix, _, _ = ref.scan_pixels(cfg["width"], cfg["height"], start, slots)
    if n_carried:
        keep = slots >= n - n_carried
        pix = torch.where(keep, carried_pixel.to(device).long(), pix)
    return pix


def select(pix_all: torch.Tensor, sampled_slots: torch.Tensor,
           n_pixels: int):
    """(pixels U sorted, slots J rendering them, membership mask [P])."""
    u = torch.unique(pix_all[sampled_slots])
    mask = torch.zeros(n_pixels, dtype=torch.bool, device=pix_all.device)
    mask[u] = True
    return u, torch.nonzero(mask[pix_all]).squeeze(1), mask


def survivors(state, mask: torch.Tensor) -> dict:
    """The carried-on rays of a state (its last ``n_carried`` slots) whose
    pixel the mask holds, on the host."""
    n = state.pixel.shape[0]
    tail = slice(n - int(state.n_carried), n)
    pix = state.pixel[tail].long()
    sel = torch.nonzero(mask[pix]).squeeze(1)
    out = {k: getattr(state, k)[tail][sel].detach().cpu()
           for k in ("origin", "direction", "direct", "pending", "bounces",
                     "last_specular")}
    out["pixel"] = pix[sel].cpu()
    return out


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------

def _rays(step: ref.Step, c: Checked, frame_s: int):
    """The step's rays at the checked slots: fresh camera rays from the
    reference's raygen, carried rays as the state held them."""
    sc = step.sc
    dev, dt = sc.device, sc.dtype
    j = c.slots.to(dev)
    fresh = c.fresh.to(dev)
    cam = ref.camera_basis(*c.pose, step.cfg["width"], step.cfg["height"])
    o_f, d_f, pix_f = step.camera_rays(cam, c.start, frame_s, j)
    n = j.shape[0]

    def pick(name, fresh_value):
        car = c.carried[name].to(dev)
        if car.is_floating_point():
            car = car.to(dt)
        sel = fresh[:, None] if fresh_value.ndim == 2 else fresh
        return torch.where(sel, fresh_value, car)
    zeros = torch.zeros((n, 3), dtype=dt, device=dev)
    return dict(origin=pick("origin", o_f), direction=pick("direction", d_f),
                direct=pick("direct", torch.ones_like(zeros)),
                pending=pick("pending", zeros),
                pixel=pick("pixel", pix_f.to(torch.int32)),
                bounces=pick("bounces", torch.zeros(n, dtype=torch.int32,
                                                    device=dev)),
                last_specular=pick("last_specular",
                                   torch.ones(n, dtype=torch.bool,
                                              device=dev)))


def follow(step: ref.Step, c: Checked, run_seed: int) -> dict:
    """The reference's outcome of a checked step: the accumulation delta
    at each sampled pixel ``delta`` [U, 4] (float64), the survivors, the
    8-bit value of each sampled pixel after the step from a reset, and
    whether each followed slot traced a valid shadow ray."""
    frame_s = ref.salted_frame(c.frame, run_seed)
    rays = _rays(step, c, frame_s)
    out = step.run(rays, c.slots.to(step.sc.device), frame_s)
    u = c.pixels.to(step.sc.device)
    pos = torch.searchsorted(u, out["pixel"].long())
    ended = ~out["survive"]
    delta = torch.zeros((u.shape[0], 4), dtype=torch.float64,
                        device=u.device)
    flush = torch.cat([out["pending"].double(),
                       torch.ones_like(out["pending"][:, :1]).double()], 1)
    delta.index_add_(0, pos[ended], flush[ended])
    s = out["survive"]
    surv = {k: out[k][s].detach().cpu() for k in
            ("origin", "direction", "direct", "pending", "bounces",
             "last_specular", "pixel")}
    # the display value, summed in the judged side's precision
    rgb = torch.zeros((u.shape[0], 3), dtype=out["pending"].dtype,
                      device=u.device)
    rgb.index_add_(0, pos[ended], out["pending"][ended])
    image = ref.tonemap_uint8(rgb, delta[:, 3].to(rgb.dtype))
    return dict(delta=delta.cpu(), surv=surv, image=image.cpu(),
                shadow_valid=out["shadow_valid"].cpu())


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _close(a: np.ndarray, b: np.ndarray, floor: float) -> bool:
    return bool(np.all(np.abs(a - b) <= RTOL * np.maximum(np.abs(b), floor)))


def _surv_by_pixel(s: dict) -> dict:
    groups: dict = {}
    pix = s["pixel"].numpy()
    for i, p in enumerate(pix):
        groups.setdefault(int(p), []).append(i)
    return groups


def _rays_match(js: dict, rs: dict, ji: list, ri: list) -> bool:
    """The judged survivors ``ji`` of one pixel against the reference's
    ``ri``: same count, and each reference ray matched by one of the same
    bounces and specular flag whose fields are within RTOL (nearest origin
    first)."""
    if len(ji) != len(ri):
        return False
    left = list(ji)
    for r in ri:
        best, best_d = None, None
        for j in left:
            if int(js["bounces"][j]) != int(rs["bounces"][r]) or \
                    bool(js["last_specular"][j]) != \
                    bool(rs["last_specular"][r]):
                continue
            dist = float(np.abs(js["origin"][j].double().numpy()
                                - rs["origin"][r].double().numpy()).max())
            if best_d is None or dist < best_d:
                best, best_d = j, dist
        if best is None:
            return False
        if not all(_close(js[f][best].double().numpy(),
                          rs[f][r].double().numpy(), FIELD_FLOOR[f])
                   for f in FIELDS):
            return False
        left.remove(best)
    return True


def step_ok(c: Checked, judged: dict, reference: dict) -> np.ndarray:
    """Whether each sampled pixel of a checked step is right: the judged
    accumulation delta and survivors against the reference's."""
    before = c.before.double().cpu().numpy()
    jd = judged["delta"].double().numpy()
    rd = reference["delta"].double().numpy()
    tol = RTOL * np.abs(rd) + ULPS * np.abs(before + rd) + ABS
    ok = np.all(np.abs(jd - rd) <= tol, axis=1) & (jd[:, 3] == rd[:, 3])
    jg, rg = _surv_by_pixel(judged["surv"]), _surv_by_pixel(reference["surv"])
    for i, p in enumerate(c.pixels.cpu().numpy()):
        ok[i] = ok[i] and _rays_match(judged["surv"], reference["surv"],
                                      jg.get(int(p), []), rg.get(int(p), []))
    return ok


def image_ok(judged: torch.Tensor, reference: torch.Tensor) -> np.ndarray:
    """Whether each sampled pixel of a displayed frame shows the
    reference's 8-bit value."""
    gap = (judged.int() - reference.int()).abs().amax(1)
    return (gap <= IMAGE_LEVELS).numpy()


def shadow_z(c: Checked, judged: dict, reference: dict) -> float:
    """The judged count of a checked step's valid shadow rays (the
    program's whole-queue count, or a side that has only its slots' flags
    estimated as the reference is) against the reference's estimate from
    the uniformly sampled slots, in standard errors."""
    valid = reference["shadow_valid"][c.sampled].double()
    n, n_all = valid.shape[0], c.n_rays
    p = float(valid.mean())
    if judged.get("shadow") is not None:
        q = judged["shadow"] / n_all
    else:
        q = float(judged["shadow_valid"][c.sampled].double().mean())
    fpc = (n_all - n) / max(n_all - 1, 1)
    return abs(q - p) / math.sqrt(p * (1.0 - p) / n * fpc + 1.0 / n ** 2)


@dataclasses.dataclass
class Shown:
    """A frame the program displayed, whole: the accumulation ``accum``
    [P, 4] it was resolved from and its 8-bit pixels ``image`` [H, W, 3]."""

    accum: torch.Tensor
    image: torch.Tensor


def display_off(shown: Shown, device) -> float:
    """The share of a shown frame's pixels, of those that show anything
    on either side, whose 8-bit value differs from the reference's resolve
    of its accumulation (on ``device``, the program's)."""
    acc = shown.accum.to(device)
    want = ref.tonemap_uint8(acc[:, :3], acc[:, 3]).cpu()
    got = shown.image.reshape(-1, 3).cpu()
    differs = (want != got).any(1)
    showing = (want != 0).any(1) | (got != 0).any(1)
    return 100.0 * int(differs.sum()) / max(int(showing.sum()), 1)


def follow_all(step: ref.Step, checked: list, run_seed: int) -> dict:
    """:func:`follow` of each checked step, once (a displayed frame that is
    also the checked step is followed once), by ``id``."""
    out = {}
    for c in checked:
        if id(c) not in out:
            out[id(c)] = follow(step, c, run_seed)
    return out


def judge(steps: list, frames: list, judged: dict, reference: dict) -> dict:
    """The compared numbers of judged outcomes (by ``id`` of the checked
    step, in :func:`follow`'s form) against the reference's: the share of
    the sampled pixels that are off, pooled over the checked steps and the
    displayed frames (a frame that is also a checked step is one pixel set,
    off when either test fails), and for steps checked from the window's
    state the largest :func:`shadow_z`."""
    ok: dict = {}
    for c in steps:
        ok[id(c)] = step_ok(c, judged[id(c)], reference[id(c)])
    for c in frames:
        img = image_ok(judged[id(c)]["image"], reference[id(c)]["image"])
        ok[id(c)] = ok[id(c)] & img if id(c) in ok else img
    off = sum(int((~v).sum()) for v in ok.values())
    total = sum(v.shape[0] for v in ok.values())
    out = {"pixels_off_pct": 100.0 * off / max(total, 1)}
    zs = [shadow_z(c, judged[id(c)], reference[id(c)]) for c in steps
          if c.sampled is not None]
    if zs:
        out["shadow_count_z"] = max(zs)
    return out


def program_outcomes(checked: list) -> dict:
    return {id(c): program_judged(c) for c in checked}


def program_judged(c: Checked) -> dict:
    """The program's side of a checked step in the form :func:`follow`
    gives: the exact float64 difference of its accumulation rows (a kept
    frame that is not checked as a step has its image alone) and its count
    of valid shadow rays."""
    delta = None if c.after is None \
        else c.after.double().cpu() - c.before.double().cpu()
    return dict(delta=delta, surv=c.surv, image=c.image, shadow=c.shadow)
