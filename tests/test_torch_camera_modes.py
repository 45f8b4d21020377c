"""The camera modes on the CPU, against the JAX package on the same numpy
inputs: the projections (fisheye, equirect, ortho), the polygonal
aperture (``bokeh_blades``, ``bokeh_rotation``), motion blur and the crop
window.

- ``_primary_dirs``: test_projection's analytic checks on the port.
- ``polygon_sample_disk`` against the JAX function within 1e-6.
- Raygen under each projection, a crop (tiled and scan order), bokeh,
  motion blur (perspective and ortho) and an adaptive visit order against
  the JAX ``_raygen``: pixels and the fisheye's live mask (the zero
  throughput outside its circle) exact, directions within 1e-6, origins
  within 2e-4 (a few ulp of the 170-unit coordinates).
- ``render_aovs`` under ortho against the JAX one (depth within 1e-4,
  normals and albedo within 1e-5), and the flat orthographic depth.
- test_motion_blur without its CLI case, test_crop, and the orthographic
  renders of test_delta_lights and test_light_power (test_torch_lights
  and test_torch_mis_env run their estimator checks with a perspective
  camera; here they run as the JAX tests do)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops import sampling as jsampling
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.scene import Spheres as JSpheres
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import RenderConfig, small_config
from tyrant_tpu_torch.ops import sampling
from tyrant_tpu_torch.scene.scene import (DIFF, LIGHT, DeltaLights, Scene,
                                          Spheres)

from .test_torch_lights import ALBEDO, _point_val
from .test_torch_mis_env import _power_spheres

SUN = (0.05, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# _primary_dirs (test_projection)
# --------------------------------------------------------------------------

def _dirs(cfg, ni, nj):
    cam = Camera()
    cam.position = np.array([0.0, -50.0, 10.0], np.float32)
    params = cam.to_device(cfg, "cpu")
    d, off, live = tr._primary_dirs(cfg, params,
                                    _t(np.float32(ni)), _t(np.float32(nj)))
    return (d.numpy(), None if off is None else off.numpy(),
            None if live is None else live.numpy(), params)


def _unit_basis(params):
    ru = params.right.numpy().astype(float)
    uu = params.up.numpy().astype(float)
    return ru / np.linalg.norm(ru), uu / np.linalg.norm(uu)


def test_perspective_matches_reference_basis():
    cfg = small_config(width=32, height=24)
    d, off, live, params = _dirs(cfg, [0.0, 0.25], [0.0, -0.1])
    assert off is None and live is None
    expect = params.direction.numpy()[None] \
        + np.array([[0.0], [0.25]]) * params.right.numpy()[None] \
        + np.array([[0.0], [-0.1]]) * params.up.numpy()[None]
    expect /= np.linalg.norm(expect, axis=-1, keepdims=True)
    np.testing.assert_allclose(d, expect, atol=1e-6)


def test_fisheye_axis_and_rim():
    cfg = small_config(width=32, height=32, projection="fisheye",
                       fisheye_fov_degrees=180.0)
    d, _, live, params = _dirs(cfg, [0.0, 0.5, -0.5, 0.0],
                               [0.0, 0.0, 0.0, 0.5])
    ru, uu = _unit_basis(params)
    fwd = params.direction.numpy().astype(float)
    np.testing.assert_allclose(d[0], fwd, atol=1e-6)
    np.testing.assert_allclose(d[1], ru, atol=1e-5)
    np.testing.assert_allclose(d[2], -ru, atol=1e-5)
    np.testing.assert_allclose(d[3], uu, atol=1e-5)
    assert live.all()
    _, _, live2, _ = _dirs(cfg, [0.5], [0.5])
    assert not live2[0]


def test_fisheye_fov_scales_angle():
    cfg = small_config(width=32, height=32, projection="fisheye",
                       fisheye_fov_degrees=90.0)
    d, _, _, params = _dirs(cfg, [0.5], [0.0])
    fwd = params.direction.numpy().astype(float)
    np.testing.assert_allclose(float(d[0] @ fwd), np.cos(np.pi / 4),
                               atol=1e-5)


def test_equirect_cardinal_directions():
    cfg = small_config(width=64, height=32, projection="equirect")
    d, off, live, params = _dirs(
        cfg, [0.0, 0.25, -0.25, 0.0, 0.0, 0.4999999],
        [0.0, 0.0, 0.0, 0.5, -0.5, 0.0])
    assert off is None and live is None
    ru, uu = _unit_basis(params)
    fwd = params.direction.numpy().astype(float)
    np.testing.assert_allclose(d[0], fwd, atol=1e-6)
    np.testing.assert_allclose(d[1], ru, atol=1e-5)
    np.testing.assert_allclose(d[2], -ru, atol=1e-5)
    np.testing.assert_allclose(d[3], uu, atol=1e-5)
    np.testing.assert_allclose(d[4], -uu, atol=1e-5)
    np.testing.assert_allclose(d[5], -fwd, atol=1e-4)


def test_ortho_parallel_rays_with_offsets():
    cfg = small_config(width=32, height=16, projection="ortho",
                       ortho_height=8.0)
    d, off, live, params = _dirs(cfg, [0.0, 0.5, 0.0], [0.0, 0.0, -0.5])
    assert live is None
    fwd = params.direction.numpy().astype(float)
    ru, uu = _unit_basis(params)
    np.testing.assert_allclose(d, np.broadcast_to(fwd, (3, 3)), atol=1e-6)
    np.testing.assert_allclose(off[0], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(off[1], 8.0 * ru, atol=1e-4)
    np.testing.assert_allclose(off[2], -4.0 * uu, atol=1e-4)


def test_projection_validation():
    for kw in (dict(projection="pinhole"),
               dict(projection="fisheye", fisheye_fov_degrees=0.0),
               dict(projection="ortho", ortho_height=-1.0),
               dict(bokeh_blades=2), dict(motion_blur=-0.1),
               dict(motion_blur=1.5)):
        with pytest.raises(ValueError):
            RenderConfig(**kw)


@pytest.mark.parametrize("projection", ["fisheye", "equirect", "ortho"])
def test_render_smoke_each_projection(projection):
    cfg = small_config(width=16, height=16, num_rays=1 << 10, max_bounces=3,
                       projection=projection)
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    r = tr.Renderer(Scene.load(None, spheres=Spheres.default_seven()), cfg,
                    device="cpu", sun_position=SUN)
    r.step(cam, 4)
    acc = r.state.accum
    assert torch.isfinite(acc).all() and float(acc[:, 3].sum()) > 0
    aovs = r.aovs()
    for k in ("albedo", "normal", "depth"):
        assert torch.isfinite(aovs[k]).all()


# --------------------------------------------------------------------------
# polygon_sample_disk and raygen against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("blades,rotation", [(3, 0.0), (6, 0.35), (9, 2.0)])
def test_polygon_sample_disk_matches_jax(blades, rotation):
    r = np.random.default_rng(blades)
    u = r.random((20_000, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [0.9999999, 0.9999999], [0.5, 0.5], [1.0, 0.0]]
    got = sampling.polygon_sample_disk(_t(u), blades, rotation).numpy()
    want = np.asarray(jsampling.polygon_sample_disk(jnp.asarray(u), blades,
                                                    rotation))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # inside the regular polygon inscribed in the unit circle
    ang = np.arctan2(got[:, 1], got[:, 0]) - rotation
    sector = 2 * np.pi / blades
    a = np.mod(ang, sector) - sector / 2
    apothem = np.cos(np.pi / blades)
    assert (np.hypot(got[:, 0], got[:, 1]) * np.cos(a)
            <= apothem + 1e-5).all()


RAYGEN_CASES = {
    "fisheye": dict(projection="fisheye", fisheye_fov_degrees=180.0),
    "fisheye_120": dict(projection="fisheye", fisheye_fov_degrees=120.0),
    "equirect": dict(projection="equirect"),
    "ortho": dict(projection="ortho", ortho_height=30.0),
    "crop_tiled": dict(crop=(8, 8, 16, 8)),
    "crop_scan": dict(crop=(3, 5, 13, 7)),
    "bokeh": dict(bokeh_blades=6, bokeh_rotation=20.0),
    "blur": dict(motion_blur=0.5),
    "blur_ortho_bokeh": dict(motion_blur=1.0, projection="ortho",
                             ortho_height=30.0, bokeh_blades=5),
    "perm": dict(adaptive_sampling="on"),
    "seed_blur": dict(motion_blur=0.7, seed=11),
    "sobol_blur_fisheye": dict(sampler="sobol", motion_blur=0.6, seed=3,
                               projection="fisheye"),
    "sobol_crop_bokeh": dict(sampler="sobol", crop=(8, 8, 16, 8),
                             bokeh_blades=7),
}


def _cams(dx=0.0):
    cam, jcam = Camera(), JCamera()
    for c in (cam, jcam):
        c.position = np.array([dx, -170.0, 40.0], np.float32)
        c.vertical_angle = -0.10 + 0.01 * dx
        c.horizontal_angle = 0.02 * dx
        c.lens_radius = 0.8
        c.focal_distance = 40.0
    return cam, jcam


@pytest.mark.parametrize("case", list(RAYGEN_CASES))
def test_raygen_matches_jax(case):
    kw = RAYGEN_CASES[case]
    cfg = small_config(width=32, height=24, num_rays=4096, **kw)
    jcfg = jsmall_config(width=32, height=24, num_rays=4096, **kw)
    cam, jcam = _cams()
    camt, camd = cam.to_device(cfg, "cpu"), jcam.to_device(jcfg)
    prev_t = prev_d = None
    if cfg.motion_blur:
        pcam, pjcam = _cams(6.0)
        prev_t, prev_d = pcam.to_device(cfg, "cpu"), pjcam.to_device(jcfg)
    perm_t = perm_d = None
    if cfg.adaptive_sampling == "on":
        p = np.sort(np.random.default_rng(3).integers(
            0, cfg.num_pixels, cfg.num_pixels)).astype(np.int32)
        perm_t, perm_d = _t(p), jnp.asarray(p)
    for start, frame in ((0, 1), (517, 9), (700, 123456)):
        want = jr._raygen(jcfg, camd, jnp.int32(start),
                          jnp.uint32(tr._salted_frame(cfg, frame)),
                          cfg.height, 0, perm=perm_d,
                          sample_base=jnp.uint32(frame % 5), cam_prev=prev_d)
        got = tr._raygen(cfg, camt, torch.tensor(start),
                         torch.tensor(tr._salted_frame(cfg, frame)),
                         perm=perm_t, sample_base=torch.tensor(frame % 5),
                         cam_prev=prev_t)
        np.testing.assert_array_equal(got["pixel"].numpy(),
                                      np.asarray(want["pixel"]))
        if cfg.sampler == "sobol":
            np.testing.assert_array_equal(
                got["sample_idx"].numpy(),
                np.asarray(want["sample_idx"]).astype(np.int64))
        # the fisheye's live mask is the throughput (0 outside its circle)
        np.testing.assert_array_equal(got["direct"].numpy(),
                                      np.asarray(want["direct"]))
        np.testing.assert_allclose(got["direction"].numpy(),
                                   np.asarray(want["direction"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["origin"].numpy(),
                                   np.asarray(want["origin"]), rtol=0,
                                   atol=2e-4)
    if cfg.projection == "fisheye":
        assert 0 < (got["direct"][:, 0] == 0).sum() < cfg.num_rays // 2
    if cfg.crop is not None:
        x0, y0, cw, ch = cfg.crop
        px = got["pixel"].numpy()
        assert ((px % 32 >= x0) & (px % 32 < x0 + cw) & (px // 32 >= y0)
                & (px // 32 < y0 + ch)).all()


def test_render_aovs_under_ortho_match_jax():
    kw = dict(projection="ortho", ortho_height=80.0)
    cfg = small_config(width=24, height=16, **kw)
    jcfg = jsmall_config(width=24, height=16, **kw)
    cam, jcam = _cams()
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    got = tr.render_aovs(r.scene, cam.to_device(cfg, "cpu"), cfg, r.tables)
    want = jr.render_aovs(JScene.load(None).to_device(),
                          jcam.to_device(jcfg), jcfg)
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), rtol=1e-4)
    for k in ("normal", "albedo"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    # the ortho origins: pixel-centre offsets off the pinhole
    o, _ = tr.aov_primaries(cam.to_device(cfg, "cpu"), cfg)
    assert float(o.std(0).max()) > 10.0


def test_ortho_depth_of_plane_is_constant():
    sp = Spheres(center=np.array([[0.0, 0.0, -1e5]], np.float32),
                 radius=np.array([1e5], np.float32),
                 color=np.array([[0.8, 0.8, 0.8]], np.float32),
                 emission=np.zeros((1, 3), np.float32),
                 refl=np.array([DIFF], np.int32))
    scene = Scene.load(None, spheres=sp)
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -np.pi / 2 + 1e-3
    depths = {}
    for proj in ("perspective", "ortho"):
        cfg = small_config(width=8, height=8, num_rays=1 << 8,
                           projection=proj, ortho_height=20.0)
        r = tr.Renderer(scene, cfg, device="cpu")
        depths[proj] = tr.render_aovs(r.scene, cam.to_device(cfg, "cpu"),
                                      cfg, r.tables)["depth"].numpy()
    assert depths["ortho"].std() < 1e-2
    assert depths["perspective"].std() > 1e-1


# --------------------------------------------------------------------------
# motion blur (test_motion_blur)
# --------------------------------------------------------------------------

MB = 32


def _mb_spheres():
    return Spheres(
        center=np.array([[0.0, 0.0, -1e4], [0.0, 0.0, 10.0]], np.float32),
        radius=np.array([1e4, 4.0], np.float32),
        color=np.array([[0.05, 0.05, 0.05], [1, 1, 1]], np.float32),
        emission=np.array([[0, 0, 0], [8, 8, 8]], np.float32),
        refl=np.array([DIFF, LIGHT], np.int32))


def _mb_cam(x=0.0):
    cam = Camera()
    cam.position = np.array([x, 0.0, 50.0], np.float32)
    cam.vertical_angle = -np.pi / 2 + 1e-3
    return cam


def _two_frames(shutter, dx, steps=8):
    """Frame 0 at x=0, frame 1 at x=dx: frame 1's image."""
    cfg = small_config(width=MB, height=MB, num_rays=1 << 12, max_bounces=1,
                       projection="ortho", ortho_height=80.0,
                       motion_blur=shutter)
    r = tr.Renderer(Scene.load(None, spheres=_mb_spheres()), cfg,
                    device="cpu")
    r.step(_mb_cam(0.0), 2)
    r.step(_mb_cam(dx), steps)
    acc = r.state.accum.numpy()
    return (acc[:, :3] / np.maximum(acc[:, 3:4], 1e-9)).reshape(MB, MB, 3)


def test_zero_motion_is_bit_identical():
    np.testing.assert_array_equal(_two_frames(0.0, 0.0),
                                  _two_frames(1.0, 0.0))


def test_shutter_zero_matches_no_blur_after_motion():
    np.testing.assert_array_equal(_two_frames(0.0, 12.0),
                                  _two_frames(0.0, 12.0))


def _bright_extent(img):
    cols = np.nonzero((img[:, :, 0] > 1.0).any(axis=0))[0]
    return (cols.min(), cols.max()) if cols.size else (0, -1)


def test_streak_extends_against_motion():
    sharp = _two_frames(0.0, 12.0)
    blurred = _two_frames(1.0, 12.0)
    s_lo, s_hi = _bright_extent(sharp)
    b_lo, b_hi = _bright_extent(blurred)
    assert s_hi >= s_lo
    assert b_hi - b_lo >= (s_hi - s_lo) + 3
    assert b_hi >= s_hi + 3
    assert abs(b_lo - s_lo) <= 1


def test_partial_shutter_shorter_streak():
    f_lo, f_hi = _bright_extent(_two_frames(1.0, 15.0))
    h_lo, h_hi = _bright_extent(_two_frames(0.5, 15.0))
    assert 0 < (h_hi - h_lo) < (f_hi - f_lo)


def test_blurred_renderers_match_jax():
    """The motion-blurred pair of frames through both Renderers: the same
    carried rays in the same slots after frame 1's third step, and the
    path counts equal."""
    kw = dict(width=MB, height=MB, num_rays=1 << 12, max_bounces=2,
              motion_blur=0.8)
    tren = tr.Renderer(Scene.load(None, spheres=_mb_spheres()),
                       small_config(**kw), device="cpu")
    jsp = _mb_spheres()
    jren = jr.Renderer(JScene.load(None, spheres=JSpheres(
        center=jsp.center, radius=jsp.radius, color=jsp.color,
        emission=jsp.emission, refl=jsp.refl)), jsmall_config(**kw),
        donate=False)
    for ren, cls in ((tren, Camera), (jren, JCamera)):
        for i, dx in enumerate((0.0, 9.0)):
            cam = cls()
            cam.position = np.array([dx, -60.0, 50.0], np.float32)
            cam.vertical_angle = -0.6
            ren.step(cam, 2 + i)
    n = int(tren.state.n_carried)
    assert n == int(jren.state.n_carried) and n > 0
    for k in ("pixel", "bounces"):
        np.testing.assert_array_equal(getattr(tren.state, k).numpy()[:n],
                                      np.asarray(getattr(jren.state, k))[:n])
    np.testing.assert_array_equal(tren.state.accum[:, 3].numpy(),
                                  np.asarray(jren.state.accum)[:, 3])


def test_camera_look_at():
    cam = Camera()
    cam.position = np.array([10.0, -20.0, 30.0], np.float32)
    for target in ([0, 0, 0], [5, 40, -10], [10, -20, 80]):
        cam.look_at(target)
        d = np.asarray(target, np.float64) - cam.position
        n = np.linalg.norm(d)
        got = np.asarray(cam.direction, np.float64)
        if abs(d[2] / n) < 0.999:
            np.testing.assert_allclose(got, d / n, atol=1e-6)
        else:
            assert abs(cam.vertical_angle) < np.pi / 2


# --------------------------------------------------------------------------
# crop (test_crop)
# --------------------------------------------------------------------------

CW, CH = 32, 24


def _crop_alpha(cfg, steps=3):
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    r.step(cam, steps)
    a = r.state.accum.numpy()
    return a[:, 3].reshape(CH, CW), a


def test_crop_coverage_and_black_outside():
    alpha, _ = _crop_alpha(small_config(width=CW, height=CH,
                                        num_rays=1 << 10,
                                        crop=(8, 4, 16, 16)))
    inside = alpha[4:20, 8:24]
    outside = alpha.copy()
    outside[4:20, 8:24] = 0
    assert (inside > 0).all()
    assert (outside == 0).all()


def test_crop_matches_full_render_statistically():
    full = small_config(width=CW, height=CH, num_rays=1 << 12)
    _, a_full = _crop_alpha(full, steps=24)
    _, a_crop = _crop_alpha(dataclasses.replace(full, crop=(8, 4, 16, 16)),
                            steps=24)

    def mean_img(a):
        return (a[:, :3].mean(1) / np.maximum(a[:, 3], 1)).reshape(CH, CW)

    region = np.s_[6:18, 10:22]
    mf = mean_img(a_full)[region].mean()
    mc = mean_img(a_crop)[region].mean()
    assert abs(mf - mc) / mf < 0.05, (mf, mc)


def test_crop_tiles_compose():
    base = small_config(width=CW, height=CH, num_rays=1 << 10)
    al, _ = _crop_alpha(dataclasses.replace(base, crop=(0, 0, 16, CH)))
    ar, _ = _crop_alpha(dataclasses.replace(base, crop=(16, 0, 16, CH)))
    assert (al[:, :16] > 0).all() and (al[:, 16:] == 0).all()
    assert (ar[:, 16:] > 0).all() and (ar[:, :16] == 0).all()


def test_crop_validation():
    cam = Camera()
    with pytest.raises(ValueError, match="outside"):
        tr.Renderer(Scene.load(None), small_config(
            width=CW, height=CH, num_rays=256, crop=(20, 0, 16, 8)),
            device="cpu").step(cam, 1)
    with pytest.raises(ValueError, match="adaptive"):
        tr.Renderer(Scene.load(None), small_config(
            width=CW, height=CH, num_rays=256, crop=(0, 0, 8, 8),
            adaptive_sampling="on"), device="cpu").step(cam, 1)


# --------------------------------------------------------------------------
# the orthographic renders of test_delta_lights and test_light_power
# --------------------------------------------------------------------------

DL_W = 32
DL_ORTHO_H, DL_CAM_Z = 100.0, 50.0


def _down(z):
    cam = Camera()
    cam.position = np.array([0.0, 0.0, z], np.float32)
    cam.vertical_angle = -np.pi / 2 + 1e-3
    return cam


def _dl_cfg(mis=False):
    return small_config(width=DL_W, height=DL_W, num_rays=1 << 12,
                        max_bounces=0, projection="ortho",
                        ortho_height=DL_ORTHO_H, mis="on" if mis else "off")


def _dl_render(specs, steps=6, mis=False, spheres=None):
    floor = Spheres(center=np.array([[0.0, 0.0, -1e4]], np.float32),
                    radius=np.array([1e4], np.float32),
                    color=np.array([[ALBEDO] * 3], np.float32),
                    emission=np.zeros((1, 3), np.float32),
                    refl=np.array([DIFF], np.int32))
    scene = Scene.load(None, spheres=spheres or floor,
                       delta_lights=DeltaLights.from_specs(specs))
    r = tr.Renderer(scene, _dl_cfg(mis), device="cpu", sun_position=SUN)
    r.step(_down(DL_CAM_Z), steps)
    acc = r.state.accum.numpy()
    return (acc[:, :3] / np.maximum(acc[:, 3:4], 1e-9)).reshape(DL_W, DL_W,
                                                                  3)


def _ortho_floor_points(ss=1):
    """The z=0 floor point of every (sub)pixel through the port's own
    orthographic rays (raygen's px = x - u puts pixel x's samples in
    [x-1, x])."""
    cfg = _dl_cfg()
    params = _down(DL_CAM_Z).to_device(cfg, "cpu")
    w = h = DL_W * ss
    q = np.arange(w * h)
    ni = ((q % w) - ss + 0.5) / w - 0.5
    nj = (h - (q // w) + ss - 0.5) / h - 0.5
    d, off, _ = tr._primary_dirs(cfg, params, _t(ni.astype(np.float32)),
                                 _t(nj.astype(np.float32)))
    d = d.numpy().astype(np.float64)
    o = params.position.numpy().astype(np.float64)[None] \
        + off.numpy().astype(np.float64)
    return (o - (o[:, 2] / d[:, 2])[:, None] * d).reshape(h, w, 3)


def _block(m, ss):
    return m.reshape(DL_W, ss, DL_W, ss).mean(axis=(1, 3)) if ss > 1 else m


def test_ortho_point_inverse_square_and_cosine():
    base = {"type": "point", "intensity": [2000, 2000, 2000]}
    r0 = _dl_render([dict(base, position=[0, 0, 50], intensity=[0, 0, 0])],
                    steps=12)
    ra = _dl_render([dict(base, position=[0, 0, 50])], steps=12) - r0
    rb = _dl_render([dict(base, position=[10, 0, 100])], steps=12) - r0
    ss = 8
    pts = _ortho_floor_points(ss)
    expect = _block(_point_val(pts, [0, 0, 50], base["intensity"]), ss) \
        / _block(_point_val(pts, [10, 0, 100], base["intensity"]), ss)
    got = ra[:, :, 0] / np.maximum(rb[:, :, 0], 1e-12)
    mask = rb[:, :, 0] > 1e-4
    assert mask.sum() > 200
    err = np.abs(got[mask] / expect[mask] - 1.0)
    assert np.median(err) < 0.02
    assert np.percentile(err, 95) < 0.08
    assert err.max() < 0.25


def test_ortho_spot_cone_and_soft_falloff():
    pts = _ortho_floor_points()
    r = np.hypot(pts[:, :, 0], pts[:, :, 1])
    h, outer = 40.0, 25.0
    point = {"type": "point", "position": [0, 0, h],
             "intensity": [500, 500, 500]}
    spot = {"type": "spot", "position": [0, 0, h], "direction": [0, 0, -1],
            "intensity": [500, 500, 500], "inner_deg": outer,
            "outer_deg": outer}
    r0 = _dl_render([dict(point, intensity=[0, 0, 0])])
    dp = _dl_render([point]) - r0
    ds = _dl_render([spot]) - r0
    edge = h * np.tan(np.radians(outer))
    outside, inside = r > edge + 3.0, r < edge - 3.0
    assert outside.sum() > 50 and inside.sum() > 50
    np.testing.assert_allclose(ds[outside], 0.0, atol=1e-7)
    np.testing.assert_allclose(ds[inside], dp[inside], rtol=1e-5, atol=1e-6)
    # the Hermite falloff between 10 and 35 degrees
    h = 70.0
    spot = dict(spot, position=[0, 0, h], intensity=[2000] * 3,
                inner_deg=10.0, outer_deg=35.0)
    point = dict(point, position=[0, 0, h], intensity=[2000] * 3)
    r0 = _dl_render([dict(spot, intensity=[0, 0, 0])])
    ds = (_dl_render([spot]) - r0)[:, :, 0]
    dp = (_dl_render([point]) - r0)[:, :, 0]
    ok = dp > 1e-5
    fall = np.where(ok, ds / np.maximum(dp, 1e-12), 0.0)
    inner = ok & (r < h * np.tan(np.radians(10.0)) - 2.5)
    mid = ok & (r > h * np.tan(np.radians(15.0)) + 2.5) \
        & (r < h * np.tan(np.radians(30.0)) - 2.5)
    outer_m = ok & (r > h * np.tan(np.radians(35.0)) + 3.0)
    assert inner.sum() > 10 and mid.sum() > 50 and outer_m.sum() > 20
    np.testing.assert_allclose(fall[inner], 1.0, rtol=0.02)
    assert 0.01 < fall[mid].mean() < 0.95
    np.testing.assert_allclose(fall[outer_m], 0.0, atol=1e-6)


def test_ortho_directional_and_umbra():
    point = {"type": "point", "position": [0, 0, 30],
             "intensity": [500, 500, 500]}
    sun = {"type": "directional", "direction": [0, 0, -1],
           "intensity": [2, 2, 2]}
    dark = dict(point, intensity=[0, 0, 0])
    dp = (_dl_render([point]) - _dl_render([dark]))[:, :, 0]
    dd = (_dl_render([dark, sun])
          - _dl_render([dark, dict(sun, intensity=[0, 0, 0])]))[:, :, 0]
    pts = _ortho_floor_points()
    assert abs(dd.mean() / ((ALBEDO / np.pi) * 2.0) - 1.0) < 0.15
    assert dd.std() / dd.mean() < 0.6
    expect_pt = _point_val(pts, [0, 0, 30], point["intensity"])
    assert abs((dp / expect_pt).mean() - 1.0) < 0.15
    # the umbra of a blocker (r=5 at z=32) under a point light at z=45
    blocker = Spheres(
        center=np.array([[0.0, 0.0, -1e4], [0.0, 0.0, 32.0]], np.float32),
        radius=np.array([1e4, 5.0], np.float32),
        color=np.array([[ALBEDO] * 3, [0.2, 0.2, 0.2]], np.float32),
        emission=np.zeros((2, 3), np.float32),
        refl=np.array([DIFF, DIFF], np.int32))
    light = {"type": "point", "position": [0, 0, 45],
             "intensity": [800, 800, 800]}
    r0 = _dl_render([dict(light, intensity=[0, 0, 0])], spheres=blocker)
    d = (_dl_render([light], spheres=blocker) - r0)[:, :, 0]
    r = np.hypot(pts[:, :, 0], pts[:, :, 1])
    umbra = (r > 7.5) & (r < 15.0)
    lit = (r > 19.7) & (r < 45.0)
    assert umbra.sum() > 20 and lit.sum() > 100
    np.testing.assert_allclose(d[umbra], 0.0, atol=1e-7)
    assert (d[lit] > 1e-5).mean() > 0.5


PW = 16


def _p_render(sampling, steps, mis=False, bounces=0, projection="ortho"):
    cfg = small_config(width=PW, height=PW, num_rays=1 << 10,
                       max_bounces=bounces, projection=projection,
                       ortho_height=60.0, light_sampling=sampling,
                       mis="on" if mis else "off")
    r = tr.Renderer(Scene.load(None, spheres=_power_spheres()), cfg,
                    device="cpu", sun_position=SUN)
    r.step(_down(40.0), steps)
    acc = r.state.accum.numpy()
    return (acc[:, :3] / np.maximum(acc[:, 3:4], 1e-9)).reshape(PW, PW, 3)


def test_ortho_power_unbiased_and_lower_variance():
    u = _p_render("uniform", 500)
    p = _p_render("power", 500)
    lit = u[:, :, 0] > np.percentile(u[:, :, 0], 40)
    err = np.abs(p - u)[lit].mean() / u[lit].mean()
    assert err < 0.055, err
    g = abs(p[lit].mean() - u[lit].mean()) / u[lit].mean()
    assert g < 0.015, g
    floor = p[:, :, 0] < 1.0
    mse_u = float(np.mean((_p_render("uniform", 24) - p)[floor] ** 2))
    mse_p = float(np.mean((_p_render("power", 24) - p)[floor] ** 2))
    assert mse_p < 0.35 * mse_u, (mse_p, mse_u)


def test_ortho_power_with_mis_same_mean():
    u = _p_render("uniform", 260, mis=True, bounces=1)
    p = _p_render("power", 260, mis=True, bounces=1)
    lit = u[:, :, 0] > np.percentile(u[:, :, 0], 40)
    err = np.abs(p - u)[lit].mean() / u[lit].mean()
    assert err < 0.07, err

