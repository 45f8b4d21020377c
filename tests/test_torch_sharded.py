"""The strip-parallel path of the port (``parallel/sharded.py``) and the
render step's ``local_height``/``row_offset`` on the CPU, against the JAX
package on the same inputs.

- The port's ``ShardedRenderer(devices=["cpu"] * 8)`` against the JAX
  one on the conftest's 8 CPU devices (16x16, 512 rays a strip, 2 steps),
  plain and under fog, MIS and adaptive sampling with each sampler: every
  strip's pixel, bounces, n_carried, start_position, frame and
  sample_base exact, its float leaves within test_torch_render_step's
  1e-4 on all but the few rays :data:`FAR_MAX` allows.
- The last strip's shade from identical inputs under the same configs,
  with test_torch_render_step's rules: every random stream there takes
  the strip's ``row_offset``.
- One strip step (``local_height=8, row_offset=8``) from a JAX strip
  state carried over through interop, against the JAX step.
- One strip bit for bit the port's ``Renderer``; crop refused on strips.
- test_sharded.py's cases and the sharded cases of test_mis, test_fog,
  test_sobol and test_adaptive, on the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.parallel import sharded as jsharded
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.parallel import sharded
from tyrant_tpu_torch.scene.scene import GGX, Scene

SUN = (0.05, 0.3)
CLOSE = dict(rtol=1e-4, atol=1e-4)  # test_torch_render_step's tolerance
EXACT = ("pixel", "bounces", "n_carried", "start_position", "frame",
         "sample_base", "last_specular", "sample_idx")
# the per-strip scalars of the JAX global state, one entry a strip
SCALARS = ("n_carried", "start_position", "frame", "shadow_rays",
           "sample_base")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam(cls=Camera):
    cam = cls()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def _strip_fields(jstate, i: int, n_dev: int) -> dict:
    """Strip ``i`` of the JAX global state, as numpy, by field."""
    out = {}
    for k in interop.STATE_FIELDS:
        a = np.asarray(getattr(jstate, k))
        if k in SCALARS:
            out[k] = a[i]
        else:
            m = a.shape[0] // n_dev
            out[k] = a[i * m:(i + 1) * m]
    return out


def _check_ints(tst, want: dict, what: str):
    """The integer fields and the path counts (lane 3 of accum and
    moment2) exact."""
    for k in interop.STATE_FIELDS:
        got = getattr(tst, k).numpy()
        w = np.asarray(want[k])
        if k in ("accum", "moment2"):
            got, w = got[:, 3], w[:, 3]
        elif k not in EXACT and k not in SCALARS:
            continue
        np.testing.assert_array_equal(
            got, w.astype(got.dtype) if got.dtype != bool else w,
            err_msg=f"{what} {k}")


def _far_rays(states, wants) -> dict:
    """By per-ray float field: the number of rays, over every strip, off
    by more than CLOSE."""
    out = {}
    for k in FAR_MAX:
        far = [~np.isclose(getattr(st, k).numpy(), np.asarray(w[k]), **CLOSE)
               for st, w in zip(states, wants)]
        out[k] = int(sum(f.reshape(f.shape[0], -1).any(1).sum()
                         for f in far))
    return out


def check_strips(states, wants, what: str, img, want_img):
    """Each strip's integers exact; each per-ray float field within 1e-4
    on all but at most FAR_MAX[field] of the rays, and the resolved
    images within a mean of 1e-4."""
    for i, (st, w) in enumerate(zip(states, wants)):
        _check_ints(st, w, f"{what} strip {i}")
    far = _far_rays(states, wants)
    assert all(far[k] <= FAR_MAX[k] for k in far), (what, far)
    mad = float(np.abs(np.asarray(img) - np.asarray(want_img)).mean())
    assert mad < 1e-4, (what, mad)


# The most rays (of the 4096 in 8 strips after 2 steps) off by more than
# CLOSE, by field: the largest count over seeds 0-7 of each case of CASES.
# Two steps compound float32 differences that one shade from identical
# inputs does not show (test_strip_shade_matches_jax): a hit on the
# default scene's 1e5-radius floor sphere, where b*b - |op|^2 + r^2
# cancels at 1e10 (an ulp of 1024), lands about 1e-3 apart in the two
# packages, and a shadow test from such a point can go either way.
# ``direct`` and ``bsdf_pdf`` agree on every ray.
FAR_MAX = {"origin": 30, "direction": 6, "direct": 0, "pending": 73,
           "bsdf_pdf": 0}
CASES = {
    "plain": {},
    "xorshift-fog-mis-adaptive": dict(
        fog="on", fog_sigma_s=0.01, fog_z_max=80.0, mis="on",
        adaptive_sampling="on", adaptive_interval=2),
    "sobol-fog-mis": dict(
        sampler="sobol", fog="on", fog_sigma_s=0.01, fog_z_max=80.0,
        mis="on"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_strips_match_jax(case):
    """Every strip's state after 2 steps against the JAX shard's (see
    :func:`check_strips`).  Under adaptive sampling (rebuilt after step 2)
    each strip's visit order is the port's ``build_perm`` of the JAX
    strip's moments, exactly, in local ids."""
    from tyrant_tpu_torch import adaptive as tad
    kw = CASES[case]
    n_dev = 8
    jren = jsharded.ShardedRenderer(
        JScene.load(None), jsmall_config(width=16, height=16,
                                         num_rays=1 << 9, **kw))
    assert jren.mesh.devices.size == n_dev
    tren = sharded.ShardedRenderer(
        Scene.load(None), small_config(width=16, height=16, num_rays=1 << 9,
                                       **kw), devices=["cpu"] * n_dev)
    jren.step(_cam(JCamera), 2)
    tren.step(_cam(), 2)
    assert len(tren.states) == n_dev
    wants = [_strip_fields(jren.state, i, n_dev) for i in range(n_dev)]
    check_strips(tren.states, wants, case, tren.image(), jren.image())
    assert sum(float(st.accum[:, 3].sum()) for st in tren.states) > 0
    if tren.cfg.adaptive_sampling == "on":
        assert tren._sched.rebuilds == jren._sched.rebuilds == 1
        for st, w in zip(tren.states, wants):
            perm = tad.build_perm(torch.from_numpy(w["accum"].copy()),
                                  torch.from_numpy(w["moment2"].copy()),
                                  torch.tensor(0.6180339887 % 1.0,
                                               dtype=torch.float32))
            np.testing.assert_array_equal(perm.numpy(), w["pixel_perm"])
            own = st.pixel_perm.numpy()
            assert own.shape == (16 * 2,) and own.min() >= 0 \
                and own.max() < 16 * 2


# CASES, and the light pick's, the sphere, triangle and delta lights' and
# the envmap's streams on test_torch_lights' scene of every light kind
SHADE_CASES = dict(CASES, lights=dict(mis="on", light_sampling="power"))


def _shade_scenes(case):
    """(JAX Scene, port Scene) of a SHADE_CASES entry."""
    if case != "lights":
        return JScene.load(None), Scene.load(None)
    from .test_torch_lights import both, hot_envmap
    return both(n_sphere_lights=3, n_tri=20, delta=True,
                envmap=hot_envmap())


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_strip_shade_matches_jax(case):
    """The last strip's queue (rows 14-15, row_offset 14) after 2 steps of
    the port's ShardedRenderer, extended by the JAX package and shaded by
    both from these same inputs, by test_torch_render_step's rules:
    survive and the shadow rays' valid equal on >= 99.9% of the slots,
    the next rays' integers exact and every float output within 1e-4
    where both agree.  Every random stream of the shade (bounce, Russian
    roulette, light pick and light samples, envmap, fog, Sobol) is keyed
    by the strip's row_offset, so a stream that missed it would differ on
    every ray that draws from it."""
    kw = dict(width=16, height=16, num_rays=1 << 9, **SHADE_CASES[case])
    cfg, jcfg = small_config(**kw), jsmall_config(**kw)
    js, ts = _shade_scenes(case)
    r = sharded.ShardedRenderer(ts, cfg, devices=["cpu"] * 8)
    r.step(_cam(), 2)
    st, off = r.states[-1], 14
    rep = r.replicas[torch.device("cpu")]
    rays = tr.merge_queue(cfg, st, _cam().to_device(cfg, "cpu"),
                          local_height=2, row_offset=off)
    jd = js.to_device()
    jrays = {k: jnp.asarray(v.numpy()) for k, v in rays.items()}
    jt, jid, jtri, _ = jr._intersect_scene(jrays["origin"],
                                           jrays["direction"], jd)
    frame = int(tr._salted_frame(cfg, st.frame))
    jc, _, jsurv, jnext, jshadow = jr._shade(
        jcfg, jd, jsky.SkyParams(jcfg.sky), jnp.asarray(rep.sun_dir.numpy()),
        jrays, jt, jid, jtri, jnp.uint32(frame), row_offset=off)
    tc, tsurv, tnext, tshadow = tr._shade(
        cfg, rep.scene, tsky.SkyParams(cfg.sky), rep.sun_dir, rays,
        torch.from_numpy(np.array(jt)), torch.from_numpy(np.array(jid)),
        torch.from_numpy(np.array(jtri)), torch.tensor(frame),
        row_offset=off)
    agree = tsurv.numpy() == np.asarray(jsurv)
    assert agree.mean() >= 0.999, agree.mean()
    ok = agree & (tshadow["valid"].numpy() == np.asarray(jshadow["valid"]))
    assert ok.mean() >= 0.999
    assert tshadow["valid"].numpy().sum() > 100
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], **CLOSE)
    for k in ("pixel", "bounces", "last_specular") + \
            (("sample_idx",) if cfg.sampler == "sobol" else ()):
        np.testing.assert_array_equal(tnext[k].numpy()[ok],
                                      np.asarray(jnext[k])[ok], err_msg=k)
    for k in ("origin", "direction", "direct") + \
            (("bsdf_pdf",) if cfg.mis == "on" else ()):
        np.testing.assert_allclose(tnext[k].numpy()[ok],
                                   np.asarray(jnext[k])[ok], **CLOSE,
                                   err_msg=k)
    for k in ("origin", "direction", "color"):
        np.testing.assert_allclose(tshadow[k].numpy()[ok],
                                   np.asarray(jshadow[k])[ok], **CLOSE,
                                   err_msg=k)


def test_strip_step_matches_jax():
    """One step of rows 8-15 of a 16x16 frame (local_height 8, row_offset
    8) from the JAX strip state after 3 steps, on the terrain with random
    materials: the queue merge's pixels exact and rays within 1e-5, the
    next state's integers exact and floats within 1e-4."""
    from .test_torch_render import _jax_camera, _jax_scene
    kw = dict(width=16, height=16, num_rays=1 << 10)
    jcfg, tcfg = jsmall_config(**kw), small_config(**kw)
    jd, td, tables = _jax_scene()
    camd, camt = _jax_camera(jcfg)
    jsun = jsky.sun_direction_from_position(jnp.asarray(SUN))
    tsun = tsky.sun_direction_from_position(SUN, "cpu")
    jstep = jax.jit(functools.partial(jr.render_step, cfg=jcfg,
                                      local_height=8, row_offset=8))
    st = jr.init_state(jcfg, local_height=8)
    for _ in range(3):
        st = jstep(st, jd, camd, jsun)
    fields = {k: np.array(getattr(st, k)) for k in interop.STATE_FIELDS}
    assert fields["accum"].shape == (16 * 8, 4)
    assert 0 < fields["n_carried"] < jcfg.num_rays

    gen = jr._raygen(jcfg, camd, st.start_position, st.frame, 8, 8)
    tgen = tr._raygen(tcfg, camt, torch.tensor(int(fields["start_position"])),
                      torch.tensor(int(fields["frame"])), local_height=8,
                      row_offset=8)
    np.testing.assert_array_equal(tgen["pixel"].numpy(),
                                  np.asarray(gen["pixel"]))
    assert tgen["pixel"].max() < 16 * 8
    for k in ("origin", "direction"):
        np.testing.assert_allclose(tgen[k].numpy(), np.asarray(gen[k]),
                                   rtol=1e-5, atol=1e-6)

    jst = jstep(st, jd, camd, jsun)
    tst = tr.render_step(interop.state_from_numpy(fields, "cpu"), td, camt,
                         tsun, cfg=tcfg, tables=tables, local_height=8,
                         row_offset=8)
    want = {k: np.asarray(getattr(jst, k)) for k in interop.STATE_FIELDS}
    check_strips([tst], [want], "strip step", resolve(tst.accum, 16, 8),
                 resolve(torch.from_numpy(want["accum"].copy()), 16, 8))


def test_row_offset_moves_the_rows_and_streams():
    """A strip's rays land in its own image rows, and its seeds differ
    from the frame's first strip (the same local pixels, another jitter)."""
    cfg = small_config(width=16, height=16, num_rays=256)
    cam = _cam().to_device(cfg, "cpu")
    a = tr._raygen(cfg, cam, torch.tensor(0), torch.tensor(1),
                   local_height=8, row_offset=0)
    b = tr._raygen(cfg, cam, torch.tensor(0), torch.tensor(1),
                   local_height=8, row_offset=8)
    np.testing.assert_array_equal(a["pixel"].numpy(), b["pixel"].numpy())
    # below the first strip: the primaries point lower
    assert (b["direction"][:, 2] < a["direction"][:, 2]).float().mean() > 0.9


def test_one_strip_is_the_renderer():
    """``ShardedRenderer(devices=["cpu"])`` bit for bit the eager
    ``Renderer`` on every state field, over two calls of ``step``.  (A
    new pose starts the strips afresh, frame counter included, as in the
    JAX package, where the Renderer keeps its counter.)"""
    cfg = small_config(width=16, height=16, num_rays=1 << 10, mis="on")
    scene = Scene.load(None)
    s = sharded.ShardedRenderer(scene, cfg, devices=["cpu"])
    r = tr.Renderer(scene, cfg, device="cpu")
    for n in (3, 2):
        s.step(_cam(), n)
        r.step(_cam(), n)
        for f in interop.STATE_FIELDS:
            assert torch.equal(getattr(s.states[0], f),
                               getattr(r.state, f)), f
    assert torch.equal(s.image(), r.image())


def test_strip_moments_under_track_variance():
    """Under track_variance each strip keeps a second-moment row a pixel
    of its own, whose path counts are its accumulation's.  (The JAX
    package's sharded state has these rows only under adaptive sampling,
    so its track_variance flush there folds into one row a shard.)"""
    cfg = small_config(width=16, height=16, num_rays=1 << 9,
                       track_variance="on")
    r = sharded.ShardedRenderer(Scene.load(None), cfg, devices=["cpu"] * 4)
    r.step(_cam(), 3)
    for st in r.states:
        assert st.moment2.shape == (16 * 4, 4)
        assert torch.equal(st.moment2[:, 3], st.accum[:, 3])
        assert (st.moment2[:, :3] > 0).any()


def test_crop_refused_on_strips():
    cfg = small_config(width=16, height=16, num_rays=256, crop=(0, 0, 8, 8))
    s = sharded.ShardedRenderer(Scene.load(None), cfg, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="row-strip"):
        s.step(_cam(), 1)
    # the whole frame through the same function still takes its crop
    st = tr.init_state(cfg, "cpu")
    sd = Scene.load(None).to_device("cpu")
    tr.render_step(st, sd, _cam().to_device(cfg, "cpu"),
                   tsky.sun_direction_from_position(SUN, "cpu"), cfg=cfg,
                   tables=tr.PacketTables(sd.bvh))


def test_height_must_divide():
    with pytest.raises(ValueError, match="divide"):
        sharded.ShardedRenderer(Scene.load(None),
                                small_config(width=8, height=12,
                                             num_rays=256),
                                devices=["cpu"] * 8)


# --------------------------------------------------------------------------
# test_sharded.py and the sharded cases of the feature tests, on the port
# --------------------------------------------------------------------------

def test_sharded_step_runs_and_is_finite():
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = sharded.ShardedRenderer(Scene.load(None), cfg, devices=["cpu"] * 8)
    r.step(_cam(), 3)
    acc = torch.cat([st.accum for st in r.states]).numpy()
    assert acc.shape == (16 * 16, 4)
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()
    assert r.image().shape == (16, 16, 3)


def test_sharded_strips_cover_whole_image():
    cfg = small_config(width=8, height=32, num_rays=1 << 9)
    r = sharded.ShardedRenderer(Scene.load(None), cfg, devices=["cpu"] * 8)
    r.step(_cam(), 4)
    acc = torch.cat([st.accum for st in r.states]).numpy().reshape(32, 8, 4)
    assert (acc[:, :, 3] > 0).all()
    means = acc[:, :, :3].reshape(8, 4, 8, 3).mean((1, 2, 3))
    assert np.unique(np.round(means, 6)).size > 1


def test_sharded_matches_single_device_statistically():
    cfg = small_config(width=16, height=16, num_rays=1 << 11)
    scene = Scene.load(None)
    rs = sharded.ShardedRenderer(scene, cfg, devices=["cpu"] * 8)
    rs.step(_cam(), 40)
    r1 = tr.Renderer(scene, cfg, device="cpu")
    r1.step(_cam(), 40)
    diff = (rs.image() - r1.image()).abs().numpy()
    assert diff.mean() < 0.04, diff.mean()


def test_sharded_blend_metal_flags_flow():
    v0 = np.array([[-20, -20, 0], [-20, -20, 0]], np.float32)
    v1 = np.array([[20, -20, 0], [20, 20, 0]], np.float32)
    v2 = np.array([[20, 20, 0], [-20, 20, 0]], np.float32)
    uv = np.tile(np.array([[[0, 0], [1, 0], [0, 1]]], np.float32), (2, 1, 1))
    alpha_tex = np.ones((1, 1, 4), np.float32)
    alpha_tex[..., 3] = 0.5
    mr_tex = np.zeros((1, 1, 3), np.float32)
    mr_tex[..., :] = [0.3, 0.7, 0.3]
    scene = Scene.from_triangles(
        v0, v1, v2, builder="numpy", tri_uv=uv,
        tri_tex=np.array([0, -1], np.int32),
        tri_rtex=np.array([-1, 1], np.int32),
        textures=[alpha_tex, mr_tex],
        tri_refl=np.array([0, GGX], np.int32),
        tri_blend=np.array([True, False]),
        tri_metal=np.array([False, True]),
        tri_ior=np.array([1.2, 1.2], np.float32))
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = sharded.ShardedRenderer(scene, cfg, devices=["cpu"] * 8)
    sd = r.replicas[torch.device("cpu")].scene
    assert sd.has_blend and sd.has_metal_maps
    r.step(_cam(), 2)
    acc = torch.cat([st.accum for st in r.states]).numpy()
    assert np.isfinite(acc).all()
    assert (acc[:, 3] > 0).all()


@pytest.mark.parametrize("kw,steps", [
    (dict(mis="on"), 1),
    (dict(fog="on", fog_sigma_s=0.01, fog_z_max=80.0), 1),
    (dict(sampler="sobol"), 2)])
def test_feature_sharded_step_runs(kw, steps):
    """test_mis_sharded_step_runs, test_fog_sharded_step_runs and
    test_sobol_sharded_step_runs: the step function over 8 strips."""
    cfg = small_config(width=16, height=16, num_rays=1 << 9, **kw)
    mesh = sharded.make_mesh(["cpu"] * 8)
    states = sharded.init_sharded_state(cfg, mesh)
    if cfg.mis == "on":
        assert states[0].bsdf_pdf.shape == (cfg.num_rays,)
    if cfg.sampler == "sobol":
        assert states[0].sample_idx.shape == (cfg.num_rays,)
    step = sharded.make_sharded_step(cfg, mesh)
    sd = Scene.load(None).to_device("cpu")
    dev = torch.device("cpu")
    reps = {dev: sharded.Replica(sd, tr.PacketTables(sd.bvh),
                                 tsky.sun_direction_from_position(SUN, dev))}
    cams = {dev: _cam().to_device(cfg, dev)}
    for _ in range(steps):
        states = step(states, reps, cams)
    acc = torch.cat([st.accum for st in states]).numpy()
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0


def test_sharded_adaptive_runs():
    """Adaptive sampling over 8 strips: each strip's own moments and
    visit order, in local pixel ids."""
    from .test_torch_adaptive import _camera, _plane
    cfg = small_config(width=32, height=64, num_rays=1 << 10,
                       adaptive_sampling="on", adaptive_interval=2)
    r = sharded.ShardedRenderer(_plane(), cfg, devices=["cpu"] * 8)
    for _ in range(3):
        r.step(_camera(), 2)
    assert r._sched.rebuilds >= 2
    acc = torch.cat([st.accum for st in r.states]).numpy()
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0
    for st in r.states:
        perm = st.pixel_perm.numpy()
        assert perm.shape == (32 * 8,)
        assert ((perm >= 0) & (perm < 32 * 8)).all()


def test_eight_cpu_devices_in_the_reference_mesh():
    assert len(jax.devices()) == 8
