"""Checkpoints (``tyrant_tpu_torch/checkpoint.py``) on the CPU, against the
JAX package's ``.npz`` format.

- test_checkpoint on the port: a saved and loaded state resumes bit for
  bit, the metadata round-trips.
- A Renderer stepped 8 times, saved, loaded into a fresh Renderer and
  stepped 4 more equals 12 uninterrupted steps bit for bit, under the
  default config, Sobol with ``track_variance``, adaptive sampling (its
  rebuild count, which is not state, carried in the metadata) and MIS.
- A file the JAX package writes loads in the port, and one the port
  writes loads in the JAX package, field for field, with the JAX
  package's names and dtypes; a file without the later fields loads with
  their defaults.
- test_sobol's, test_adaptive's and test_mis's round trips."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import checkpoint as jck
from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import checkpoint as tck
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.scene.scene import Scene

SUN = (0.05, 0.3)
FIELDS = [f.name for f in dataclasses.fields(tr.RenderState)]
JAX_DTYPES = dict(accum="float32", origin="float32", direction="float32",
                  direct="float32", pending="float32", pixel="int32",
                  bounces="int32", last_specular="bool", n_carried="int32",
                  start_position="int32", frame="uint32",
                  shadow_rays="uint32", moment2="float32",
                  pixel_perm="int32", bsdf_pdf="float32",
                  sample_base="uint32", sample_idx="uint32")


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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_states_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(_bits(x), _bits(y)), f


def test_checkpoint_resume_bitwise(tmp_path):
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    st = r.step(_cam(), 3)
    p = str(tmp_path / "ckpt.npz")
    tck.save_state(p, st, metadata={"sun": [0.05, 0.3], "frame_note": "t"})
    loaded, meta = tck.load_state(p, "cpu")
    assert meta == {"sun": [0.05, 0.3], "frame_note": "t"}
    assert_states_equal(loaded, st)
    camd = _cam().to_device(cfg, "cpu")

    def step(s):
        return tr.render_step(s, r.scene, camd, r.sun_dir, cfg=cfg,
                              tables=r.tables)
    a = step(dataclasses.replace(st, accum=st.accum.clone()))
    b = step(loaded)
    assert_states_equal(a, b)


RESUME_CASES = {
    "default": {},
    "sobol_variance": dict(sampler="sobol", seed=9, track_variance="on"),
    "adaptive": dict(adaptive_sampling="on", adaptive_interval=4),
    "mis": dict(mis="on"),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_equals_uninterrupted(case, tmp_path):
    cfg = small_config(width=24, height=16, num_rays=1 << 10,
                       **RESUME_CASES[case])

    def renderer():
        return tr.Renderer(Scene.load(None), cfg, device="cpu",
                           sun_position=SUN)
    # steps of 4: the adaptive rebuilds follow the calls (each call ticks
    # the scheduler once, as in the JAX package)
    whole = renderer()
    for _ in range(3):
        whole.step(_cam(), 4)
    first = renderer()
    for _ in range(2):
        first.step(_cam(), 4)
    p = str(tmp_path / "st.npz")
    # the adaptive rebuild count (the next phase) is host bookkeeping
    # outside RenderState, as in the JAX package: it rides the metadata
    sched = first._sched
    tck.save_state(p, first.state, {
        "steps": 8, "rebuilds": sched.rebuilds if sched else None})
    resumed = renderer()
    resumed.state, meta = tck.load_state(p, "cpu")
    assert meta["steps"] == 8
    if resumed._sched is not None:
        resumed._sched.rebuilds = meta["rebuilds"]
    resumed.step(_cam(), 4)
    assert_states_equal(resumed.state, whole.state)
    if case == "adaptive":
        assert not torch.equal(whole.state.pixel_perm,
                               torch.arange(cfg.num_pixels,
                                            dtype=torch.int32))


def _jax_state(cfg, steps=3):
    jr_ = jr.Renderer(JScene.load(None), cfg, sun_position=SUN, donate=False)
    jr_.step(_cam(JCamera), steps)
    return jr_.state


JAX_CASES = {"sobol": dict(sampler="sobol", track_variance="on"),
             "adaptive_mis": dict(adaptive_sampling="on", mis="on")}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jax_file_loads_in_port(case, tmp_path):
    cfg = jsmall_config(width=16, height=16, num_rays=1 << 10,
                        **JAX_CASES[case])
    jst = _jax_state(cfg)
    p = str(tmp_path / "jax.npz")
    jck.save_state(p, jst, {"who": "jax"})
    st, meta = tck.load_state(p, "cpu")
    assert meta == {"who": "jax"}
    for f in FIELDS:
        want = np.asarray(getattr(jst, f))
        got = getattr(st, f)
        assert got.dtype == interop.STATE_DTYPES.get(f, torch.float32), f
        np.testing.assert_array_equal(got.numpy(), want.astype(
            got.numpy().dtype), err_msg=f)
    assert st.moment2.shape == (cfg.num_pixels, 4)
    # and the port steps on from it
    r = tr.Renderer(Scene.load(None), small_config(
        width=16, height=16, num_rays=1 << 10, **JAX_CASES[case]),
        device="cpu", sun_position=SUN)
    r.state = st
    paths = float(st.accum[:, 3].sum())  # the step adds in place
    r.step(_cam(), 1)
    assert float(r.state.accum[:, 3].sum()) > paths


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_port_file_loads_in_jax(case, tmp_path):
    cfg = small_config(width=16, height=16, num_rays=1 << 10,
                       **JAX_CASES[case])
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    r.step(_cam(), 3)
    p = str(tmp_path / "port.npz")
    tck.save_state(p, r.state, {"who": "port"})
    with np.load(p) as z:
        assert sorted(k for k in z.files if k != "__metadata__") \
            == sorted(JAX_DTYPES)
        for f, dt in JAX_DTYPES.items():
            assert z[f].dtype == np.dtype(dt), f
    jst, meta = jck.load_state(p)
    assert meta == {"who": "port"}
    for f in FIELDS:
        got = np.asarray(getattr(jst, f))
        want = getattr(r.state, f).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f)
    # and the JAX package steps on from it
    jcfg = jsmall_config(width=16, height=16, num_rays=1 << 10,
                         **JAX_CASES[case])
    nxt = jr.render_step(jst, JScene.load(None).to_device(),
                         _cam(JCamera).to_device(jcfg),
                         jsky.sun_direction_from_position(jnp.asarray(SUN)),
                         cfg=jcfg)
    assert float(np.asarray(nxt.accum)[:, 3].sum()) \
        > float(r.state.accum[:, 3].sum())


def test_old_file_takes_the_defaults(tmp_path):
    """A file from before the later fields (no shadow_rays, moment2,
    pixel_perm, bsdf_pdf, sample_base, sample_idx) loads with the JAX
    package's defaults."""
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    r.step(_cam(), 2)
    p = str(tmp_path / "new.npz")
    tck.save_state(p, r.state)
    old = str(tmp_path / "old.npz")
    with np.load(p) as z:
        np.savez(old, **{k: z[k] for k in z.files
                         if k not in tck._OPTIONAL})
    st, meta = tck.load_state(old, "cpu")
    assert meta == {}
    assert int(st.shadow_rays) == 0 and int(st.sample_base) == 0
    assert st.moment2.shape == (1, 4) and st.pixel_perm.shape == (1,)
    assert st.bsdf_pdf.shape == (1,) and float(st.bsdf_pdf[0]) == 1.0
    assert st.sample_idx.shape == (1,)
    assert torch.equal(st.accum, r.state.accum)


def test_counters_saved_as_uint32(tmp_path):
    """The port's int64 counters wrap to the JAX package's uint32 on
    save (shadow_rays grows without a mask in the port)."""
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    st = tr.init_state(cfg, "cpu")
    st = dataclasses.replace(st, shadow_rays=torch.tensor((1 << 32) + 5),
                             frame=torch.tensor(0xFFFFFFFF))
    p = str(tmp_path / "wrap.npz")
    tck.save_state(p, st)
    with np.load(p) as z:
        assert int(z["shadow_rays"]) == 5 and z["shadow_rays"].dtype \
            == np.uint32
        assert int(z["frame"]) == 0xFFFFFFFF
    assert int(tck.load_state(p, "cpu")[0].frame) == 0xFFFFFFFF
