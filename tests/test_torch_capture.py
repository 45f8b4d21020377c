"""The fused step (``fuse_step_chains``) on the CPU, where the port never
captures a CUDA graph: the selector is read, every value runs the eager
loop, six steps equal the JAX Renderer's fused six steps, and the
constants hoisted out of the step (so that a CUDA graph can hold it)
leave the step's arithmetic bit for bit as it was.  The captured graphs
themselves are checked on the card (tests/test_torch_gpu.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as j_small_config
from tyrant_tpu.ops import rng as jrng
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import PI, RenderConfig, SkyConfig, small_config
from tyrant_tpu_torch.ops import rng, sampling
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene.scene import Scene

CFG = small_config(width=16, height=16, num_rays=1 << 10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The renders here run for seconds on the CPU; beside the other test
    workers, PyTorch's default of a thread a core oversubscribes the
    machine, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam(cls):
    cam = cls()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


# the JAX package's TPU kernel selectors, each at a value off CFG's
TPU_SELECTORS = {"use_packet_kernel": "off", "use_accum_kernel": "off",
                 "adaptive_connect": "auto", "adaptive_connect_frac": 0.2}


def test_selectors_are_ported_fields():
    """The port reads its own selectors (test_cpu_runs_eager_under_every_value
    and the kernel-normals tests) and accepts the JAX package's four TPU
    selectors without effect: two CPU steps under each of those, set off
    its default, leave the default config's state bit for bit."""
    scene = Scene.load(None)

    def state(cfg):
        r = tr.Renderer(scene, cfg, device="cpu")
        r.step(_cam(Camera), 2)
        return r.state
    want = state(CFG)
    assert float(want.accum[:, 3].sum()) > 0
    for name, value in TPU_SELECTORS.items():
        assert getattr(CFG, name) != value, name
        got = state(dataclasses.replace(CFG, **{name: value}))
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name),
                               getattr(want, f.name)), (name, f.name)


@pytest.mark.parametrize("fuse", ["auto", "on", "off"])
def test_cpu_runs_eager_under_every_value(fuse):
    cfg = dataclasses.replace(CFG, fuse_step_chains=fuse)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    assert not r.captured
    first = r.step(_cam(Camera), 1)
    second = r.step(_cam(Camera), 1)
    # the eager loop: a new state a step, no graph, no replay
    assert first.origin is not second.origin
    assert not r._graphs and r.replayed_steps == 0
    assert not r.replayed_launches
    img = r.image(uint8=True)
    assert img.dtype == torch.uint8 and img.shape == (16, 16, 3)


def test_six_steps_match_jax_fused_chain():
    """tests/test_render_state.py::test_fused_chain_matches_loop's run
    through the port (fuse_step_chains="on", eager on the CPU) against
    the JAX Renderer's fused chain: n_carried and frame exact, the
    accumulation within tests/test_torch_render.py's Renderer tolerance
    (path counts within 0.5%, resolved images within 0.03 mean)."""
    jcfg = dataclasses.replace(j_small_config(width=16, height=16,
                                              num_rays=1 << 10),
                               fuse_step_chains="on")
    tcfg = dataclasses.replace(CFG, fuse_step_chains="on")
    jren = jr.Renderer(JScene.load(None), jcfg, donate=False)
    assert jren._fuse
    tren = tr.Renderer(Scene.load(None), tcfg, device="cpu")
    jren.step(_cam(JCamera), 6)
    tren.step(_cam(Camera), 6)
    assert int(tren.state.n_carried) == int(jren.state.n_carried)
    assert int(tren.state.frame) == int(jren.state.frame) == 7
    assert int(tren.state.start_position) == int(jren.state.start_position)
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert abs(ta[:, 3].sum() - ja[:, 3].sum()) <= 0.005 * ja[:, 3].sum()
    diff = np.abs(resolve(tren.state.accum, 16, 16).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), 16, 16)))
    assert diff.mean() < 0.03, diff.mean()


def _seed_with_host_constants(*parts):
    """rng.seed_from as it was before the hoisting: every Python int made a
    0-d tensor on the parts' device first."""
    like = next(p for p in parts if isinstance(p, torch.Tensor))

    def u32(p):
        if isinstance(p, torch.Tensor):
            return p.to(torch.int64) & 0xFFFFFFFF
        return torch.tensor(int(p) & 0xFFFFFFFF, dtype=torch.int64,
                            device=like.device)
    h = u32(0x9E3779B9)
    for p in parts:
        p = u32(p)
        h = h ^ ((p + 0x9E3779B9 + ((h << 6) & 0xFFFFFFFF) + (h >> 2))
                 & 0xFFFFFFFF)
        h = (h ^ 61) ^ (h >> 16)
        h = (h * 9) & 0xFFFFFFFF
        h = h ^ (h >> 4)
        h = (h * 0x27D4EB2D) & 0xFFFFFFFF
        h = h ^ (h >> 15)
    return torch.where(h == 0, torch.full_like(h, 0x1337C0DE), h)


@pytest.mark.parametrize("salt", [0x5EED, 0x5ADE, 0xC0F1, 0xD15B, 0x66C5,
                                  0x4F61])
def test_hoisted_rng_constants_are_bit_equal(salt):
    """Every seed the step draws, with its Python-int parts kept on the
    host, equals the old tensor-made seeds and the JAX package's seeds
    bit for bit."""
    r = np.random.default_rng(salt)
    pix = r.integers(0, 1 << 21, 4096).astype(np.int32)
    slot = np.arange(4096, dtype=np.int64)
    for frame in (1, 7, 0xFFFFFFFF):
        f = torch.tensor(frame, dtype=torch.int64)
        got = rng.seed_from(f, torch.from_numpy(pix), torch.from_numpy(slot),
                            0, salt)
        old = _seed_with_host_constants(f, torch.from_numpy(pix),
                                        torch.from_numpy(slot), 0, salt)
        want = jrng.seed_from(jnp.uint32(frame), jnp.asarray(pix),
                              jnp.asarray(slot.astype(np.int32)), 0, salt)
        assert torch.equal(got, old)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want))
    # a seed from Python ints alone is still a tensor
    assert int(rng.seed_from(3, 4)) == int(_seed_with_host_constants(
        torch.tensor(3), 4))


def test_hoisted_sky_and_basis_constants_are_bit_equal():
    """The sky's Mie coefficients, computed once per device, and the
    cached basis axes give the values the step computed each time
    before."""
    params = tsky.SkyParams(SkyConfig())
    cfg = params.cfg
    c = (0.2 * cfg.turbidity) * 10e-18
    wl = torch.tensor(cfg.primary_wavelengths, dtype=torch.float32)
    k = torch.tensor(tsky.K, dtype=torch.float32)
    old = 0.434 * c * PI * torch.pow((2.0 * PI) / wl, cfg.v - 2.0) * k \
        * cfg.mie_coefficient
    assert torch.equal(params.total_mie("cpu"), old)
    assert params.total_mie("cpu") is params.total_mie(torch.device("cpu"))
    w = sampling.normalize(torch.from_numpy(
        np.random.default_rng(1).normal(size=(512, 3)).astype(np.float32)))
    u, v = sampling.orthonormal_basis(w)
    pick_y = torch.abs(w[..., 0]) > 0.9
    a = torch.where(pick_y[..., None], torch.tensor([0.0, 1.0, 0.0]),
                    torch.tensor([1.0, 0.0, 0.0])).expand_as(w)
    u_old = sampling.normalize(sampling.cross(a, w))
    assert torch.equal(u, u_old) and torch.equal(v, sampling.cross(w, u_old))


def test_step_after_hoisting_matches_jax_step():
    """One eager step on the CPU from init against the JAX step: the
    counters exact, the path counts equal, the accumulation within the
    Renderer tolerance of tests/test_torch_render.py."""
    tren = tr.Renderer(Scene.load(None), CFG, device="cpu")
    jren = jr.Renderer(JScene.load(None), j_small_config(
        width=16, height=16, num_rays=1 << 10), donate=False)
    tren.step(_cam(Camera), 2)
    jren.step(_cam(JCamera), 2)
    for k in ("frame", "start_position", "n_carried", "shadow_rays"):
        assert int(getattr(tren.state, k)) == int(getattr(jren.state, k)), k
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    np.testing.assert_array_equal(ta[:, 3], ja[:, 3])
    diff = np.abs(resolve(tren.state.accum, 16, 16).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), 16, 16)))
    assert diff.mean() < 0.03, diff.mean()


def test_renderer_default_config_is_ported():
    assert RenderConfig().fuse_step_chains == "auto"
