"""The port's display path against the JAX package's on the CPU, on the
same numpy inputs made from a seed: the à-trous denoiser, bloom,
auto-exposure and ``Renderer.image(denoise=True)`` with bloom.

Tolerances: denoiser and bloom rtol 1e-4 / atol 1e-5 (the same float32
arithmetic, summed in the same order; exp and pow may round differently
by an ulp); auto-exposure rtol 1e-5; the whole display image atol 2e-3
with a mean difference under 1e-4 (on top of the filters, the two AOV
passes may differ on epsilon ties and on ground-sphere depth, ROADMAP
Queue 3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import denoise as jdn
from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops import tonemap as jtone
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import denoise as tdn
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops import tonemap as ttone
from tyrant_tpu_torch.scene.scene import Scene


def _guides(h, w, seed):
    """Radiance with fireflies, albedo, mostly-flat normals with creases
    and sky pixels, depth with far misses."""
    r = np.random.default_rng(seed)
    radiance = r.gamma(0.6, 0.8, (h, w, 3)).astype(np.float32)
    radiance[r.random((h, w)) < 0.02] *= 40.0
    albedo = r.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    crease = r.random((h, w)) < 0.2
    n = r.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal[crease] = n[crease]
    depth = r.uniform(40.0, 160.0, (h, w)).astype(np.float32)
    sky = np.zeros((h, w), bool)
    sky[: h // 4] = True
    normal[sky] = 0.0
    albedo[sky] = 1.0
    depth[sky] = 1e20
    return radiance, albedo, normal, depth


@pytest.mark.parametrize("iterations", [1, 4])
def test_atrous_matches_jax(iterations):
    args = _guides(24, 40, seed=iterations)
    want = np.asarray(jdn.atrous_denoise(*(jnp.asarray(a) for a in args),
                                         iterations=iterations))
    got = tdn.atrous_denoise(*(torch.from_numpy(a) for a in args),
                             iterations=iterations).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - args[0]).mean() > 0.01  # it does smooth
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,radius", [((20, 30), 12), ((7, 9), 12),
                                          ((16, 16), 3)])
def test_bloom_matches_jax(shape, radius):
    """Radius 12 on a 7x9 image: the clamp to the image applies."""
    cl = (np.random.default_rng(3).gamma(0.7, 1.0, shape + (3,)) * 1.5) \
        .astype(np.float32)
    want = np.asarray(jtone.bloom(jnp.asarray(cl), 0.1, 1.0, radius))
    got = ttone.bloom(torch.from_numpy(cl), 0.1, 1.0, radius).numpy()
    assert np.abs(got - cl).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_auto_exposure_matches_jax(scale):
    """scale 0: the black frame keeps gain 1."""
    rad = (np.random.default_rng(5).gamma(0.5, 1.0, (12, 10, 3)) * scale) \
        .astype(np.float32)
    want = jtone.auto_exposure(jnp.asarray(rad))
    got = ttone.auto_exposure(torch.from_numpy(rad))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-5)
    if scale == 0.0:
        assert got == 1.0


def test_to_uint8_matches_jax():
    img = np.random.default_rng(6).uniform(-0.1, 1.1, (8, 8, 3)) \
        .astype(np.float32)
    np.testing.assert_array_equal(ttone.to_uint8(torch.from_numpy(img))
                                  .numpy(),
                                  np.asarray(jtone.to_uint8(jnp.asarray(img))))


def test_renderer_image_matches_jax():
    """The same accumulation buffer and pose in both Renderers, then
    image(denoise=True) with bloom: the AOV pass, the denoiser, bloom and
    the tone map end to end."""
    w, h = 32, 24
    kw = dict(bloom_strength=0.1, bloom_threshold=0.8, bloom_radius=4,
              denoise_iterations=3)
    mesh = terrain(n_quads=16, towers=2)
    jren = jr.Renderer(JScene.from_triangles(*mesh, builder="numpy"),
                       jsmall_config(w, h, 1024, **kw), donate=False)
    tren = tr.Renderer(Scene.from_triangles(*mesh, builder="numpy"),
                       small_config(w, h, 1024, **kw), device="cpu")

    r = np.random.default_rng(8)
    counts = r.integers(1, 9, (w * h, 1)).astype(np.float32)
    accum = np.concatenate([r.gamma(0.6, 1.0, (w * h, 3)) * counts, counts],
                           axis=1).astype(np.float32)
    jren.state = dataclasses.replace(jren.state, accum=jnp.asarray(accum))
    tren.state.accum = torch.from_numpy(accum.copy())

    cam = JCamera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    camd = cam.to_device(jren.cfg)
    jren._last_cam, jren._last_pose = camd, cam.pose_key()
    tren._last_cam = interop.camera_from_numpy(
        *(np.asarray(x) for x in (camd.position, camd.direction, camd.right,
                                  camd.up, camd.focal_distance,
                                  camd.lens_radius)), "cpu")
    tren._last_pose = cam.pose_key()

    want = np.asarray(jren.image(denoise=True))
    got = tren.image(denoise=True).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    plain = tren.image(denoise=False).numpy()
    assert np.abs(got - plain).mean() > 1e-3  # the denoiser ran
    diff = np.abs(got - want)
    assert diff.mean() < 1e-4, diff.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
