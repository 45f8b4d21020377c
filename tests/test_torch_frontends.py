"""The port's front-end modules on the CPU against the JAX package's: the
viewer's PNG encoder and ANSI preview, the HTTP viewer on a free
127.0.0.1 port, ``utils.metrics``, ``utils.profiling``, the public sky
functions, ``scene.bvh.validate_bvh``, ``ops.traverse.traversal_depth_map``
and the ported round trips of test_exr.py and test_pfm.py."""

import io
import json
import struct
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tyrant_tpu import sky as jsky
from tyrant_tpu import viewer as jviewer
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops import traverse as jtraverse
from tyrant_tpu.render import Renderer as JRenderer
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.utils import metrics as jmetrics
from tyrant_tpu_torch import interop, sky, viewer
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.native import bvh_native
from tyrant_tpu_torch.ops import traverse
from tyrant_tpu_torch.render import Renderer
from tyrant_tpu_torch.scene import bvh as tbvh
from tyrant_tpu_torch.scene.scene import Scene
from tyrant_tpu_torch.utils import metrics, profiling
from tyrant_tpu_torch.utils.exr import read_exr, write_exr
from tyrant_tpu_torch.utils.pfm import read_pfm, write_pfm


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


# --------------------------------------------------------------------------
# viewer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 3), (37, 21, 3), (1, 300, 3)])
def test_png_bytes_decode_to_the_jax_pixels(shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    png = viewer._to_png_bytes(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    got = np.asarray(Image.open(io.BytesIO(png)))
    want = np.asarray(Image.open(io.BytesIO(jviewer._to_png_bytes(img))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    # chip_smoke's zlib decoder, for these files, at either level
    np.testing.assert_array_equal(chip_smoke.png_pixels(png), img)
    np.testing.assert_array_equal(
        chip_smoke.png_pixels(viewer._to_png_bytes(img, 1)), img)


def test_png_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match="RGB"):
        viewer._to_png_bytes(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        chip_smoke.png_pixels(b"GIF89a" + b"\0" * 32)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="unsupported"):
        chip_smoke.png_pixels(buf.getvalue())


def test_terminal_viewer_ansi_equals_jax():
    img = np.random.default_rng(1).integers(0, 256, (32, 64, 3)).astype(
        np.uint8)
    img[:4] = [255, 0, 0]
    for cols in (32, 100):
        want = jviewer.TerminalViewer(None, None, cols=cols)._ansi(img)
        got = viewer.TerminalViewer(None, None, cols=cols)._ansi(img)
        assert got == want
    assert "\x1b[38;2;255;0;0m" in got


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_http_viewer_serves_frames_stats_and_input():
    """An HttpViewer on a free 127.0.0.1 port: frames that advance, the
    stats JSON, and /input moving the camera and the sun."""
    cfg = small_config(width=32, height=24, num_rays=1024)
    r = Renderer(Scene.load(None), cfg, device="cpu")
    cam = _cam()
    v = viewer.HttpViewer(r, cam, port=0, preview_scale=2)
    url = v.start()
    try:
        assert v.port > 0 and url == f"http://127.0.0.1:{v.port}/"
        assert b"<canvas" in _get(url)
        deadline = time.time() + 30
        while v.frames < 3 and time.time() < deadline:
            time.sleep(0.05)
        stats = json.loads(_get(url + "stats"))
        assert stats["frames"] >= 3 and "ms/frame" in stats["text"]
        assert len(stats["times"]) >= 3
        png = _get(url + "frame.png")
        assert np.asarray(Image.open(io.BytesIO(png))).shape == (12, 16, 3)
        pos0 = cam.position.copy()
        req = urllib.request.Request(
            url + "input", data=json.dumps(
                {"move": [1, 0, 0], "sx": 0.2, "lr": 0.5}).encode(),
            method="POST")
        assert _get(req) == b"ok"
        deadline = time.time() + 30
        while r.sun_position[0] != 0.2 and time.time() < deadline:
            time.sleep(0.05)
        assert r.sun_position == (0.2, 0.3)
        assert not np.array_equal(cam.position, pos0)
        assert cam.lens_radius == 0.5
    finally:
        v.stop()
    assert not v._threads


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------

def test_metrics_equal_jax():
    out = []
    for mod in (jmetrics, metrics):
        sink = io.StringIO()
        m = mod.Metrics(sink=sink)
        m.count("frames")
        m.count("frames", 2.5)
        m.observe("step", 0.002)
        m.observe("step", 0.004)
        with m.time("fetch"):
            pass
        rec = m.emit(tag="x")
        parsed = json.loads(sink.getvalue())
        assert parsed["tag"] == "x" and parsed["frames"] == 3.5
        rec.pop("ts")
        rec.pop("fetch_ms_avg"), rec.pop("fetch_ms_min"), rec.pop(
            "fetch_ms_max")
        out.append(rec)
    assert out[1] == out[0]


def test_render_stats_equal_jax():
    """render_stats of the same state (a JAX state after 3 steps, carried
    over through interop) equals the JAX one."""
    cfg = jsmall_config(width=16, height=16, num_rays=1 << 9)
    jr = JRenderer(JScene.load(None), cfg, donate=False)
    jr.step(_cam(JCamera), 3)
    fields = {k: np.array(getattr(jr.state, k))
              for k in interop.STATE_FIELDS}
    st = interop.state_from_numpy(fields, "cpu")
    tcfg = small_config(width=16, height=16, num_rays=1 << 9)
    want = jmetrics.render_stats(jr.state, cfg)
    got = metrics.render_stats(st, tcfg)
    assert got == want and got["frame"] == 4


def test_time_blocked_on_the_cpu():
    calls = []

    def fn(x, k=1):
        calls.append(x)
        return torch.full((3,), float(x * k))

    t, out = profiling.time_blocked(fn, 2, reps=5, warmup=2, k=3)
    assert len(calls) == 7 and t >= 0.0
    assert torch.equal(out, torch.full((3,), 6.0))


def test_stage_profile_keys_and_state_untouched():
    cfg = small_config(width=16, height=16, num_rays=1 << 9)
    r = Renderer(Scene.from_triangles(*terrain(n_quads=8, towers=1),
                                      builder="numpy"), cfg, device="cpu")
    r.step(_cam(), 2)
    before = {k: getattr(r.state, k).clone() for k in interop.STATE_FIELDS}
    prof = profiling.stage_profile(r, _cam(), n_steps=2)
    # the JAX stage_profile's keys (tyrant_tpu/utils/profiling.py)
    assert set(prof) == {"raygen_ms", "extend_ms", "shade_ms", "connect_ms",
                         "stage_sum_ms", "full_step_ms",
                         "mrays_per_s_segments"}
    assert all(np.isfinite(v) and v > 0 for v in prof.values())
    np.testing.assert_allclose(prof["stage_sum_ms"], sum(
        prof[k] for k in ("raygen_ms", "extend_ms", "shade_ms",
                          "connect_ms")), rtol=1e-9)
    for k, v in before.items():
        assert torch.equal(getattr(r.state, k), v), k


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(4).add_(1)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr") and "traceEvents" in data


# --------------------------------------------------------------------------
# sky, BVH validation, the traversal heatmap
# --------------------------------------------------------------------------

def test_sky_functions_match_jax():
    r = np.random.default_rng(3)
    d = r.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])  # the sky is evaluated above the horizon
    sph = r.uniform(-3, 3, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sky.from_spherical(torch.from_numpy(sph)).numpy(),
        np.asarray(jsky.from_spherical(jnp.asarray(sph))), rtol=1e-5,
        atol=1e-6)
    jp, tp = jsky.SkyParams(), sky.SkyParams()
    for pos in ((0.05, 0.3), (0.4, 0.1), (0.9, 0.45)):
        jsun = jsky.sun_direction_from_position(jnp.asarray(pos))
        tsun = sky.sun_direction_from_position(pos, "cpu")
        for jf, tf in ((jsky.sky, sky.sky), (jsky.sunsky, sky.sunsky),
                       (jsky.sun, sky.sun)):
            want = np.asarray(jf(jnp.asarray(d), jsun, jp))
            got = tf(torch.from_numpy(d), tsun, tp).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        # the step's fused pair is the two functions, bit for bit
        sv, ssv = sky.sky_and_sunsky(torch.from_numpy(d), tsun, tp)
        assert torch.equal(sv, sky.sky(torch.from_numpy(d), tsun, tp))
        assert torch.equal(ssv, sky.sunsky(torch.from_numpy(d), tsun, tp))


def _bounds(v0, v1, v2):
    return (np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2))


@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_validate_bvh(builder):
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    lo, hi = _bounds(v0, v1, v2)
    b = tbvh.build_bvh(lo, hi) if builder == "numpy" \
        else bvh_native.build_bvh(lo, hi)
    tbvh.validate_bvh(b, lo, hi, v0.shape[0])
    # a leaf box shrunk off its triangles
    leaf = int(np.nonzero(b.prim_count > 0)[0][0])
    b.hi[leaf] = b.lo[leaf]
    with pytest.raises(AssertionError):
        tbvh.validate_bvh(b, lo, hi, v0.shape[0])


def test_validate_bvh_catches_a_broken_permutation():
    v0, v1, v2 = terrain(n_quads=8, towers=1)
    lo, hi = _bounds(v0, v1, v2)
    b = tbvh.build_bvh(lo, hi)
    b.perm[1] = b.perm[0]
    with pytest.raises(AssertionError):
        tbvh.validate_bvh(b, lo, hi, v0.shape[0])


def test_traversal_depth_map_matches_jax():
    """On the same BVH (the numpy builders agree bit for bit): ids and
    visits exact, t within 1e-5 relative."""
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    jd = JScene.from_triangles(v0, v1, v2, builder="numpy").to_device()
    td = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device("cpu")
    r = np.random.default_rng(7)
    o = (r.uniform(-60, 60, (2048, 3)) + [0, 0, 80]).astype(np.float32)
    d = r.normal(size=(2048, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jt, jid, jv = jtraverse.traversal_depth_map(jnp.asarray(o), jnp.asarray(d),
                                                jd.bvh)
    tt, tid, tv = traverse.traversal_depth_map(torch.from_numpy(o),
                                               torch.from_numpy(d), td.bvh)
    assert tv.dtype == torch.int32 and tid.dtype == torch.int32
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    assert (np.asarray(jid) >= 0).mean() > 0.5 and tv.min() >= 1


# --------------------------------------------------------------------------
# test_exr.py and test_pfm.py on the port's copies
# --------------------------------------------------------------------------

def test_exr_roundtrip_float32(tmp_path):
    img = (np.random.default_rng(0).random((7, 5, 3)) * 1e4).astype(
        np.float32)
    p = str(tmp_path / "x.exr")
    write_exr(p, img, half=False)
    np.testing.assert_array_equal(read_exr(p), img)


def test_exr_roundtrip_half(tmp_path):
    img = (np.random.default_rng(1).random((4, 6, 3)) * 100).astype(
        np.float32)
    p = str(tmp_path / "h.exr")
    write_exr(p, img)
    np.testing.assert_array_equal(read_exr(p),
                                  img.astype(np.float16).astype(np.float32))


def test_exr_rgba_alpha(tmp_path):
    img = np.zeros((3, 2, 4), np.float32)
    img[..., :3] = 0.25
    img[..., 3] = np.linspace(0, 1, 6).reshape(3, 2)
    p = str(tmp_path / "a.exr")
    write_exr(p, img, half=False)
    out = read_exr(p)
    assert out.shape == (3, 2, 4)
    np.testing.assert_array_equal(out, img)


def test_exr_header_fields(tmp_path):
    p = str(tmp_path / "hdr.exr")
    write_exr(p, np.ones((2, 3, 3), np.float32))
    raw = open(p, "rb").read()
    magic, version = struct.unpack_from("<ii", raw, 0)
    assert magic == 20000630 and version == 2
    assert raw.index(b"B\0") < raw.index(b"G\0") < raw.index(b"R\0")
    assert b"compression\0compression\0" in raw


def test_exr_rejects_bad_input(tmp_path):
    p = tmp_path / "bad.exr"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="not an EXR"):
        read_exr(str(p))
    with pytest.raises(ValueError, match="EXR wants"):
        write_exr(str(tmp_path / "x.exr"), np.ones((4, 4), np.float32))


@pytest.mark.parametrize("ext", ["exr", "pfm"])
def test_envmap_loader_accepts_hdr(tmp_path, ext):
    from tyrant_tpu_torch.scene.texture import load_texture
    em = np.full((4, 8, 3), 2.5, np.float32)
    p = str(tmp_path / f"env.{ext}")
    if ext == "exr":
        write_exr(p, em, half=False)
    else:
        write_pfm(p, em)
    np.testing.assert_array_equal(load_texture(p), em)


def test_pfm_roundtrips(tmp_path):
    img = (np.random.default_rng(0).random((7, 5, 3)) * 1e4).astype(
        np.float32)
    p = str(tmp_path / "x.pfm")
    write_pfm(p, img)
    np.testing.assert_array_equal(read_pfm(p), img)
    g = np.arange(12, dtype=np.float32).reshape(4, 3)
    write_pfm(p, g)
    out = read_pfm(p)
    assert out.shape == (4, 3, 3)
    np.testing.assert_array_equal(out[:, :, 0], g)
    be = np.float32([[[1, 2, 3], [4, 5, 6]]])
    with open(p, "wb") as f:
        f.write(b"PF\n2 1\n2.0\n")
        f.write(np.flipud(be).astype(">f4").tobytes())
    np.testing.assert_allclose(read_pfm(p), be * 2.0)


def test_radiance_is_accum_mean():
    cfg = small_config(width=16, height=12, num_rays=1 << 10)
    r = Renderer(Scene.load(None), cfg, device="cpu")
    r.step(Camera(), 2)
    rad = r.radiance().numpy()
    accum = r.state.accum.numpy()
    expect = (accum[:, :3] / np.maximum(accum[:, 3:4], 1e-8)).reshape(
        12, 16, 3)
    np.testing.assert_array_equal(rad, expect)
    assert np.isfinite(rad).all()
