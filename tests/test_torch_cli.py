"""The port's CLI (``tyrant_tpu_torch.cli``) on the CPU: the cases of
test_cli.py, with a cube PLY written into the test's folder, the ``--hdr``
cases of test_exr.py and test_pfm.py, and ``info`` and ``bvh-debug`` held
against the JAX CLI on the same argv (the same triangle, node, sphere and
light counts; the same node visits, ray for ray, and the same heatmap)."""

import argparse
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tyrant_tpu import cli as jcli
from tyrant_tpu_torch import cli
from tyrant_tpu_torch.utils.exr import read_exr
from tyrant_tpu_torch.utils.pfm import read_pfm

CPU = ["--device", "cpu"]
CAMERA = ["--camera", "0", "-170", "40", "0", "-0.10"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cube(tmp_path):
    """An ASCII PLY cube of side 2 about the origin (8 vertices, 12
    triangles), in place of the reference's Data/cube.ply."""
    v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    lines = ["ply", "format ascii 1.0", "comment a cube",
             f"element vertex {len(v)}", "property float x",
             "property float y", "property float z",
             f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(str(c) for c in p) for p in v]
    lines += ["3 " + " ".join(str(i) for i in f) for f in faces]
    p = tmp_path / "cube.ply"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _png_ok(path, size=None):
    assert os.path.exists(path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with Image.open(path) as im:
        im.load()
        if size is not None:
            assert im.size == size


def test_cli_render_spheres(tmp_path):
    out = tmp_path / "demo.png"
    cli.main(["render", "--width", "64", "--height", "48", "--rays", "2048",
              "--steps", "4", *CAMERA, "--aovs", str(tmp_path / "f"),
              "--out", str(out), *CPU])
    _png_ok(out, size=(64, 48))
    _png_ok(tmp_path / "f_albedo.png", size=(64, 48))
    _png_ok(tmp_path / "f_normal.png", size=(64, 48))
    depth = np.load(tmp_path / "f_depth.npy")
    assert depth.shape == (48, 64) and np.isfinite(depth).all()
    assert depth.min() > 0


def test_cli_render_auto_exposure(tmp_path):
    out = tmp_path / "auto.png"
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "3", "--exposure", "auto", "--tonemap", "aces",
              *CAMERA, "--out", str(out), *CPU])
    _png_ok(out, size=(32, 24))


def test_cli_render_aov_exr(tmp_path):
    out = tmp_path / "demo.png"
    cli.main(["render", "--width", "48", "--height", "32", "--rays", "1024",
              "--steps", "2", *CAMERA, "--aovs", str(tmp_path / "f"),
              "--aov-format", "exr", "--out", str(out), *CPU])
    alb = read_exr(str(tmp_path / "f_albedo.exr"))
    nrm = read_exr(str(tmp_path / "f_normal.exr"))
    dep = read_exr(str(tmp_path / "f_depth.exr"))
    assert alb.shape[:2] == (32, 48) and np.isfinite(alb).all()
    assert nrm.min() < -0.1
    assert np.array_equal(dep[:, :, 0], dep[:, :, 1])
    assert np.isfinite(dep).all() and dep.min() > 0


def test_cli_render_mesh(tmp_path, cube):
    out = tmp_path / "cube.png"
    cli.main(["render", "--scene", cube, "--width", "48", "--height", "32",
              "--rays", "1024", "--steps", "3", "--builder", "numpy",
              "--out", str(out), *CPU])
    _png_ok(out)


def test_cli_png_is_the_image(tmp_path):
    """The PNG holds ``Renderer.image(uint8=True)`` after the same steps,
    pixel for pixel (decoded by Pillow)."""
    from tyrant_tpu_torch.camera import Camera
    from tyrant_tpu_torch.config import small_config
    from tyrant_tpu_torch.render import Renderer
    from tyrant_tpu_torch.scene.scene import Scene
    out = tmp_path / "x.png"
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "3", *CAMERA, "--out", str(out), *CPU])
    r = Renderer(Scene.load(None), small_config(32, 24, 1024), device="cpu")
    cam = Camera()
    cam.position = np.array([0, -170, 40], np.float32)
    cam.vertical_angle = -0.10
    r.step(cam, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  r.image(uint8=True).numpy())


def test_cli_bench_json(tmp_path, capsys):
    txt = tmp_path / "Performance.txt"
    cli.main(["bench", "--width", "32", "--height", "24", "--rays", "1024",
              "--seconds", "0.05", "--json", "--txt", str(txt), *CPU])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)
    assert len(d["poses"]) == 3
    assert d["total_mrays_per_s"] > 0
    assert np.isfinite(d["avg_frame_ms"])
    body = txt.read_text()
    assert body.count("Average frame time") == 3
    assert "Min frame time" in body and "Max frame time" in body


def test_cli_bench_refuses_auto_exposure():
    with pytest.raises(SystemExit):
        cli.main(["bench", "--exposure", "auto", *CPU])


def test_cli_bvh_debug(tmp_path, cube):
    out = tmp_path / "heat.png"
    cli.main(["bvh-debug", "--scene", cube, "--width", "48", "--height",
              "32", "--rays", "1024", "--builder", "numpy",
              "--camera", "0", "-6", "2", "0", "-0.2", "--out", str(out),
              *CPU])
    _png_ok(out)


def test_cli_checkpoint_resume_exact(tmp_path):
    """render 3 + resume 3 == straight 6, bit for bit."""
    from tyrant_tpu_torch.checkpoint import load_state
    ck = str(tmp_path / "st.npz")
    common = ["render", "--width", "32", "--height", "24", "--rays", "1024",
              *CAMERA, *CPU]
    cli.main(common + ["--steps", "3", "--checkpoint", ck,
                       "--out", str(tmp_path / "a.png")])
    _, meta = load_state(ck, "cpu")
    assert meta["steps"] == 3 and meta["pose"][2] == 40.0
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "6", "--checkpoint", ck,
              "--out", str(tmp_path / "b.png"), *CPU])
    st6, meta6 = load_state(ck, "cpu")
    assert meta6["steps"] == 6
    ck2 = str(tmp_path / "st2.npz")
    cli.main(common + ["--steps", "6", "--checkpoint", ck2,
                       "--out", str(tmp_path / "c.png")])
    st6b, _ = load_state(ck2, "cpu")
    assert torch.equal(st6.accum, st6b.accum)
    assert int(st6.frame) == int(st6b.frame)


def test_cli_checkpoint_mismatch_fails(tmp_path):
    ck = str(tmp_path / "st.npz")
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "2", "--checkpoint", ck,
              "--out", str(tmp_path / "a.png"), *CPU])
    with pytest.raises(SystemExit, match="same --width"):
        cli.main(["render", "--width", "64", "--height", "24", "--rays",
                  "1024", "--steps", "2", "--checkpoint", ck,
                  "--out", str(tmp_path / "b.png"), *CPU])
    with pytest.raises(SystemExit, match="different --camera"):
        cli.main(["render", "--width", "32", "--height", "24", "--rays",
                  "1024", "--steps", "2", "--checkpoint", ck,
                  "--camera", "5", "5", "5", "0", "0",
                  "--out", str(tmp_path / "c.png"), *CPU])


def _info_counts(text: str) -> dict:
    """The counts ``info`` prints: every bvh.* line, spheres, lights."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(("bvh.", "spheres:", "lights:",
                            "tri materials:", "features:",
                            "render config:")):
            k, v = line.split(":", 1)
            out[k] = v.strip()
    return out


@pytest.mark.parametrize("scene", ["cube", None])
def test_cli_info_matches_jax(capsys, cube, scene):
    """``info`` prints the scene, lights and kernel tables without
    rendering; its counts are the JAX CLI's on the same argv."""
    argv = ["info", "--builder", "numpy"]
    if scene:
        argv += ["--scene", cube]
    jcli.main(argv)
    want = _info_counts(capsys.readouterr().out)
    cli.main(argv + CPU)
    text = capsys.readouterr().out
    got = _info_counts(text)
    assert got == want
    assert ("bvh.triangles" in got) == bool(scene)
    assert "spheres" in got and "lights" in got
    assert "kernel tables: node records [" in text
    assert "triangle records [" in text and ", 12]" in text
    assert "device memory (scene tables):" in text


def test_cli_bvh_debug_matches_jax(tmp_path, cube):
    """The node visits of every pixel's primary ray exactly the JAX
    CLI's, and the two heatmaps pixel for pixel."""
    from tyrant_tpu.ops.traverse import traversal_depth_map
    from tyrant_tpu.render import _raygen
    argv = ["bvh-debug", "--scene", cube, "--width", "48", "--height", "32",
            "--rays", "2048", "--builder", "numpy",
            "--camera", "0", "-6", "2", "0", "-0.2"]
    jcli.main(argv + ["--out", str(tmp_path / "j.png")])
    cli.main(argv + ["--out", str(tmp_path / "t.png"), *CPU])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))

    jargs = argparse.Namespace(
        scene=cube, width=48, height=32, rays=2048, bounces=5,
        no_spheres=False, sun=(0.05, 0.3), camera=[0, -6, 2, 0, -0.2],
        scale=1.0, builder="numpy")
    jcfg, jscene, jcam = jcli._build(jargs)
    gen = _raygen(jcfg, jcam.to_device(jcfg), jnp.asarray(0),
                  jnp.asarray(1, jnp.uint32), jcfg.height, 0)
    n_pix = 48 * 32
    _, _, visits = traversal_depth_map(gen["origin"][:n_pix],
                                       gen["direction"][:n_pix],
                                       jscene.to_device().bvh)
    want = np.zeros(n_pix, np.int32)
    want[np.asarray(gen["pixel"][:n_pix])] = np.asarray(visits)
    tcfg, tscene, tcam = cli._build(argparse.Namespace(**vars(jargs)))
    got = cli.bvh_debug_visits(tcfg, tscene, tcam, "cpu")
    np.testing.assert_array_equal(got, want)
    assert want.max() > 1


def test_cli_dof_autofocus(tmp_path, capsys):
    out = tmp_path / "dof.png"
    cli.main(["render", "--width", "48", "--height", "32", "--rays", "1024",
              "--steps", "2", *CAMERA, "--lens-radius", "2.0",
              "--focus-at", "0.5", "0.8", "--out", str(out), *CPU])
    _png_ok(out, size=(48, 32))
    assert "autofocus: depth" in capsys.readouterr().err
    ns = argparse.Namespace(
        scene=None, width=8, height=8, rays=64, bounces=2, no_spheres=False,
        sun=(0.05, 0.3), camera=None, scale=1.0, clamp=0.0, denoise=False,
        tonemap="reinhard", exposure=1.0, envmap=None, adaptive=False,
        mis=False, sampler="xorshift", seed=0, light_sampling="uniform",
        fog=False, projection="perspective", texture_filter="bilinear",
        builder="numpy", lens_radius=0.5, focal_distance=30.0)
    cfg, scene, cam = cli._build(ns)
    assert cam.lens_radius == 0.5
    np.testing.assert_allclose(
        cam.focal_distance * cfg.focal_distance_scale, 30.0)


def test_cli_autofocus_sky_warns(tmp_path, capsys):
    out = tmp_path / "sky.png"
    cli.main(["render", "--no-spheres", "--width", "32", "--height", "24",
              "--rays", "512", "--steps", "1", "--lens-radius", "1.0",
              "--focus-at", "0.5", "0.1", "--out", str(out), *CPU])
    _png_ok(out)
    assert "hits the sky" in capsys.readouterr().err


def test_cli_render_look_at(tmp_path):
    out = tmp_path / "look.png"
    cli.main(["render", "--width", "32", "--height", "24",
              "--rays", "4096", "--steps", "3",
              "--camera", "0", "-80", "60", "0", "0",
              "--look-at", "0", "-80", "120", "--out", str(out), *CPU])
    _png_ok(out, size=(32, 24))
    img = np.asarray(Image.open(out), np.float32)
    corners = np.mean([img[:4, :4].mean(), img[:4, -4:].mean(),
                       img[-4:, :4].mean(), img[-4:, -4:].mean()])
    assert img[10:14, 14:18].mean() > 1.5 * corners


def test_cli_anim(tmp_path):
    """``anim``: an orbit of three frames with the sun swept, one PNG a
    frame."""
    out = tmp_path / "anim"
    cli.main(["anim", "--width", "32", "--height", "24", "--rays", "1024",
              "--frames", "3", "--steps", "2", "--orbit", "30",
              "--sun-to", "0.1", "0.4", "--exposure", "auto", *CAMERA,
              "--out", str(out), *CPU])
    frames = sorted(os.listdir(out))
    assert frames == [f"frame_{i:04d}.png" for i in range(3)]
    imgs = [np.asarray(Image.open(out / f)) for f in frames]
    assert not np.array_equal(imgs[0], imgs[2])


@pytest.mark.parametrize("ext,reader", [(".exr", read_exr),
                                        (".pfm", read_pfm)])
def test_cli_render_hdr(tmp_path, ext, reader):
    """test_exr's and test_pfm's --hdr cases: the linear radiance in the
    format the extension names, equal to what the PNG was resolved from."""
    out = tmp_path / "x.png"
    hdr = tmp_path / f"x{ext}"
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "2", "--out", str(out), "--hdr", str(hdr), *CPU])
    img = reader(str(hdr))
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.max() > 0
