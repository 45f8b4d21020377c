"""The port's examples (``examples/*_torch.py``) on the CPU at small
sizes: each writes a PNG that ``chip_smoke.png_pixels`` decodes to the
asked size; the instanced ring's host scene bit for bit the JAX one; the
glTF demo's file read by both packages' loaders to the original's
arrays; the material showcase's description the original's; the
depth-of-field render resumed from its own checkpoint; the strips on two
CPU devices."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import load_example, png_pixels
from tyrant_tpu import cli as jcli
from tyrant_tpu.scene import gltf as jgltf
from tyrant_tpu.scene import instancing as jinst
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch.scene import files
from tyrant_tpu_torch.scene import gltf as tgltf
from tyrant_tpu_torch.scene.procgen import benchmark_scene
from tyrant_tpu_torch.utils.pfm import read_pfm

from .test_torch_loaders import _as_host, same

SMALL = dict(width=64, height=48, rays=4096)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def png(path, height, width) -> np.ndarray:
    img = png_pixels(Path(path).read_bytes())
    assert img.shape == (height, width, 3)
    return img


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 2,066-triangle terrain as a binary PLY."""
    path = tmp_path_factory.mktemp("mesh") / "terrain.ply"
    files.write_ply(path, *benchmark_scene(2_000))
    return str(path)


def test_render_spheres(tmp_path):
    out = tmp_path / "spheres.png"
    img = load_example("render_spheres_torch").render(str(out), steps=3,
                                                 device="cpu", **SMALL)
    np.testing.assert_array_equal(png(out, 48, 64), img)
    assert 0 < img.mean() < 255


def test_render_mesh_dof_resumes_where_it_stopped(tmp_path, mesh, capsys):
    mod = load_example("render_mesh_dof_torch")
    out = str(tmp_path / "mesh.png")
    mod.render(mesh, out, chunks=2, steps_per_chunk=2, device="cpu", **SMALL)
    first = capsys.readouterr().out
    stopped = int(first.splitlines()[-2].split()[1])  # the last checkpoint
    assert "resumed" not in first
    img = mod.render(mesh, out, chunks=1, steps_per_chunk=2, device="cpu",
                     **SMALL)
    lines = capsys.readouterr().out.splitlines()
    assert f"resumed at frame {stopped}" in lines
    assert f"frame {stopped + 2} checkpointed" in lines
    np.testing.assert_array_equal(png(out, 48, 64), img)


def _jax_ring(mesh, n):
    """The original's ring, built with the JAX instancing functions."""
    dragon = jinst.MeshAsset.load(mesh, scale=60.0)
    insts = []
    for i in range(n):
        th = 2 * np.pi * i / n
        pos = [55.0 * np.sin(th), 55.0 * np.cos(th) - 40.0, -20.0]
        s = 0.7 + 0.5 * (i % 3) / 2
        insts.append((0, jinst.translate(pos) @ jinst.rotate_y(th)
                      @ jinst.scale(s)))
    return JScene.from_instances([dragon], insts, builder="numpy")


def test_render_instances_scene_is_the_jax_one(mesh):
    mod = load_example("render_instances_torch")
    same(_as_host(_jax_ring(mesh, 3)),
         _as_host(mod.ring_scene(mesh, 3, builder="numpy")), "ring")


def test_render_instances(tmp_path, mesh):
    out, hdr = tmp_path / "instances.png", tmp_path / "instances.pfm"
    img = load_example("render_instances_torch").render(
        mesh, n=3, steps=2, out=str(out), hdr=str(hdr), device="cpu",
        **SMALL)
    np.testing.assert_array_equal(png(out, 48, 64), img)
    rad = read_pfm(str(hdr))
    assert rad.shape == (48, 64, 3) and np.isfinite(rad).all()


def test_render_multichip_on_two_cpu_strips(tmp_path):
    out = tmp_path / "multichip.png"
    img = load_example("render_multichip_torch").render(["cpu"] * 2, str(out),
                                                   steps=2)
    np.testing.assert_array_equal(png(out, 64, 320), img)  # 60 -> 2 x 32
    assert 0 < img.mean() < 255


def test_showcase_description_is_the_original_s(tmp_path, mesh, monkeypatch):
    seen = {}

    def fake_cli(argv):
        with open(argv[argv.index("--scene") + 1]) as f:
            seen["desc"] = json.load(f)
        seen["argv"] = argv

    monkeypatch.setattr(jcli, "main", fake_cli)
    monkeypatch.setattr(sys, "argv", ["showcase_materials.py", mesh,
                                      str(tmp_path / "o.png")])
    load_example("showcase_materials").main()
    mod = load_example("showcase_materials_torch")
    assert mod.description(mesh) == seen["desc"]
    # the port's render flags are the original's, and --device
    ported = {}
    monkeypatch.setattr(mod.cli, "main",
                        lambda argv: ported.setdefault("argv", argv))
    mod.render(mesh, str(tmp_path / "o.png"), device="cpu")
    assert ported["argv"][3:] == seen["argv"][3:] + ["--device", "cpu"]


def test_showcase_renders_small(tmp_path, mesh):
    out = tmp_path / "showcase.png"
    load_example("showcase_materials_torch").render(mesh, str(out), steps=2,
                                               device="cpu", **SMALL)
    assert 0 < png(out, 48, 64).mean() < 255


def test_gltf_demo_reads_as_the_original(tmp_path, capsys):
    orig, ours = tmp_path / "orig.glb", tmp_path / "ours.glb"
    load_example("make_gltf_demo").build_glb(str(orig))
    mod = load_example("make_gltf_demo_torch")
    mod.build_glb(str(ours))
    want = _as_host(jgltf.load_gltf(str(orig)))
    same(want, _as_host(jgltf.load_gltf(str(ours))), "JAX loader")
    same(want, _as_host(tgltf.load_gltf(str(ours))), "port loader")
    out = tmp_path / "demo.png"
    mod.render(str(ours), str(out), steps=2, width=64, height=48,
               rays=4096, device="cpu")
    assert 0 < png(out, 48, 64).mean() < 255
