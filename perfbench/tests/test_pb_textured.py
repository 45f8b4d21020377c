"""The ``textured_1m`` configuration's own files: its scene generator
(``perfbench/scenes/textured.py``) gives the program's textured scene
(``tyrant_tpu_torch/scene/files.py:textured_scene`` on the frozen
terrain) bit for bit, as the digests below recorded it when the copy was
taken; its plain reference (``perfbench/reference/textured.py``) loads
without a module of the program, JAX or the JAX package, and refuses a
scene it does not shade; and the reference computed in bfloat16, the
configuration's lower-precision control, is not correct."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest

import pb_cpu
from perfbench import check, control, run, terrain
from perfbench.scenes import textured

CELL = "textured_1m.poses"
CONFIG = pb_cpu.ROOT / "perfbench" / "configs" / "textured_1m.json"
# the leaf and pane density of the cell's scene on the 2,192-triangle
# terrain, four rays a pixel (tests/test_torch_textured_reference.py)
TINY = {"terrain": {"n_tris_target": 2048},
        "textured": {"n_leaves": 4096, "n_blend": 2048, "albedo_px": 64,
                     "normal_px": 64, "rough_px": 32, "leaf_px": 32},
        "render": {"width": 32, "height": 16, "num_rays": 2048}}
# the generator's arrays and maps (every key but the spheres, by name,
# each with its dtype and shape), hashed when the copy was taken
DIGESTS = {
    "tiny": (12_432, "338cda38682ddb6b80816307f5affba3"
                     "22cdedc5a9ec0aedc82e4fffa5a18397"),
    "full": (1_180_592, "6170c0ffe4f52e31aeaddcbd45450c2a"
                        "b72b26e70004807278569bc865c53c21")}


def _digest(kw: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(kw):
        if key == "spheres":
            continue
        vals = kw[key] if key in ("textures", "texture_wraps") else [kw[key]]
        for a in vals:
            a = np.ascontiguousarray(np.asarray(a))
            h.update(f"{key} {a.dtype} {a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _scene(size: str) -> dict:
    scene = json.loads(CONFIG.read_text())["scene"]
    if size == "tiny":
        for group in ("terrain", "textured"):
            scene[group] = {**scene[group], **TINY[group]}
    return scene


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_the_generator_is_the_programs_textured_scene(size):
    from tyrant_tpu_torch.scene import files
    scene = _scene(size)
    kw = textured.make(scene)
    ter = scene["terrain"]
    want = files.textured_scene(
        *terrain.benchmark_scene(ter["n_tris_target"], seed=ter["seed"]),
        **scene["textured"])
    assert sorted(kw) == sorted([*want, "spheres"])
    for key, a in want.items():
        got = kw[key]
        if key in ("textures", "texture_wraps"):
            assert len(got) == len(a), key
            pairs = zip(got, a)
        else:
            pairs = [(got, a)]
        for g, w in pairs:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
    count, digest = DIGESTS[size]
    assert len(kw["v0"]) == count and _digest(kw) == digest
    rows = scene["spheres"]
    assert np.array_equal(kw["spheres"].center,
                          np.array([r["center"] for r in rows], np.float32))


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(pb_cpu.ROOT)!r})\n"
        "from perfbench import run\n"
        "run.reference_module({'reference': 'textured', 'scene': {}})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    roots = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "torch" in roots
    assert not roots & {"tyrant_tpu_torch", "tyrant_tpu", "jax", "jaxlib",
                        "flax"}


def test_the_reference_refuses_what_it_does_not_shade():
    config = json.loads(CONFIG.read_text())
    ref = run.reference_module(config)
    kw = textured.make(_scene("tiny"))
    with pytest.raises(ValueError, match="tri_vn"):
        ref.make_step(dict(kw, tri_vn=np.zeros((len(kw["v0"]), 3, 3))),
                      config, dict(config["render"]), "cpu")
    with pytest.raises(ValueError, match="bilinear"):
        ref.make_step(kw, config, dict(config["render"],
                                       texture_filter="nearest"), "cpu")


def test_the_bfloat16_control_is_not_correct():
    pb_cpu.pin_threads()
    lims = check.limits()
    (reading,) = control.control(CELL, [2_147_483_901], 0.3, device="cpu",
                                 tiny=TINY)
    program, ctrl = reading["program"], reading["control"]
    assert all(v <= lims[k] for k, v in program.items()), program
    assert any(v > lims[k] for k, v in ctrl.items()), ctrl
