"""The port's fly controls (Camera.move, Camera.look) against the JAX
package's Camera on the same seeded sequences of moves and looks: every
position (float32) and angle equal exactly, through the pitch clamp and
the 40x sprint."""

import numpy as np
import pytest

from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu_torch.bench import interactive
from tyrant_tpu_torch.camera import Camera


def _same(a, b):
    assert a.position.dtype == b.position.dtype == np.float32
    np.testing.assert_array_equal(a.position, b.position)
    assert a.horizontal_angle == b.horizontal_angle
    assert a.vertical_angle == b.vertical_angle
    np.testing.assert_array_equal(a.direction, b.direction)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_move_and_look_sequence(seed):
    r = np.random.default_rng(seed)
    jc, tc = JCamera(), Camera()
    for _ in range(200):
        if r.random() < 0.5:
            kw = dict(forward=float(r.normal()), strafe=float(r.normal()),
                      vertical=float(r.normal()),
                      delta=float(r.uniform(0.0, 2.0)),
                      sprint=bool(r.random() < 0.3))
            jc.move(**kw)
            tc.move(**kw)
        else:
            # large pitch steps drive the angle into the clamp
            dx, dy = float(r.normal(0, 40)), float(r.normal(0, 150))
            jc.look(dx, dy)
            tc.look(dx, dy)
        _same(jc, tc)


def test_pitch_clamps_short_of_the_poles():
    for dy, want in ((-1e4, np.pi / 2 - 1e-3), (1e4, -np.pi / 2 + 1e-3)):
        jc, tc = JCamera(), Camera()
        jc.look(0.0, dy)
        tc.look(0.0, dy)
        _same(jc, tc)
        assert abs(tc.vertical_angle - want) < 1e-12


def test_sprint_moves_forty_times_as_far():
    a, b = Camera(), Camera()
    a.move(forward=1.0, strafe=0.5, vertical=0.25)
    b.move(forward=1.0, strafe=0.5, vertical=0.25, sprint=True)
    start = Camera().position
    np.testing.assert_allclose(b.position - start, 40.0 * (a.position - start),
                               rtol=1e-4, atol=1e-3)


def test_fly_path_matches_the_jax_script():
    """The driver's flight is the JAX script's fly_path, frame by frame."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "interactive_fps.py")
    spec = importlib.util.spec_from_file_location("interactive_fps", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jc, tc = JCamera(), Camera()
    for i in range(40):
        script.fly_path(jc, i)
        interactive.fly_path(tc, i)
        _same(jc, tc)
