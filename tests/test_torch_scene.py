"""The port's host packer against the JAX package's: every table the
render step reads must be equal bit for bit."""

import numpy as np
import pytest

from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene.scene import Scene, Spheres

_BVH = ("node_packed", "miss_flat", "tri_packed", "leaf_packed")
_SCENE = ("tri_shade", "sphere_table", "sphere_center", "sphere_radius",
          "sphere_emission")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _scenes(case):
    if case == "spheres":
        return JScene.load(None), Scene.load(None)
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    kw = {}
    if case == "materials":
        r = np.random.default_rng(0)
        kw = dict(tri_refl=r.integers(0, 4, v0.shape[0]).astype(np.int32),
                  tri_color=r.random((v0.shape[0], 3)).astype(np.float32))
    return (JScene.from_triangles(v0, v1, v2, builder="numpy", **kw),
            Scene.from_triangles(v0, v1, v2, builder="numpy", **kw))


@pytest.mark.parametrize("case", ["terrain", "materials", "spheres"])
def test_tables_bitwise(case):
    js, ts = _scenes(case)
    jd, td = js.to_device(), ts.to_device("cpu")
    for k in _BVH:
        np.testing.assert_array_equal(_bits(getattr(td.bvh, k).numpy()),
                                      _bits(np.asarray(getattr(jd.bvh, k))), k)
    for k in _SCENE:
        np.testing.assert_array_equal(_bits(getattr(td, k).numpy()),
                                      _bits(np.asarray(getattr(jd, k))), k)
    assert td.light_index == int(jd.light_index)
    jt, tt = JPacketTables(jd.bvh), PacketTables(td.bvh)
    np.testing.assert_array_equal(_bits(tt.rows.numpy()),
                                  _bits(np.asarray(jt.rows)))
    assert tt.supported == jt.supported
    if case != "spheres":
        assert tt.max_depth == jt.max_depth


def test_interop_round_trip():
    js, _ = _scenes("terrain")
    jd = js.to_device()
    leaves = {k: np.asarray(getattr(jd.bvh, k)) for k in _BVH}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    jt = JPacketTables(jd.bvh)
    sd, tables = interop.scene_from_numpy(leaves, np.asarray(jt.rows), "cpu")
    np.testing.assert_array_equal(_bits(tables.rows.numpy()),
                                  _bits(np.asarray(jt.rows)))
    np.testing.assert_array_equal(_bits(sd.tri_shade.numpy()),
                                  _bits(np.asarray(jd.tri_shade)))
    # depth from the rows alone equals the packer's
    assert tables.max_depth == jt.max_depth and tables.supported


@pytest.mark.parametrize("kw", [dict(tri_vn=np.zeros((1, 3, 3))),
                                dict(envmap=np.ones((4, 8, 3))),
                                dict(tri_refl=np.array([4])),
                                dict(tri_refl=np.array([5]))])
def test_unported_scene_features_raise(kw):
    v = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="not ported"):
        Scene.from_triangles(v, v + [1, 0, 0], v + [0, 1, 0], builder="numpy",
                             **kw)


def test_unported_sphere_sets_raise():
    s = Spheres.default_seven()
    s.refl = s.refl.copy()
    s.refl[0] = 4  # a second emissive sphere
    with pytest.raises(ValueError, match="several emissive"):
        Scene.load(None, spheres=s)
    with pytest.raises(ValueError, match="not ported"):
        Scene.load("mesh.ply")
