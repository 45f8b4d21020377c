"""The port's host packer, BVH builders and procedural meshes against the
JAX package's: every table the render step reads, every BVH array and
every generated vertex must be equal bit for bit.  The port's native
builder is held against its numpy builder as the JAX package holds its
own (tests/test_native.py): integer arrays exact, bounds at rtol 1e-6."""

import numpy as np
import pytest

from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.scene import bvh as jbvh
from tyrant_tpu.scene import procgen as jprocgen
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch.native import bvh_native
from tyrant_tpu_torch.scene import bvh as tbvh
from tyrant_tpu_torch.scene import procgen as tprocgen
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene.scene import DeltaLights, Scene, Spheres

_BVH = ("node_packed", "miss_flat", "tri_packed", "leaf_packed")
_SCENE = ("tri_shade", "sphere_table", "sphere_center", "sphere_radius",
          "sphere_emission")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _soup(n, seed):
    """n random triangles: scattered vertices, small random edges."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-50, 50, (n, 3)).astype(np.float32)
    v1 = v0 + r.normal(0, 2, (n, 3)).astype(np.float32)
    v2 = v0 + r.normal(0, 2, (n, 3)).astype(np.float32)
    return v0, v1, v2


def _bounds(v0, v1, v2):
    return (np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2))


_BVH_ARRAYS = ("lo", "hi", "meta", "second_child", "hit_link", "miss_link",
               "perm")


def _mesh(case):
    if case == "terrain":
        return terrain(n_quads=24, towers=3)
    return _soup(int(case.split("-")[1]), seed=5)


@pytest.mark.parametrize("case", ["terrain", "soup-1", "soup-17", "soup-3000"])
@pytest.mark.parametrize("method", ["sah", "equal_counts"])
def test_numpy_bvh_equals_jax_bitwise(case, method):
    lo, hi = _bounds(*_mesh(case))
    a = jbvh.build_bvh(lo, hi, method=method)
    b = tbvh.build_bvh(lo, hi, method=method)
    assert a.n_nodes == b.n_nodes
    for k in _BVH_ARRAYS:
        np.testing.assert_array_equal(_bits(getattr(b, k)),
                                      _bits(getattr(a, k)), k)
    assert tbvh.bvh_stats(b) == jbvh.bvh_stats(a)


@pytest.mark.parametrize("case", ["terrain", "soup-1", "soup-17", "soup-3000"])
def test_native_bvh_equals_numpy(case):
    lo, hi = _bounds(*_mesh(case))
    a = tbvh.build_bvh(lo, hi)
    b = bvh_native.build_bvh(lo, hi)
    assert a.n_nodes == b.n_nodes
    for k in ("meta", "second_child", "hit_link", "miss_link", "perm"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), k)
    np.testing.assert_allclose(b.lo, a.lo, rtol=1e-6)
    np.testing.assert_allclose(b.hi, a.hi, rtol=1e-6)


def test_native_library_builds_outside_the_jax_package():
    from tyrant_tpu_torch import native
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "tyrant_tpu_torch")
    assert "tyrant_tpu" not in path.relative_to(native.BUILD_DIR.parents[1]) \
        .parts[1:]


@pytest.mark.parametrize("builder", ["auto", "native", "numpy"])
def test_scene_builders_agree(builder):
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    ref = Scene.from_triangles(v0, v1, v2, builder="numpy").bvh
    got = Scene.from_triangles(v0, v1, v2, builder=builder).bvh
    for k in ("meta", "second_child", "miss_link", "perm"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)


@pytest.mark.parametrize("fn,kw", [
    ("terrain", {}), ("terrain", dict(n_quads=20, towers=5, seed=3)),
    ("terrain", dict(n_quads=9, towers=0, rng_seed=11, height=10.0)),
    ("benchmark_scene", dict(n_tris_target=5000)),
    ("benchmark_scene", dict(n_tris_target=20_000, seed=2))])
def test_procgen_equals_jax(fn, kw):
    got = getattr(tprocgen, fn)(**kw)
    want = getattr(jprocgen, fn)(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(w))


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


_TEX = dict(textures=[np.ones((2, 2, 3), np.float32)],
            tri_uv=np.zeros((1, 3, 2)))


@pytest.mark.parametrize("kw", [
    dict(_TEX, tri_tex=np.zeros(1, np.int32)),
    dict(_TEX, tri_ntex=np.zeros(1, np.int32)),
    dict(_TEX, tri_rtex=np.zeros(1, np.int32)),
    dict(textures=[np.full((2, 2, 4), 0.5, np.float32)],
         tri_uv=np.zeros((1, 3, 2)), tri_tex=np.zeros(1, np.int32),
         tri_refl=np.array([4]), delta_lights=[
             {"type": "point", "position": [0, 0, 9]}])])
def test_unported_scene_features_raise(kw):
    """Once refused on upload, now shaded (the name is kept from then): a
    scene with each texture record (an albedo map, a normal map, a
    roughness map, and a half-transparent emissive texture beside a delta
    light) uploads with every table, the atlas, its meta and the gates
    bit for bit the JAX package's."""
    from tyrant_tpu.scene.scene import DeltaLights as JDeltaLights

    from .test_torch_loaders import check_tables
    v = np.zeros((1, 3), np.float32)
    tri = (v, v + [1, 0, 0], v + [0, 1, 0])
    specs = kw.get("delta_lights")
    tkw = dict(kw, delta_lights=specs and DeltaLights.from_specs(specs))
    jkw = dict(kw, delta_lights=specs and JDeltaLights.from_specs(specs))
    td = Scene.from_triangles(*tri, builder="numpy", **tkw).to_device("cpu")
    check_tables(JScene.from_triangles(*tri, builder="numpy", **jkw)
                 .to_device(), td)
    assert td.tex_data.shape == (1 + 4 + 1, 4) and td.tex_meta  # 2x2, 1x1
    assert not td.tri_default_mat


def test_unported_sphere_sets_raise():
    """Several emissive spheres and an envmap, once refused, upload with
    their light tables bit for bit the JAX package's (the name is kept
    from when the port refused them)."""
    from tyrant_tpu.scene.scene import Spheres as JSpheres
    s, js = Spheres.default_seven(), JSpheres.default_seven()
    s.refl = js.refl = s.refl.copy()
    s.refl[0] = 4  # a second emissive sphere
    s.emission = js.emission = s.emission.copy()
    s.emission[0] = (1.0, 2.0, 0.5)
    env = np.random.default_rng(2).uniform(0, 4, (4, 8, 3))
    td = Scene.load(None, spheres=s, envmap=env).to_device("cpu")
    jd = JScene.load(None, spheres=js, envmap=env).to_device()
    assert td.light_indices == jd.light_indices == (0, 6)
    assert td.env_meta == jd.env_meta == (4.0, 8.0)
    for k in ("light_powers", "env_data", "env_alias", "sphere_table"):
        np.testing.assert_array_equal(_bits(getattr(td, k).numpy()),
                                      _bits(np.asarray(getattr(jd, k))), k)
