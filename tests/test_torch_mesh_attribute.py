"""``mesh_attribute`` textures and ``Mesh.add_attribute`` in the port
(models/textures.py MeshAttributeTexture, render/scene.py's corner
tables): every case of tests/test_mesh_attribute.py, the texture's values
against the JAX texture's at the same hits, and the Cornell box whose back
wall's reflectance is a vertex color against the JAX wavefront, lane for
lane."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.ray import Ray
from mitsuba2_tpu_torch.python.test.scenes import BACK_WALL_COLORS
from mitsuba2_tpu_torch.render.scene import Scene
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_sensors import make_of
from tests.test_torch_wavefront import render_pair

_on_cpu = cpu_device_fixture()


def _quad_scene(pkg, attr_name="vertex_color", k=3):
    """The unit quad at z = 0 with a per-vertex attribute driving a
    diffuse BSDF, in ``pkg`` (tests/test_mesh_attribute.py _quad_scene)."""
    bsdf = pkg.load_dict({
        "type": "diffuse",
        "reflectance": {"type": "mesh_attribute", "name": attr_name}})
    mesh = pkg.load_dict({"type": "rectangle"}).expand()[0]
    if k == 3:
        vals = np.eye(4, 3, dtype=np.float32) * 0.8 + 0.1
    else:
        vals = np.linspace(0.1, 0.9, mesh.vertex_count,
                           dtype=np.float32)[:, None]
    mesh.add_attribute(attr_name, k, vals[:mesh.vertex_count])
    mesh.bsdf = bsdf
    if pkg is mt:
        return Scene(shapes=[mesh]), mesh, bsdf, vals[:mesh.vertex_count]
    from mitsuba2_tpu.render.scene import Scene as SceneJ
    return SceneJ(shapes=[mesh]), mesh, bsdf, vals[:mesh.vertex_count]


def _hit(scene, xy, wavelengths=None):
    """The scene's hits of rays down -z through the points ``xy``."""
    n = len(xy)
    o = np.column_stack([np.asarray(xy, np.float32),
                         np.full(n, 3.0, np.float32)])
    ray = Ray.make(torch.as_tensor(o), [0.0, 0.0, -1.0], mint=0.0)
    return scene.ray_intersect(ray, None, wavelengths)


def test_vertex_attribute_interpolates():
    scene, mesh, bsdf, vals = _quad_scene(mt)
    tex = bsdf.reflectance
    assert tex._k == 3
    si = _hit(scene, mesh.vertices[:, :2] * 0.999)
    assert bool(si.is_valid().all())
    np.testing.assert_allclose(tex.eval(si).numpy(), vals, atol=5e-3)


def test_scene_eval_attribute_api():
    """The interpolation at one hit from its barycentrics, the face row
    found through the scene's face order."""
    scene, mesh, _, vals = _quad_scene(mt)
    si = _hit(scene, [[0.3, -0.4]])
    v = scene.eval_attribute("vertex_color", si).numpy()[0]
    prim = int(si.prim_idx[0])
    orig = int(scene.bvh.order[prim]) if scene.bvh is not None else prim
    f = mesh.faces[orig]
    u, w = si.prim_uv[0].numpy()
    expect = (1 - u - w) * vals[f[0]] + u * vals[f[1]] + w * vals[f[2]]
    np.testing.assert_allclose(v, expect, atol=1e-4)


def test_scalar_attribute():
    scene, mesh, bsdf, vals = _quad_scene(mt, attr_name="vertex_mask", k=1)
    tex = bsdf.reflectance
    si = _hit(scene, mesh.vertices[:, :2] * 0.999)
    np.testing.assert_allclose(tex.eval_1(si).numpy(), vals[:, 0],
                               atol=5e-3)
    assert tex.eval(si).shape[-1] == 3
    np.testing.assert_allclose(tex.eval_3(si).numpy(),
                               np.repeat(vals, 3, -1), atol=5e-3)


def test_face_attribute():
    """Two points on opposite sides of either diagonal read the two
    faces' values."""
    mesh = mt.load_dict({"type": "rectangle"}).expand()[0]
    mesh.add_attribute("face_id", 1, np.array([[1.0], [2.0]], np.float32))
    scene = Scene(shapes=[mesh])
    v = scene.eval_attribute("face_id", _hit(
        scene, [[0.9, -0.1], [-0.9, 0.1]])).numpy()[:, 0]
    assert set(np.round(v).tolist()) <= {1.0, 2.0}
    assert v[0] != v[1]


def test_spectral_upsampled_eval():
    """In spectral variants a color attribute is upsampled per corner:
    the reflectance spectrum stays in [0, 1]."""
    mt.set_variant("scalar_spectral")
    try:
        scene, mesh, bsdf, _ = _quad_scene(mt)
        wav = torch.tensor([[450.0, 550.0, 600.0, 650.0]] * 2)
        out = bsdf.reflectance.eval(_hit(scene, [[-0.99, -0.99], [0, 0]],
                                         wav))
        assert out.shape == (2, 4)
        assert bool((out >= -1e-3).all() and (out <= 1.05).all())
    finally:
        mt.set_variant("scalar_rgb")


def test_unknown_attribute_raises():
    mesh = mt.load_dict({"type": "rectangle"}).expand()[0]
    mesh.bsdf = mt.load_dict({
        "type": "diffuse",
        "reflectance": {"type": "mesh_attribute", "name": "vertex_nope"}})
    with pytest.raises(RuntimeError, match="vertex_nope"):
        Scene(shapes=[mesh])


def test_bad_attribute_shape_raises():
    mesh = mt.load_dict({"type": "rectangle"}).expand()[0]
    with pytest.raises(ValueError, match="rows"):
        mesh.add_attribute("vertex_color", 3, np.zeros((2, 3)))
    with pytest.raises(ValueError, match="vertex_ or face_"):
        mesh.add_attribute("color", 3, np.zeros((mesh.vertex_count, 3)))


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral",
                                     "scalar_mono"])
@pytest.mark.parametrize("k", [1, 3])
def test_eval_matches_jax(variant, k):
    """``eval``, ``eval_1`` and ``eval_3`` at 256 hits on the quad, as the
    JAX texture's at the same hits."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.core.ray import Ray as RayJ
    r = np.random.default_rng(k)
    xy = (r.random((256, 2), np.float32) * 1.98 - 0.99)
    wav = (r.random((256, 4), np.float32) * 400 + 380).astype(np.float32)
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        st, _, bt, _ = _quad_scene(mt, k=k)
        sj, _, bj, _ = _quad_scene(mj, k=k)
        wl = wav if variant == "scalar_spectral" else np.zeros((256, 0),
                                                                np.float32)
        si_t = _hit(st, xy, torch.as_tensor(wav) if wl.size else None)
        o = np.column_stack([xy, np.full(256, 3.0, np.float32)])
        si_j = sj.ray_intersect(RayJ.make(
            jnp.asarray(o), jnp.tile(jnp.asarray([0.0, 0.0, -1.0]),
                                     (256, 1)),
            mint=jnp.zeros(256), maxt=jnp.full(256, np.inf),
            time=jnp.zeros(256), wavelengths=jnp.asarray(wl)))
        fns = ["eval_1", "eval_3"] + (
            ["eval"] if k == 3 or variant != "scalar_spectral" else [])
        for fn in fns:
            np.testing.assert_allclose(
                getattr(bt.reflectance, fn)(si_t).numpy(),
                np.asarray(getattr(bj.reflectance, fn)(si_j)), rtol=1e-5,
                atol=1e-6, err_msg=fn)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
def test_mesh_attribute_box_matches_jax_wavefront(variant):
    """The Cornell box with a vertex-colored back wall: the path kernel
    refuses the texture, the wavefront renders it, lane for lane."""
    st, img = render_pair(make_of("cornell_mesh_attribute_dict", 16, 4),
                          variant, 16, 4, force=False)
    assert st.integrator.engine_reason == "unsupported BSDF SmoothDiffuse"
    back = next(s for s in st.shapes if "vertex_color" in s.attributes)
    np.testing.assert_array_equal(back.attributes["vertex_color"][1],
                                  BACK_WALL_COLORS)


def test_attribute_beside_an_analytic_sphere():
    """A mesh attribute in a scene that also holds an analytic sphere: the
    corner table covers the meshes' faces only (the JAX scene raises here,
    ROADMAP.md queue 3), and a hit on the quad reads its value."""
    scene, mesh, bsdf, vals = _quad_scene(mt)
    sphere = mt.load_dict({"type": "sphere", "center": [0, 0, -2],
                           "radius": 0.3})
    scene = Scene(shapes=[mesh, sphere])
    assert scene.mesh_attr_tables["vertex_color"][1].shape == (2, 9)
    si = _hit(scene, mesh.vertices[:, :2] * 0.999)
    np.testing.assert_allclose(bsdf.reflectance.eval(si).numpy(), vals,
                               atol=5e-3)
