"""The port's Blender bridge shape (models/shapes.py ``blender``) against the
JAX package's ``BlenderMesh`` on the same in-memory Blender structs (the
buffers of tests/test_blender.py): the five cases of that file, each
holding the port's vertices, faces, normals, uvs and vertex-color
attributes to the JAX package's."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_blender import _make_blender_quad
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


@pytest.fixture(autouse=True)
def _rgb():
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    yield


def both(d, to_world=None):
    """The ``blender`` shape of dict ``d`` in both packages -> (port's,
    JAX package's)."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.core.transform import Transform as TJ
    dt, dj = dict(d), dict(d)
    if to_world is not None:
        dt["to_world"] = to_world(mt.Transform)
        dj["to_world"] = to_world(TJ)
    return mt.load_dict(dt), mj.load_dict(dj)


def assert_same_mesh(mt_mesh, mj_mesh):
    assert mt_mesh.vertex_count == mj_mesh.vertex_count
    assert mt_mesh.face_count == mj_mesh.face_count
    np.testing.assert_array_equal(mt_mesh.faces, mj_mesh.faces)
    for name in ("vertices", "normals", "uvs"):
        a, b = getattr(mt_mesh, name), getattr(mj_mesh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7,
                                       err_msg=name)
    assert mt_mesh.attributes.keys() == mj_mesh.attributes.keys()
    for k, (size, data) in mt_mesh.attributes.items():
        assert size == mj_mesh.attributes[k][0]
        np.testing.assert_allclose(data, np.asarray(mj_mesh.attributes[k][1]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_smooth_quad_dedups_shared_verts():
    d, buf = _make_blender_quad(smooth=True)
    mesh, ref = both(d)
    assert_same_mesh(mesh, ref)
    # smooth shading and matching uvs: the 2 shared corners merge
    assert mesh.vertex_count == 4 and mesh.face_count == 2
    np.testing.assert_allclose(mesh.normals, [[0, 0, 1]] * 4, atol=1e-6)
    # v flipped (blender.cpp:243)
    uv_of_origin = mesh.uvs[np.argmin(mesh.vertices[:, 0]
                                      + mesh.vertices[:, 1])]
    np.testing.assert_allclose(uv_of_origin, [0, 0], atol=1e-6)


def test_flat_quad_keeps_per_face_corners():
    d, buf = _make_blender_quad(smooth=False)
    mesh, ref = both(d, lambda T: T.translate([0.5, 0, 1])
                     @ T.rotate([1, 1, 0], 40) @ T.scale([2, 1, 1]))
    assert_same_mesh(mesh, ref)
    # flat shading: corners keyed by polygon, 3 + 3 vertices
    assert mesh.vertex_count == 6 and mesh.face_count == 2


def test_material_filter():
    d, buf = _make_blender_quad(mat_nr=1)  # every face on slot 1
    mesh, ref = both(d)                    # slot 0 asked for
    assert mesh.face_count == ref.face_count == 0


def test_vertex_colors_srgb_to_linear():
    d, buf = _make_blender_quad(smooth=True, with_col=True)
    mesh, ref = both(d)
    assert_same_mesh(mesh, ref)
    k, data = mesh.attributes["vertex_Col"]
    assert k == 3 and len(data) == mesh.vertex_count
    # 255 -> 1.0; 128 -> ~0.216
    assert np.isclose(data.max(), 1.0, atol=1e-5)
    assert len(data[np.isclose(data, 0.2158, atol=2e-2)]) > 0


def test_renders_through_pipeline():
    d, buf = _make_blender_quad(smooth=True, with_col=True)
    scene = mt.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "light": {"type": "constant"},
        "quad": {**d, "bsdf": {"type": "diffuse"}},
        "sensor": {
            "type": "perspective",
            "to_world": mt.Transform.look_at([0.5, 0.5, 3], [0.5, 0.5, 0],
                                             [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 8},
        },
    })
    img = scene.integrator.render(scene, seed=0)
    assert torch.isfinite(img).all() and float(img.max()) > 0
    assert scene.tables.n_faces == 2


def test_properties_long_and_property_names():
    """``Properties.long_`` (a 64-bit pointer) and ``property_names``
    (every name, queried or not, in order), as the JAX package's."""
    from mitsuba2_tpu.core.properties import Properties as PJ
    from mitsuba2_tpu_torch.core.properties import Properties
    for P in (Properties, PJ):
        p = P("blender")
        p["verts"] = 0x7F00_1234_5678
        p["name"] = "quad"
        p["vertex_Col"] = 1
        assert p.long_("verts") == 0x7F00_1234_5678
        assert p.long_("missing", 5) == 5
        with pytest.raises(KeyError):
            p.long_("missing")
        assert p.property_names() == ["verts", "name", "vertex_Col"]
        assert p.unqueried() == ["name", "vertex_Col"]
