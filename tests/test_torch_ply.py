"""The port's PLY reader (utils/io_ply.py) and ``ply`` shape against the JAX
package's: ascii, binary little-endian and big-endian files with normals,
uvs, polygons and custom vertex attributes (the grouping of ply.cpp:50-58,
integer types normalized) read into the same arrays as
``mitsuba2_tpu.utils.io_ply.load_ply``; the PLY bumpy sphere's mesh the
OBJ's bit for bit, and its render the OBJ's."""

import struct

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import (
    _bumpy_sphere_obj_path, bumpy_sphere_dict, bumpy_sphere_ply_path)
from mitsuba2_tpu_torch.utils.io_ply import load_ply
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

VERTS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0.5, 0.5, 1)]
FACES = [(0, 1, 2, 3), (0, 1, 4), (1, 2, 4), (2, 3, 4)]
HEADER = ("element vertex 5\n"
          "property float x\nproperty float y\nproperty float z\n"
          "property float nx\nproperty float ny\nproperty float nz\n"
          "property float s\nproperty float t\n"
          "property ushort red\nproperty ushort green\nproperty ushort blue\n"
          "property float disp_x\nproperty float disp_y\n"
          "property float disp_z\n"
          "property uchar mask\n"
          "element face 4\n"
          "property list uchar int vertex_indices\n"
          "end_header\n")


def _vertex(i, v):
    n = np.asarray(v, np.float64) - 0.5
    n /= np.linalg.norm(n)
    return (list(v) + list(n) + [v[0] * 0.5, v[1] * 0.25]
            + [1000 * i, 65535 - 7000 * i, 30000]
            + [i * 1.0, i * 2.0, i * 3.0] + [40 * i])


def write_ply(path, fmt):
    """A pyramid of one quad and three triangles in ``fmt``: ascii,
    binary_little_endian or binary_big_endian."""
    head = f"ply\nformat {fmt} 1.0\ncomment a test\n{HEADER}".encode()
    with open(path, "wb") as f:
        f.write(head)
        if fmt == "ascii":
            for i, v in enumerate(VERTS):
                f.write((" ".join(str(x) for x in _vertex(i, v))
                         + "\n").encode())
            for face in FACES:
                f.write((" ".join(str(x) for x in (len(face),) + face)
                         + "\n").encode())
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        for i, v in enumerate(VERTS):
            f.write(struct.pack(e + "8f3H3fB", *_vertex(i, v)))
        for face in FACES:
            f.write(struct.pack(e + "B%di" % len(face), len(face), *face))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
def test_reader_matches_jax_package(tmp_path, fmt):
    from mitsuba2_tpu.utils.io_ply import load_ply as load_ply_j
    p = str(tmp_path / f"pyramid_{fmt}.ply")
    write_ply(p, fmt)
    got, want = load_ply(p), load_ply_j(p)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    v, f, n, uv, attrs = got
    assert v.shape == (5, 3) and f.shape == (5, 3) and n.shape == (5, 3)
    np.testing.assert_array_equal(f[:2], [[0, 1, 2], [0, 2, 3]])
    assert uv.shape == (5, 2)
    assert set(attrs) == set(want[4]) == {"vertex_color", "vertex_disp",
                                          "vertex_mask"}
    for k in attrs:
        np.testing.assert_array_equal(attrs[k], want[4][k])
    np.testing.assert_allclose(attrs["vertex_color"][1],
                               [1000 / 65535, 58535 / 65535, 30000 / 65535],
                               rtol=1e-6)
    np.testing.assert_allclose(attrs["vertex_mask"][:, 0],
                               np.arange(5) * 40 / 255, rtol=1e-6)


def test_ply_shape_matches_jax_package(tmp_path):
    """The ``ply`` shape under a transform in both packages: vertices,
    faces, normals, uvs and mesh attributes."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.core.transform import Transform as TJ
    p = str(tmp_path / "pyramid.ply")
    write_ply(p, "binary_little_endian")
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    mesh_j = mj.load_dict({"type": "ply", "filename": p,
                           "to_world": TJ.rotate([0, 1, 1], 30)
                           @ TJ.scale([1, 2, 0.5])})
    mesh_t = mt.load_dict({"type": "ply", "filename": p,
                           "to_world": mt.Transform.rotate([0, 1, 1], 30)
                           @ mt.Transform.scale([1, 2, 0.5])})
    for name in ("vertices", "faces", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(mesh_t, name),
                                      getattr(mesh_j, name))
    assert mesh_t.attributes.keys() == mesh_j.attributes.keys()
    for k, (size, data) in mesh_t.attributes.items():
        assert size == mesh_j.attributes[k][0]
        np.testing.assert_array_equal(data, mesh_j.attributes[k][1])
    flat = mt.load_dict({"type": "ply", "filename": p,
                         "face_normals": True})
    assert flat.normals is None and flat.face_normals_only


def test_custom_vertex_attributes(tmp_path):
    """tests/test_parity_extras.py:61-90 on the port: bare red/green/blue
    group into a normalized vertex_color, {prefix}_{x,y,z} into
    vertex_{prefix}, a leftover scalar into a 1-wide attribute."""
    p = str(tmp_path / "attr.ply")
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                b"element vertex 3\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\n"
                b"property float disp_x\nproperty float disp_y\n"
                b"property float disp_z\n"
                b"property float mask\n"
                b"element face 1\n"
                b"property list uchar int vertex_indices\n"
                b"end_header\n")
        for i, (x, y, z) in enumerate([(0, 0, 0), (1, 0, 0), (0, 1, 0)]):
            f.write(struct.pack("<fff", x, y, z))
            f.write(struct.pack("<BBB", 255, 128, 0))
            f.write(struct.pack("<fff", i * 1.0, i * 2.0, i * 3.0))
            f.write(struct.pack("<f", 0.5 + i))
        f.write(struct.pack("<B", 3) + struct.pack("<iii", 0, 1, 2))
    m = mt.load_dict({"type": "ply", "filename": p})
    assert set(m.attributes) == {"vertex_color", "vertex_disp",
                                 "vertex_mask"}
    size, color = m.attributes["vertex_color"]
    assert size == 3
    assert np.allclose(color[0], [1.0, 128 / 255.0, 0.0], atol=1e-6)
    size, disp = m.attributes["vertex_disp"]
    assert size == 3 and np.allclose(disp[2], [2.0, 4.0, 6.0])
    size, mask = m.attributes["vertex_mask"]
    assert size == 1 and np.allclose(mask[:, 0], [0.5, 1.5, 2.5])


def test_ascii_roundtrip(tmp_path):
    p = str(tmp_path / "tri.ply")
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                "element vertex 3\n"
                "property float x\nproperty float y\nproperty float z\n"
                "element face 1\n"
                "property list uchar int vertex_indices\n"
                "end_header\n"
                "0 0 0\n1 0 0\n0 1 0\n"
                "3 0 1 2\n")
    m = mt.load_dict({"type": "ply", "filename": p})
    assert len(m.vertices) == 3 and len(m.faces) == 1


def test_not_a_ply_file_raises(tmp_path):
    p = tmp_path / "x.ply"
    p.write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY file"):
        load_ply(str(p))


def test_bumpy_sphere_ply_is_the_obj_bit_for_bit():
    """The fixture's PLY holds the OBJ loader's arrays: the two meshes are
    equal bit for bit, and the PLY carries a vertex_color attribute."""
    obj = mt.load_dict({"type": "obj",
                        "filename": _bumpy_sphere_obj_path(32, 20)})
    ply = mt.load_dict({"type": "ply",
                        "filename": bumpy_sphere_ply_path(32, 20)})
    np.testing.assert_array_equal(ply.vertices, obj.vertices)
    np.testing.assert_array_equal(ply.faces, obj.faces)
    assert ply.normals is None and ply.uvs is None
    assert obj.normals is None and obj.uvs is None
    size, color = ply.attributes["vertex_color"]
    assert size == 3 and color.shape == (len(obj.vertices), 3)
    assert 0.0 <= color.min() and color.max() <= 1.0


def test_ply_render_is_the_obj_render():
    """The bumpy sphere scene with its mesh read from the PLY renders the
    OBJ scene's image bit for bit (the BVH tier: the 1,216-face mesh, the
    floor and the light)."""
    mt.set_variant("scalar_rgb")
    d = bumpy_sphere_dict(8, 8, 2, 3, 32, 20)
    img_obj = mt.load_dict(d)
    d = bumpy_sphere_dict(8, 8, 2, 3, 32, 20)
    d["hero"]["type"] = "ply"
    d["hero"]["filename"] = bumpy_sphere_ply_path(32, 20)
    img_ply = mt.load_dict(d)
    assert img_ply.tables.n_faces == img_obj.tables.n_faces == 1216 + 4
    a = img_obj.integrator.render(img_obj, seed=1, spp=2)
    b = img_ply.integrator.render(img_ply, seed=1, spp=2)
    assert img_ply.integrator.last_engine == "kernel"
    assert torch.isfinite(a).all() and float(a.mean()) > 0
    assert torch.equal(a, b)
