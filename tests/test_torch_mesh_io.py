"""Mesh files: the port's OBJ and .serialized loaders, its ``obj`` and
``serialized`` shape plugins and its file resolver against the JAX
package's, on the fixture meshes both packages generate and on small
files written here from a numpy seed. Equal arrays, bit for bit: both
sides parse the same text or bytes with the same numpy calls.

The reference writes its cached fixture files in place in the temp
directory, so one test worker could read another's half-written file.
``reference_file`` puts them there without that race, and the other
test_torch_*.py files build the reference's big-mesh dicts through it.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from mitsuba2_tpu_torch.utils.io_obj import load_obj
from mitsuba2_tpu_torch.utils.serialized import (load_serialized,
                                                 write_serialized)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


def reference_file(make, *args):
    """The path of the reference fixture file ``make(*args)`` (a generator
    of mitsuba2_tpu/python/test/scenes.py that caches its file in place in
    the temp directory), put there without a race: the generator first
    writes into a directory of this process's, and its file is renamed to
    the shared path unless another worker's is there already."""
    key = (make.__name__, args)
    if key not in _placed:
        shared_dir = tempfile.gettempdir()
        private = tempfile.mkdtemp(dir=shared_dir)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tempfile, "tempdir", private)
                written = make(*args)
            shared = os.path.join(shared_dir, os.path.basename(written))
            if not os.path.exists(shared):
                os.replace(written, shared)
        finally:
            shutil.rmtree(private)
        _placed.add(key)
    return make(*args)


_placed = set()


def jax_bumpy_dict(width, height, spp, max_depth, nu, nv):
    """The reference's biggeo dict, its mesh file put in place first."""
    from mitsuba2_tpu.python.test import scenes as scenes_j
    reference_file(scenes_j._bumpy_sphere_obj_path, nu, nv)
    return scenes_j.bumpy_sphere_dict(width, height, spp, max_depth, nu, nv)


def jax_hero_dict(width, height, spp, max_depth, nu=32, nv=20):
    """The reference's hero dict with an nu x nv mesh (its function always
    names the 512 x 200 file, which would then be written for nothing),
    the mesh and the sky put in place first."""
    from mitsuba2_tpu.python.test import scenes as scenes_j
    path = reference_file(scenes_j._hero_serialized_path, nu, nv)
    reference_file(scenes_j._sky_exr_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes_j, "_hero_serialized_path", lambda: path)
        return scenes_j.hero_serialized_dict(width, height, spp, max_depth)


def assert_same(a, b):
    """Two loader results: the same arrays (or both None)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _polygon_obj(path):
    """An OBJ with v/vt/vn corners, shared and repeated corner triples,
    negative indices, a quad and a pentagon, from a numpy seed."""
    rng = np.random.default_rng(11)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in
             rng.normal(size=(7, 3))]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in rng.uniform(size=(5, 2))]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in
              rng.normal(size=(4, 3))]
    lines += ["# comment", "f 1/1/1 2/2/2 3/3/3",
              "f 1/1/1 3/3/3 4/4/4 5/5/1",
              "f -1/-1/-1 -2/-2/-2 -3/-3/-3 6/1/2 7/2/3",
              "f 2/2/2 3/3/3 4/1/4"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_obj_loader_matches_jax(tmp_path):
    from mitsuba2_tpu.utils.io_obj import load_obj as load_obj_j
    for path in (_polygon_obj(tmp_path / "poly.obj"),
                 scenes_t._bumpy_sphere_obj_path(32, 20)):
        got, want = load_obj(path), load_obj_j(path)
        assert_same(got, want)
    v, f, n, uv = load_obj(_polygon_obj(tmp_path / "poly2.obj"))
    # 1 + 2 + 3 + 1 triangles; 11 distinct (v, vt, vn) corners of 16
    assert f.shape == (7, 3) and len(v) == 11
    assert n is not None and uv is not None


def test_fixture_files_are_the_reference_files(tmp_path, monkeypatch):
    """The port writes its fixture meshes under its own names, with the
    bytes the reference's own generators write (here into a directory of
    this test's)."""
    from mitsuba2_tpu.python.test import scenes as scenes_j
    port = (scenes_t._bumpy_sphere_obj_path(32, 20),
            scenes_t._hero_serialized_path(32, 20))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = (scenes_j._bumpy_sphere_obj_path(32, 20),
           scenes_j._hero_serialized_path(32, 20))
    for ours, theirs in zip(port, ref):
        assert os.path.dirname(theirs) == str(tmp_path)
        assert os.path.basename(ours).startswith("mitsuba2_tpu_torch_")
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


def _meshes(seed):
    rng = np.random.default_rng(seed)
    out = []
    for nv, nf, with_n, with_uv in ((9, 6, True, True), (5, 3, False, True),
                                    (4, 2, True, False)):
        v = rng.normal(size=(nv, 3)).astype(np.float32)
        f = rng.integers(0, nv, size=(nf, 3)).astype(np.int32)
        n = rng.normal(size=(nv, 3)).astype(np.float32) if with_n else None
        uv = rng.uniform(size=(nv, 2)).astype(np.float32) if with_uv \
            else None
        out.append((v, f, n, uv))
    return out


def test_serialized_round_trip_and_jax_reader(tmp_path):
    from mitsuba2_tpu.utils.serialized import (
        load_serialized as load_j, write_serialized as write_j)
    meshes = _meshes(3)
    ours, theirs = tmp_path / "a.serialized", tmp_path / "b.serialized"
    write_serialized(str(ours), meshes)
    write_j(str(theirs), meshes)
    assert ours.read_bytes() == theirs.read_bytes()
    for k, mesh in enumerate(meshes):
        assert_same(load_serialized(str(ours), k), mesh)
        assert_same(load_serialized(str(ours), k), load_j(str(ours), k))
    with pytest.raises(ValueError, match="shape_index 3 >= 3"):
        load_serialized(str(ours), 3)


def test_serialized_hero_matches_jax():
    from mitsuba2_tpu.utils.serialized import load_serialized as load_j
    path = scenes_t._hero_serialized_path(32, 20)
    got = load_serialized(path)
    assert_same(got, load_j(path))
    assert got[1].shape == (2 * 32 * 19, 3)


@pytest.mark.parametrize("kind,face_normals,index", [
    ("obj", False, 0), ("obj", True, 0), ("serialized", False, 0),
    ("serialized", True, 1)])
def test_shape_plugins_match_jax(tmp_path, kind, face_normals, index):
    import mitsuba2_tpu as mj
    if kind == "obj":
        filename = scenes_t._bumpy_sphere_obj_path(32, 20)
    else:
        filename = str(tmp_path / "m.serialized")
        write_serialized(filename, _meshes(5))
    shapes = []
    for pkg in (mj, mt):
        pkg.set_variant("scalar_rgb")
        d = {"type": kind, "filename": filename,
             "face_normals": face_normals,
             "to_world": pkg.Transform.translate([0.5, -1, 2])
             @ pkg.Transform.rotate([1, 1, 0], 30)
             @ pkg.Transform.scale([1, -2, 1])}
        if kind == "serialized":
            d["shape_index"] = index
        shapes.append(pkg.load_dict(d))
    sj, st = shapes
    for name in ("vertices", "faces", "normals", "uvs"):
        a, b = getattr(st, name), getattr(sj, name)
        if b is None:
            assert a is None, name
        else:
            # the transforms are built by each package's own Transform
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert st.face_normals_only == sj.face_normals_only == (
        face_normals or st.normals is None)


def test_file_resolver_search_path(tmp_path):
    from mitsuba2_tpu_torch.core.fresolver import FileResolver
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "mesh.serialized").write_bytes(b"")
    fr = FileResolver()
    assert fr.resolve("mesh.serialized") == "mesh.serialized"
    fr.append(str(tmp_path / "sub"))
    fr.append(str(tmp_path / "sub"))
    assert fr.paths.count(str(tmp_path / "sub")) == 1
    assert fr.resolve("mesh.serialized") == str(tmp_path / "sub" /
                                                 "mesh.serialized")
    abs_path = str(tmp_path / "sub" / "mesh.serialized")
    assert fr.resolve(abs_path) == abs_path


def test_serialized_plugin_resolves_relative_names(tmp_path):
    from mitsuba2_tpu_torch.core.fresolver import file_resolver
    write_serialized(str(tmp_path / "rel.serialized"), _meshes(7))
    fr = file_resolver()
    saved = list(fr.paths)
    try:
        fr.prepend(str(tmp_path))
        mt.set_variant("scalar_rgb")
        shape = mt.load_dict({"type": "serialized",
                              "filename": "rel.serialized"})
    finally:
        fr.paths[:] = saved
    np.testing.assert_array_equal(shape.faces, _meshes(7)[0][1])
