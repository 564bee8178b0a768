"""The port's Mitsuba XML loader (core/xml_impl.py, ``load_file`` and
``load_string``) and writer (python/xml.py ``dict_to_xml``) against the JAX
package's: every case of tests/test_xml.py and the four XML cases of
tests/test_parity_extras.py on the port, the same XML text through both
packages giving the same plugins and face tables, the two writers giving
the same text for one dict, and the XML Cornell box per pixel against the
JAX path kernel on the same file (the bar of test_torch_path_kernel.py).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import (
    cornell_box_dict as cornell_t, cornell_xml_path, instanced_spheres_dict)
from mitsuba2_tpu_torch.python.xml import dict_to_xml
from tests.test_torch_path_kernel import (assert_images_agree,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()

CORNELL_XML = """
<scene version="2.0.0">
    <default name="spp" value="4"/>
    <integrator type="path">
        <integer name="max_depth" value="$depth"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="39.3077"/>
        <transform name="to_world">
            <lookat origin="0, 0, 3.9" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
            <rfilter type="box"/>
        </film>
        <sampler type="independent">
            <integer name="sample_count" value="$spp"/>
        </sampler>
    </sensor>
    <bsdf type="diffuse" id="white">
        <rgb name="reflectance" value="0.725 0.71 0.68"/>
    </bsdf>
    <shape type="rectangle">
        <transform name="to_world">
            <rotate value="1 0 0" angle="-90"/>
            <translate value="0 -1 0"/>
        </transform>
        <ref id="white"/>
    </shape>
    <shape type="rectangle">
        <transform name="to_world">
            <rotate value="1 0 0" angle="90"/>
            <scale value="0.23"/>
            <translate value="0 0.99 0"/>
        </transform>
        <ref id="white"/>
        <emitter type="area">
            <rgb name="radiance" value="18.387 13.9873 6.75357"/>
        </emitter>
    </shape>
</scene>
"""

RECT_XML = """<scene version="2.0.0">
  <default name="albedo" value="0.25"/>
  <shape type="rectangle">
    <bsdf type="diffuse">
      <rgb name="reflectance" value="$albedo"/>
    </bsdf>
  </shape>
</scene>"""


@pytest.fixture(autouse=True)
def _rgb():
    mt.set_variant("scalar_rgb")
    yield
    mt.set_variant("scalar_rgb")


# ---- tests/test_xml.py on the port -----------------------------------------

def test_load_string_scene():
    scene = mt.load_string(CORNELL_XML, params={"depth": 3})
    assert len(scene.shapes) == 2
    assert len(scene.emitters) == 1
    assert scene.integrator.max_depth == 3
    assert scene.sensors[0].sampler.sample_count == 4
    img = scene.integrator.render(scene, seed=0)
    assert torch.isfinite(img).all() and float(img.mean()) > 0


def test_load_string_bsdf():
    b = mt.load_string("""
        <bsdf version="2.0.0" type="roughconductor">
            <string name="material" value="Au"/>
            <float name="alpha" value="0.2"/>
            <string name="distribution" value="ggx"/>
        </bsdf>""")
    assert type(b).__name__ == "RoughConductor"
    assert np.isclose(b.alpha_u, 0.2)


def test_missing_param_raises():
    from mitsuba2_tpu_torch.core.xml_impl import XMLParseError
    with pytest.raises(XMLParseError, match="undefined parameter"):
        mt.load_string("""
            <scene version="2.0.0">
                <integrator type="path">
                    <integer name="max_depth" value="$missing"/>
                </integrator>
            </scene>""")


def test_unused_property_raises():
    with pytest.raises(RuntimeError, match="Unreferenced"):
        mt.load_string("""
            <bsdf version="2.0.0" type="diffuse">
                <float name="bogus" value="1"/>
            </bsdf>""")


def test_version_upgrade_camelcase():
    s = mt.load_string("""
        <sensor version="0.6.0" type="perspective">
            <float name="nearClip" value="0.5"/>
        </sensor>""")
    assert np.isclose(s.near_clip, 0.5)


def test_transform_composition():
    shape = mt.load_string("""
        <shape version="2.0.0" type="rectangle">
            <transform name="to_world">
                <scale value="2"/>
                <translate value="1 0 0"/>
            </transform>
        </shape>""")
    # scale first, then translate: x spans [-1, 3]
    lo, hi = shape.bbox()
    assert np.isclose(lo[0], -1.0) and np.isclose(hi[0], 3.0)


def test_spectrum_plugin_in_xml():
    e = mt.load_string("""
        <emitter version="2.0.0" type="area">
            <spectrum name="radiance" type="d65">
                <float name="scale" value="2.0"/>
            </spectrum>
        </emitter>""")
    assert type(e.radiance).__name__ == "D65Spectrum"


def test_spectrum_curve_value():
    t = mt.load_string("""
        <bsdf version="2.0.0" type="diffuse">
            <spectrum name="reflectance" value="400:0.1, 500:0.5, 700:0.2"/>
        </bsdf>""")
    assert type(t.reflectance).__name__ == "IrregularSpectrum"


# ---- the XML cases of tests/test_parity_extras.py on the port --------------

@pytest.mark.parametrize("params,albedo", [(None, 0.25),
                                           ({"albedo": "0.75"}, 0.75)])
def test_xml_default_substitution_and_override(tmp_path, params, albedo):
    p = tmp_path / "s.xml"
    p.write_text(RECT_XML)
    scene = mt.load_file(str(p), params=params)
    assert np.allclose(scene.shapes[0].bsdf.reflectance.rgb, albedo,
                       atol=1e-6)


def test_xml_named_reference(tmp_path):
    p = tmp_path / "s3.xml"
    p.write_text("""<scene version="2.0.0">
  <bsdf type="diffuse" id="mat">
    <rgb name="reflectance" value="0.1 0.6 0.3"/>
  </bsdf>
  <shape type="rectangle"><ref id="mat"/></shape>
  <shape type="rectangle"><ref id="mat"/>
    <transform name="to_world"><translate x="3"/></transform>
  </shape>
</scene>""")
    scene = mt.load_file(str(p))
    assert scene.shapes[0].bsdf is scene.shapes[1].bsdf


def test_xml_lookat_transform(tmp_path):
    p = tmp_path / "s4.xml"
    p.write_text("""<scene version="2.0.0">
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="0, 0, 5" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="4"/>
      <integer name="height" value="4"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent"/>
  </sensor>
</scene>""")
    scene = mt.load_file(str(p))
    M = np.asarray(scene.sensors[0].world_transform.matrix)
    assert np.allclose(M[:3, 3], [0, 0, 5], atol=1e-5)


def test_include_alias_and_file_resolver(tmp_path):
    """``<include>`` of a file beside the scene (found through the file
    resolver, to which ``load_file`` adds the scene's directory),
    ``<alias>``, and a mesh file named relative to the scene."""
    from mitsuba2_tpu_torch.python.test.scenes import _bumpy_sphere_obj_path
    import shutil
    d = tmp_path / "assets"
    d.mkdir()
    shutil.copy(_bumpy_sphere_obj_path(16, 8), d / "sphere.obj")
    (d / "mat.xml").write_text("""<scene version="2.0.0">
  <bsdf type="diffuse" id="m"><rgb name="reflectance" value="0.5"/></bsdf>
</scene>""")
    (d / "scene.xml").write_text("""<scene version="2.0.0">
  <include filename="mat.xml"/>
  <alias id="m" as="other"/>
  <shape type="obj"><string name="filename" value="sphere.obj"/>
    <ref id="other"/></shape>
</scene>""")
    scene = mt.load_file(str(d / "scene.xml"))
    assert len(scene.shapes) == 1 and scene.tables.n_faces == 224
    assert np.allclose(scene.shapes[0].bsdf.reflectance.rgb, 0.5)


# ---- the port against the JAX package on the same text ----------------------

def _matrix(t):
    return np.asarray(t.matrix, np.float64)


def test_same_xml_gives_same_plugins_and_face_tables():
    """The XML Cornell box (written by the port's writer) through both
    packages' ``load_file``: the same plugin types, sensor transform,
    film, sampler, integrator and light radiance, and equal face
    tables."""
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    path = cornell_xml_path(16, 16, 4, 3)
    sj, st = mj.load_file(path), mt.load_file(path)
    assert [type(s).__name__ for s in st.shapes] \
        == [type(s).__name__ for s in sj.shapes]
    assert [type(s.bsdf).__name__ for s in st.shapes] \
        == [type(s.bsdf).__name__ for s in sj.shapes]
    assert type(st.integrator).__name__ == type(sj.integrator).__name__
    assert st.integrator.max_depth == sj.integrator.max_depth == 3
    senj, sent = sj.sensors[0], st.sensors[0]
    np.testing.assert_allclose(_matrix(sent.world_transform),
                               _matrix(senj.world_transform), rtol=0,
                               atol=1e-7)
    assert sent.film.crop_size == tuple(senj.film.crop_size) == (16, 16)
    assert sent.sampler.sample_count == senj.sampler.sample_count == 4
    assert type(st.emitters[0].radiance).__name__ \
        == type(sj.emitters[0].radiance).__name__
    for a, b in ((st.v0, sj.geom.v0), (st.e1, sj.geom.e1),
                 (st.e2, sj.geom.e2), (st.ng, sj.geom.ng)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(st.face_shape, np.asarray(
        sj.geom.face_shape))


def test_xml_scene_within_the_writers_rounding_of_the_dict_scene():
    """The XML Cornell box's face tables are the dict scene's within the
    ``%.6g`` rounding of the writer (1e-6 relative to the scene's
    extent)."""
    st = mt.load_file(cornell_xml_path(16, 16, 4, 3))
    sd = mt.load_dict(cornell_t(16, 16, 4, 3))
    for a, b in ((st.v0, sd.v0), (st.e1, sd.e1), (st.e2, sd.e2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.face_shape, sd.face_shape)


def test_writers_give_the_same_text():
    """``dict_to_xml`` of the fixture dicts gives the JAX writer's text
    letter for letter: the Cornell box, the instancing scene (also the
    JAX tests' own dict of it) and a plugin that is not a scene."""
    from mitsuba2_tpu.core.transform import Transform as TJ
    from mitsuba2_tpu.python.test.scenes import (
        _bumpy_sphere_obj_path as obj_j, cornell_box_dict as cornell_j)
    from mitsuba2_tpu.python.xml import dict_to_xml as xml_j
    from tests.test_instancing import _scene_dict
    assert dict_to_xml(cornell_t(32, 24, 8, 5)) \
        == xml_j(cornell_j(32, 24, 8, 5))
    f = obj_j(40, 20)
    mine = dict_to_xml(instanced_spheres_dict(3, False, filename=f))
    assert mine == xml_j(instanced_spheres_dict(3, False, T=TJ, filename=f))
    assert mine == xml_j(_scene_dict(3, materialize=False))
    bsdf = {"type": "roughplastic", "alpha": 0.3, "nonlinear": True,
            "diffuse_reflectance": {"type": "rgb", "value": [0.2, 0.4, 0.6]},
            "int_ior": {"type": "spectrum", "value": 1.5}}
    assert dict_to_xml(dict(bsdf)) == xml_j(dict(bsdf))


def test_xml_cornell_matches_jax_kernel_per_pixel():
    """The XML Cornell box at 16^2 x 4 spp through both packages'
    ``load_file``: the port's path kernel (its plain version here) per
    pixel against the JAX path kernel (Pallas interpret mode)."""
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    path = cornell_xml_path(16, 16, 4, 4)
    sj = mj.load_file(path)
    sj.integrator._force_megakernel = True
    ref = np.asarray(sj.integrator.render(sj, seed=5, spp=4))
    assert sj.integrator.last_engine == "megakernel"
    st = mt.load_file(path)
    img = st.integrator.render(st, seed=5, spp=4)
    assert st.integrator.last_engine == "kernel"
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert_images_agree(img.numpy(), ref)


def test_top_level_signatures_match_the_jax_package():
    import inspect

    import mitsuba2_tpu as mj
    from mitsuba2_tpu.core import xmlio as xj
    from mitsuba2_tpu_torch.core import xmlio as xt
    assert {"load_file", "load_string"} <= set(mt.__all__)
    for name in ("load_file", "load_string"):
        assert inspect.signature(getattr(mt, name)) \
            == inspect.signature(getattr(mj, name))
        assert inspect.signature(getattr(xt, name)) \
            == inspect.signature(getattr(xj, name))
