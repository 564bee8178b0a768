"""Core layer of the PyTorch port against the JAX package: transforms,
variant names, device selection and the dict loader's plugin graph."""

import threading

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cornell_t
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


def _transforms(T):
    return {
        "translate": T.translate([0.3, -1.0, 2.5]),
        "scale": T.scale([0.25, 0.6, 0.25]),
        "scale_uniform": T.scale(0.23),
        "rotate": T.rotate([0, 1, 0], -18),
        "rotate_oblique": T.rotate([1, 2, 3], 37.5),
        "look_at": T.look_at([0, 0, 3.9], [0, 0, 0], [0, 1, 0]),
        "look_at_oblique": T.look_at([1, 2, 3], [-0.5, 0.2, 0], [0, 0, 1]),
        "composed": (T.translate([-0.35, -0.4, -0.35]) @ T.rotate([0, 1, 0], 20)
                     @ T.scale([0.25, 0.6, 0.25])),
    }


@pytest.mark.parametrize("name", sorted(_transforms(mt.Transform)))
def test_transform_matches_jax(name):
    tj = _transforms(mj.Transform)[name]
    tt = _transforms(mt.Transform)[name]
    assert tt.matrix.dtype == np.float32
    np.testing.assert_allclose(tt.matrix, np.asarray(tj.matrix), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tt.inverse_transpose,
                               np.asarray(tj.inverse_transpose), rtol=0,
                               atol=1e-6)


def test_variant_names_match_jax():
    assert mt.variants() == mj.variants()
    for name in ("scalar_rgb", "gpu_spectral_polarized", "packet_mono_double"):
        assert mt.variant_config(name).name == mj.variant_config(name).name
    with pytest.raises(ValueError):
        mt.set_variant("scalar_cmyk")


def test_set_device_places_scene_tables():
    # the default, as a fresh thread sees it, is the card
    seen = []
    fresh = threading.Thread(target=lambda: seen.append(mt.device()))
    fresh.start()
    fresh.join()
    assert seen == [torch.device("cuda")]
    prev = mt.device()
    try:
        mt.set_device("cpu")
        assert mt.device() == torch.device("cpu")
        scene = mt.load_dict(cornell_t(width=4, height=4, spp=1))
        assert scene.device == torch.device("cpu")
        assert all(t.device == torch.device("cpu")
                   for t in scene.tables.tensors())
        # the device is taken as given, never replaced by another
        mt.set_device("meta")
        scene = mt.load_dict(cornell_t(width=4, height=4, spp=1))
        assert all(t.device.type == "meta" for t in scene.tables.tensors())
    finally:
        mt.set_device(prev)


def test_load_without_device_goes_to_the_card():
    """A load that names no device lands on the card; without one it
    raises and does not carry on on the CPU."""
    out = []

    def load():
        try:
            out.append(mt.load_dict(cornell_t(width=4, height=4, spp=1)))
        except Exception as e:          # noqa: BLE001 - the outcome is data
            out.append(e)

    fresh = threading.Thread(target=load)
    fresh.start()
    fresh.join()
    if torch.cuda.is_available():
        assert out[0].device == torch.device("cuda")
        assert all(t.is_cuda for t in out[0].tables.tensors())
    else:
        assert isinstance(out[0], (RuntimeError, AssertionError)), out[0]


def test_load_dict_plugin_graph_matches_jax(variant_scalar_rgb):
    mt.set_variant("scalar_rgb")
    sj = mj.load_dict(cornell_j(width=8, height=6, spp=4, max_depth=5))
    st = mt.load_dict(cornell_t(width=8, height=6, spp=4, max_depth=5))
    assert len(st.shapes) == len(sj.shapes) == 8
    assert len(st.emitters) == len(sj.emitters) == 1
    assert [s.id for s in st.shapes] == [s.id for s in sj.shapes]
    assert [type(s).__name__ for s in st.shapes] == \
        [type(s).__name__ for s in sj.shapes]
    assert [s.face_count for s in st.shapes] == \
        [s.face_count for s in sj.shapes]
    for a, b in zip(st.shapes, sj.shapes):
        np.testing.assert_allclose(a.vertices, b.vertices, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert type(a.bsdf).__name__ == type(b.bsdf).__name__
        np.testing.assert_array_equal(a.bsdf.reflectance.rgb,
                                      np.asarray(b.bsdf.reflectance.data.rgb))
    assert st.emitters[0].shape.id == sj.emitters[0].shape.id == "light"
    np.testing.assert_array_equal(st.emitters[0].radiance.rgb,
                                  np.asarray(sj.emitters[0].radiance._rgb_np))
    sen_t, sen_j = st.sensors[0], sj.sensors[0]
    assert sen_t.film.crop_size == sen_j.film.crop_size == (8, 6)
    assert sen_t.x_fov == sen_j.x_fov
    assert sen_t.sampler.sample_count == sen_j.sampler.sample_count == 4
    assert type(sen_t.film.rfilter).__name__ == "BoxFilter"
    assert (st.integrator.max_depth, st.integrator.rr_depth) == \
        (sj.integrator.max_depth, sj.integrator.rr_depth) == (5, 5)
    for a, b in zip(st.bbox(), sj.bbox()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_load_dict_rejects_unknown_and_unqueried():
    with pytest.raises(ValueError, match="unknown plugin type"):
        mt.load_dict({"type": "scene", "s": {"type": "teapot"}})
    with pytest.raises(RuntimeError, match="Unreferenced property"):
        mt.load_dict({"type": "rectangle", "colour": 1.0})


def test_mis_weight_matches_jax():
    """render/integrator.py mis_weight, zero pdfs included (0/0 -> 0)."""
    import jax.numpy as jnp
    from mitsuba2_tpu.render.integrator import mis_weight as mis_j
    from mitsuba2_tpu_torch.render.integrator import mis_weight as mis_t
    r = np.random.default_rng(11)
    a, b = r.random((2, 10_000)).astype(np.float32) * 4.0
    a[:50] = 0.0
    b[25:75] = 0.0
    t = mis_t(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    j = np.asarray(mis_j(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert (t[:50] == 0).all() and (t[50:75] == 1).all()
