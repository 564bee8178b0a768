"""Scene parameters of the port (core/object.py, python/util.py
``traverse``/``ParameterMap``) against the JAX package's, and their write
path into the kernels' tables.

Keys and value shapes equal the JAX package's on the six fixture scenes.
After ``params.update()`` a kernel render (the path kernel's plain version
on the CPU, K1a's on the card; K3's for the volpath slab) is bit for bit
the render of a scene loaded fresh with the new value: the scene re-packs
its tables and each integrator's kernel object keys on the parameter
epoch (the JAX package renders the old tables there; ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.autodiff import render_loss
from mitsuba2_tpu_torch.python.test import scenes as st
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

W = 8
FIXTURES = ["cornell_box_dict", "matpreview_dict", "cornell_materials_dict",
            "volpath_slab_dict", "cornell_surfaces_dict",
            "cornell_lights_dict"]
LEFT = "left.bsdf.reflectance.value"
LIGHT = "light.emitter.radiance.value"


def dicts(name):
    """The fixture ``name`` as a JAX dict and as a port dict."""
    from mitsuba2_tpu.python.test import scenes as sj
    import mitsuba2_tpu as mj
    if name == "volpath_slab_dict":
        from tests.test_torch_volpath import jax_slab_dict
        return jax_slab_dict(W, W, 4, 3), st.volpath_slab_dict(W, W, 4, 3)
    if name in ("cornell_box_dict", "matpreview_dict"):
        return (getattr(sj, name)(W, W, 4, 3), getattr(st, name)(W, W, 4, 3))
    make = getattr(st, name)
    return (make(W, W, 4, 3, base=sj.cornell_box_dict(W, W, 4, 3),
                 T=mj.Transform), make(W, W, 4, 3))


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral",
                                     "scalar_mono"])
@pytest.mark.parametrize("name", FIXTURES)
def test_keys_and_shapes_match_jax(name, variant):
    """``mi.traverse`` gives the JAX package's keys and value shapes; the
    values are float32 tensors on the scene's device. The volpath slab's
    medium, which the scene does not reach (shapes give their BSDF and
    emitter), is traversed on its own."""
    import mitsuba2_tpu as mj
    mj.set_variant(variant)
    mt.set_variant(variant)
    dj, dt = dicts(name)
    sj_, s = mj.load_dict(dj), mt.load_dict(dt)
    roots = [(sj_, s)]
    if name == "volpath_slab_dict":
        roots.append((sj_.media[0], s.media[0]))
    for rj, rt in roots:
        pj, pt = mj.traverse(rj), mt.traverse(rt)
        assert {k: tuple(np.shape(v)) for k, v in pj.items()} == \
            {k: tuple(v.shape) for k, v in pt.items()}
        assert all(v.dtype == torch.float32 and v.device == s.device
                   for _, v in pt.items())


def cornell(**kw):
    mt.set_variant("scalar_rgb")
    return mt.load_dict(st.cornell_box_dict(W, W, 4, 3, **kw))


def test_update_round_trip():
    """A written value reaches the plugin and reads back; the map's
    values never alias the plugin's host arrays."""
    s = cornell()
    p = mt.traverse(s)
    old = p[LEFT].clone()
    p[LEFT] = torch.tensor([0.9, 0.1, 0.1])
    p.update()
    np.testing.assert_array_equal(p[LEFT].numpy(), np.float32([0.9, 0.1, 0.1]))
    tex = s.shapes[3].bsdf.reflectance
    assert isinstance(tex.rgb, np.ndarray)
    np.testing.assert_array_equal(tex.rgb, np.float32([0.9, 0.1, 0.1]))
    p[LEFT] = old
    p.update()
    np.testing.assert_array_equal(tex.rgb, old.numpy())
    p[LEFT][0] = 0.0                 # the map's own copy
    assert tex.rgb[0] == old[0]


def test_keep_raises_on_a_missing_key():
    p = mt.traverse(cornell())
    with pytest.raises(KeyError, match="no.such.key"):
        p.keep([LEFT, "no.such.key"])
    assert len(p) > 2                # left as it was
    assert list(p.keep(LEFT).keys()) == [LEFT]


def test_bind_restores_after_an_exception():
    """``bind`` installs tensors that require grad for its body and puts
    the old values back when the body raises."""
    s = cornell()
    p = mt.traverse(s).keep([LEFT, LIGHT])
    tex = s.shapes[3].bsdf.reflectance
    before = tex.rgb.copy()
    traced = torch.tensor([0.2, 0.3, 0.4], requires_grad=True)
    with pytest.raises(RuntimeError, match="inside"):
        with p.bind({LEFT: traced}):
            assert tex.rgb is traced
            raise RuntimeError("inside")
    assert isinstance(tex.rgb, np.ndarray)
    np.testing.assert_array_equal(tex.rgb, before)


def kernel_image(s):
    img = s.integrator.render(s, seed=1, spp=2)
    assert s.integrator.last_engine == "kernel"
    return img


CASES = {
    # (fixture and its edit, the root of the map, key, new value)
    "albedo": (lambda new=None: st.cornell_box_dict(W, W, 2, 3) if new is None
               else _edit(st.cornell_box_dict(W, W, 2, 3), "left", new),
               lambda s: s, LEFT, [0.2, 0.5, 0.7]),
    "radiance": (lambda new=None: st.cornell_box_dict(W, W, 2, 3)
                 if new is None else _light(st.cornell_box_dict(W, W, 2, 3),
                                            new),
                 lambda s: s, LIGHT, [5.0, 6.0, 7.0]),
    "plastic": (lambda new=None: st.cornell_materials_dict(W, W, 2, 3)
                if new is None else _plastic(
                    st.cornell_materials_dict(W, W, 2, 3), new),
                lambda s: s, "floor.bsdf.diffuse_reflectance.value",
                [0.1, 0.7, 0.3]),
    "sigma_t": (lambda new=None: st.volpath_slab_dict(W, W, 2, 3)
                if new is None else st.volpath_slab_dict(
                    W, W, 2, 3, grid=np.asarray(new)[..., 0]),
                lambda s: s.media[0], "sigma_t.data",
                np.random.default_rng(0).uniform(
                    0.3, 3.0, (16, 16, 16, 1)).astype(np.float32)),
}


def _edit(d, shape, rgb):
    d[shape]["bsdf"]["reflectance"]["value"] = rgb
    return d


def _light(d, rgb):
    d["light"]["emitter"]["radiance"]["value"] = rgb
    return d


def _plastic(d, rgb):
    d["floor"]["bsdf"]["diffuse_reflectance"]["value"] = rgb
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_render_after_update_is_a_fresh_loads(case):
    """A kernel render after ``params.update()`` equals, bit for bit, the
    kernel render of the scene loaded with the new value: a wall's albedo
    and the area light's radiance on the path kernel (K1a's plain
    version), the plastic floor's base (its coat's sampling weight
    re-derived through ``parameters_changed``), and the slab's sigma_t
    grid on K3's (its majorant re-derived)."""
    make, root, key, new = CASES[case]
    mt.set_variant("scalar_rgb")
    s = mt.load_dict(make())
    before = kernel_image(s)
    p = mt.traverse(root(s))
    p[key] = torch.as_tensor(np.asarray(new, np.float32))
    p.update()
    after = kernel_image(s)
    fresh = kernel_image(mt.load_dict(make(new)))
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)


def test_gradient_through_srgb_by_variant():
    """A traced srgb value reaches eval in rgb variants only: the spectral
    and mono payloads keep the last concrete value's, so the gradient is
    zero there, as the JAX package's (mitsuba2_tpu/models/
    textures.py:97-110; ROADMAP queue 3)."""
    grads = {}
    for variant in ("scalar_rgb", "scalar_spectral", "scalar_mono"):
        mt.set_variant(variant)
        s = mt.load_dict(st.cornell_box_dict(4, 4, 2, 3))
        p = mt.traverse(s).keep([LEFT])
        grads[variant] = render_loss(s, p, lambda im: im.mean(), spp=2)[1][
            LEFT]
    mt.set_variant("scalar_rgb")
    assert (grads["scalar_rgb"].abs() > 0).any()
    assert (grads["scalar_spectral"] == 0).all()
    assert (grads["scalar_mono"] == 0).all()
