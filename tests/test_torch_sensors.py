"""The port's sensors (models/sensors.py: perspective, thinlens,
radiancemeter, irradiancemeter) against the JAX package's on the same
samples, their analytic readings, and the thin-lens Cornell box with a
low-discrepancy sampler against the JAX wavefront lane for lane
(tests/test_torch_wavefront.py's bar)."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront import render_pair

_on_cpu = cpu_device_fixture()

RTOL, ATOL = 1e-6, 1e-6
N = 512


def _film(w=8, h=6):
    return {"type": "hdrfilm", "width": w, "height": h,
            "rfilter": {"type": "box"}}


def _sensors(pkg):
    """Each sensor kind as a scene dict of ``pkg`` (the package module)."""
    cam = pkg.Transform.look_at([0.3, 0.2, 3.9], [0, 0, 0], [0, 1, 0])
    return {
        "perspective": {"type": "perspective", "fov": 39.3, "to_world": cam,
                        "film": _film()},
        "thinlens": {"type": "thinlens", "fov": 39.3, "to_world": cam,
                     "aperture_radius": 0.05, "focus_distance": 3.9,
                     "film": _film()},
        "radiancemeter": {"type": "radiancemeter",
                          "origin": [0.1, 0.2, 3.0],
                          "direction": [0.0, -0.1, -1.0],
                          "film": _film(1, 1)},
        "radiancemeter to_world": {"type": "radiancemeter",
                                   "to_world": cam, "film": _film(1, 1)},
        "irradiancemeter": {"type": "sphere", "radius": 0.3,
                            "center": [0.1, 0.0, -0.2],
                            "sensor": {"type": "irradiancemeter",
                                       "film": _film(1, 1)}},
    }


def _scene(pkg, kind):
    d = {"type": "scene", "shape": {"type": "rectangle"}}
    entry = _sensors(pkg)[kind]
    if entry["type"] == "sphere":
        d["shape"] = entry
    else:
        d["sensor"] = entry
    return pkg.load_dict(d)


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
@pytest.mark.parametrize("kind", sorted(_sensors(mt)))
def test_sample_ray_matches_jax(kind, variant):
    """Origin, direction, segment, weight and wavelengths of the rays
    each sensor samples from one set of samples, as the JAX sensor's."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    r = np.random.default_rng(7)
    pos, ap = r.random((N, 2), np.float32), r.random((N, 2), np.float32)
    wav = r.random(N, np.float32)
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        sj, st = _scene(mj, kind).sensors[0], _scene(mt, kind).sensors[0]
        assert type(st).__name__ == type(sj).__name__
        assert st.needs_aperture_sample() == sj.needs_aperture_sample()
        ray_j, w_j = sj.sample_ray(0.0, jnp.asarray(wav), jnp.asarray(pos),
                                   jnp.asarray(ap), True)
        ray_t, w_t, wav_t = st.sample_ray(0.0, torch.as_tensor(wav),
                                          torch.as_tensor(pos),
                                          torch.as_tensor(ap))
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")
    for name in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(ray_t, name).numpy(),
                                   np.asarray(getattr(ray_j, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=ATOL)
    if variant == "scalar_spectral":
        np.testing.assert_allclose(wav_t.numpy(),
                                   np.asarray(ray_j.wavelengths), rtol=RTOL)
    else:
        assert wav_t is None


def test_thinlens_focuses_on_its_focal_plane():
    """Rays of one film position leave the whole aperture and meet at one
    point of the focal plane (tests/test_rfilter_sensor_battery.py's
    thin-lens check)."""
    d = {"type": "scene", "sensor": {
        "type": "thinlens", "aperture_radius": 0.2, "focus_distance": 2.0,
        "to_world": mt.Transform.look_at([0, 0, 2], [0, 0, 0], [0, 1, 0]),
        "film": _film()}}
    sensor = mt.load_dict(d).sensors[0]
    ap = torch.as_tensor(np.random.default_rng(0).random((256, 2),
                                                         np.float32))
    ray, _, _ = sensor.sample_ray(0.0, torch.full((256,), 0.5),
                                  torch.full((256, 2), 0.3), ap)
    o, dd = ray.o.double().numpy(), ray.d.double().numpy()
    assert np.linalg.norm(o - o.mean(0), axis=-1).max() > 0.1
    hit = o + (-o[:, 2] / dd[:, 2])[:, None] * dd
    assert np.abs(hit[:, :2] - hit[:, :2].mean(0)).max() < 1e-4


def test_meter_readings():
    """The radiancemeter in a constant environment of 0.8 reads 0.8; an
    irradiancemeter on a sphere in one of 1 reads pi (the JAX battery's
    readings, tests/test_rfilter_sensor_battery.py:118-152); the scene
    collects the shape's sensor and points it at the sphere's mesh."""
    T = mt.Transform
    film = _film(1, 1)
    env = {"type": "constant", "radiance": {"type": "rgb", "value": 0.8}}
    scene = mt.load_dict({
        "type": "scene", "integrator": {"type": "path", "max_depth": 2},
        "env": env,
        "sensor": {"type": "radiancemeter",
                   "to_world": T.look_at([0, 0, 1], [0, 0, 0], [0, 1, 0]),
                   "film": film,
                   "sampler": {"type": "independent", "sample_count": 16}}})
    img = scene.integrator.render(scene, seed=0, spp=16)
    assert scene.integrator.engine_reason == "sensor RadianceMeter"
    assert abs(float(img.mean()) - 0.8) < 0.02
    env["radiance"]["value"] = 1.0
    scene = mt.load_dict({
        "type": "scene", "integrator": {"type": "path", "max_depth": 2},
        "env": env,
        "sphere": {"type": "sphere", "radius": 0.2, "sensor": {
            "type": "irradiancemeter", "film": film,
            "sampler": {"type": "independent", "sample_count": 256}}}})
    sensor = scene.sensors[0]
    assert type(sensor).__name__ == "IrradianceMeter"
    assert sensor.shape is scene.shapes[0] and sensor.shape.is_mesh()
    img = scene.integrator.render(scene, seed=0, spp=256)
    assert torch.isfinite(img).all()
    assert abs(float(img.mean()) - np.pi) < 0.15


def test_irradiancemeter_without_a_shape_raises():
    sensor = mt.load_dict({"type": "irradiancemeter"})
    with pytest.raises(RuntimeError, match="requires a shape"):
        sensor.sample_ray(0.0, torch.zeros(2), torch.zeros((2, 2)),
                          torch.zeros((2, 2)))


def make_of(fixture, width, spp):
    """make(package) for render_pair: the port's fixture ``fixture``, or
    the same edits on the JAX package's Cornell dict (a mesh loaded
    through the JAX package's ``load_dict``)."""
    def make(pkg):
        f = getattr(scenes_t, fixture)
        if pkg is mt:
            return f(width, width, spp, 6)
        from mitsuba2_tpu.core.transform import Transform as Tj
        from mitsuba2_tpu.python.test.scenes import cornell_box_dict
        base = cornell_box_dict(width=width, height=width, spp=spp,
                                max_depth=6)
        kw = {"load_dict": pkg.load_dict} if "mesh_attribute" in fixture \
            else {}
        return f(base=base, T=Tj, **kw)
    return make


def test_thinlens_ldsampler_matches_jax_wavefront():
    """cornell_thinlens (a thin lens, an ldsampler) lane for lane against
    the JAX wavefront; the path kernel's gate refuses the lens."""
    st, _ = render_pair(make_of("cornell_thinlens_dict", 16, 4),
                        "scalar_rgb", 16, 4, force=False)
    assert st.integrator.engine_reason == "sensor ThinLensCamera"
