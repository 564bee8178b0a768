"""Differentiable rendering of the port (python/autodiff.py) against the JAX
package's (mitsuba2_tpu/python/autodiff.py), at the same values and seeds.

The JAX values carry across by key (``carry``): each port parameter is
written from ``np.asarray`` of the JAX one and ``update()``d, so both
packages render the same scene values. Each JAX gradient is computed once
in this file, in the module fixture ``jax_runs``, at 8^2 x 4 spp and depth
3 (a JAX ``render_loss`` compiles for seconds; tests/test_autodiff.py is
slow-tier for that reason).

Tolerances: images per pixel within 1e-5 (both packages draw the same
streams and the wavefronts agree to float rounding), gradients within
1e-4 of their largest component, optimizer trajectories within 1e-6. The
port's own checks (the furnace's analytic 1/3, finite gradients, the pass
split) need no JAX.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.autodiff import (SGD, Adam, render,
                                                render_loss, render_loss_rb)
from mitsuba2_tpu_torch.python.test import scenes as st
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

W, SPP, DEPTH = 8, 4, 3
LEFT = "left.bsdf.reflectance.value"
LIGHT = "light.emitter.radiance.value"
PLANE = "shape_0.bsdf.reflectance.value"
TEXELS = "shape_0.bsdf.reflectance.data"


def carry(pj, pt):
    """Write every JAX parameter value into the port's map, by key."""
    for k in pt.keys():
        pt[k] = torch.tensor(np.asarray(pj[k], np.float32))
    pt.update()


def bitmap_plane_dict(pkg):
    """tests/test_autodiff.py's bitmap scene: a plane under a white
    environment, seen from above, on ``pkg``'s Transform."""
    T = pkg.Transform
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": T.look_at([0, 2, 0.01], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": W, "height": W,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": SPP}},
        "plane": {"type": "rectangle", "to_world": T.rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse", "reflectance": 0.5}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
    }


def texels():
    return np.random.default_rng(5).uniform(0.2, 0.8, (4, 4, 3)) \
        .astype(np.float32)


def l2(lib):
    return lambda im: lib.mean((im - 0.1) ** 2)


def scenes(name):
    """(JAX scene, its ParameterMap kept to the case's keys, port scene,
    port map with the JAX values carried) of a case."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test import scenes as sj
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    if name == "furnace":
        dj = sj.furnace_dict(albedo=0.5, width=W, height=W, spp=SPP,
                             max_depth=DEPTH)
        dt = st.furnace_dict(albedo=0.5, width=W, height=W, spp=SPP,
                             max_depth=DEPTH)
        keys = [PLANE]
    elif name == "cornell":
        dj = sj.cornell_box_dict(W, W, SPP, DEPTH)
        dt = st.cornell_box_dict(W, W, SPP, DEPTH)
        keys = [LEFT, LIGHT]
    else:
        dj, dt = bitmap_plane_dict(mj), bitmap_plane_dict(mt)
        keys = [TEXELS]
    sj_, stt = mj.load_dict(dj), mt.load_dict(dt)
    if name == "bitmap":
        from mitsuba2_tpu.models.textures import BitmapTexture as BJ
        from mitsuba2_tpu_torch.models.textures import BitmapTexture as BT
        sj_.shapes[0].bsdf.reflectance = BJ(data=texels())
        stt.shapes[0].bsdf.reflectance = BT(data=texels())
    pj = mj.traverse(sj_).keep(keys)
    if name == "cornell":
        import jax.numpy as jnp
        pj[LEFT] = jnp.asarray([0.3, 0.6, 0.2], jnp.float32)
        pj.update()
    pt = mt.traverse(stt).keep(keys)
    carry(pj, pt)
    return sj_, pj, stt, pt


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX (loss, grads, image), one ``render_loss`` each."""
    import jax.numpy as jnp
    from mitsuba2_tpu.python.autodiff import render_loss as rl_j
    out = {}
    for name, loss in (("furnace", lambda im: jnp.mean(im)),
                       ("cornell", l2(jnp)), ("bitmap", lambda im:
                                              jnp.mean(im))):
        sj_, pj, _, _ = scenes(name)
        lj, gj, ij = rl_j(sj_, pj, loss, spp=SPP, seed=3)
        out[name] = (float(lj), {k: np.asarray(v) for k, v in gj.items()},
                     np.asarray(ij))
    return out


def assert_grads_agree(g_port, g_ref, rel=1e-4):
    for k, ref in g_ref.items():
        got = g_port[k].detach().cpu().numpy()
        assert got.shape == ref.shape, (k, got.shape, ref.shape)
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["furnace", "cornell"])
def test_gradient_and_image_match_jax(jax_runs, name):
    """The taped gradient and the image of the furnace and of the Cornell
    box (the red wall's albedo and the light's radiance, the wall set
    through the JAX map and carried) equal the JAX package's; the
    render rides the wavefront, whose reason the kernel gate gives."""
    _, _, s, p = scenes(name)
    loss_fn = (lambda im: im.mean()) if name == "furnace" else l2(torch)
    loss, grads, img = render_loss(s, p, loss_fn, spp=SPP, seed=3)
    lj, gj, ij = jax_runs[name]
    np.testing.assert_allclose(img.numpy(), ij, rtol=0, atol=1e-5)
    assert abs(float(loss) - lj) <= 1e-5 * max(abs(lj), 1.0)
    assert_grads_agree(grads, gj)
    assert s.integrator.last_engine == "wavefront"
    if name == "cornell":
        assert s.integrator.engine_reason == \
            "differentiable render (wavefront only)"
        s.integrator.render(s, seed=0, spp=1)
        assert s.integrator.last_engine == "kernel"


def test_bitmap_texel_gradient_matches_jax(jax_runs):
    """Per-texel gradients flow through the bilinear bitmap lookup:
    shape (16, 3), most texels reached, equal to the JAX package's."""
    _, _, s, p = scenes("bitmap")
    _, grads, _ = render_loss(s, p, lambda im: im.mean(), spp=SPP, seed=3)
    g = grads[TEXELS]
    assert g.shape == (16, 3)
    assert (g > 0).sum() > 8
    assert_grads_agree(grads, jax_runs["bitmap"][1])


def furnace(spp=16, albedo=0.5, depth=DEPTH, width=6):
    s = mt.load_dict(st.furnace_dict(albedo=albedo, width=width,
                                     height=width, spp=spp,
                                     max_depth=depth))
    return s, mt.traverse(s).keep([PLANE])


def test_furnace_analytic_gradient():
    """d(mean image)/d(albedo_c) of the directly lit furnace plane is
    env / 3 = 1/3 (tests/test_autodiff.py's bar, 0.07)."""
    s, p = furnace()
    _, grads, _ = render_loss(s, p, lambda im: im.mean(), spp=16, seed=0)
    np.testing.assert_allclose(grads[PLANE].numpy(), 1.0 / 3.0, atol=0.07)


def test_unbiased_mode_is_finite():
    """unbiased=True: value from the seed, gradient from seed + 0x9E37."""
    s, p = furnace(spp=4, albedo=0.4, depth=2, width=4)
    loss, grads, _ = render_loss(s, p, lambda im: im.mean(), spp=4, seed=0,
                                 unbiased=True)
    assert np.isfinite(float(loss))
    assert torch.isfinite(grads[PLANE]).all()
    assert (grads[PLANE] > 0).all()


def graze_dict():
    """The materials box (plastics, glass, a rough plastic, a bitmap, a
    disk and a cylinder) seen along its floor from the open front: lanes
    escape, graze the floor and, with rr_depth 1, die by roulette."""
    d = st.cornell_materials_dict(16, 16, 4, 6, rfilter="box")
    d["integrator"]["rr_depth"] = 1
    d["sensor"]["to_world"] = mt.Transform.look_at(
        [0.0, -0.999, 3.0], [0.0, -0.999, 0.0], [0, 1, 0])
    return d


@pytest.mark.parametrize("adjoint", ["taped", "rb"])
def test_gradients_finite_where_lanes_escape_die_and_graze(adjoint):
    """Every parameter's gradient (all but the vertex arrays: albedos,
    texels, IORs, roughness, radiance, fov) stays finite over four seeds
    on a scene whose lanes escape, die by roulette and graze."""
    s = mt.load_dict(graze_dict())
    p = mt.traverse(s)
    p.keep([k for k in p.keys() if "vertex" not in k])
    step = render_loss if adjoint == "taped" else render_loss_rb
    for seed in range(4):
        _, grads, _ = step(s, p, l2(torch), spp=4, seed=seed)
        bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
        assert not bad, (seed, bad)
    assert any(bool(g.abs().sum() > 0) for g in grads.values())


def test_pass_split_changes_no_lane():
    """One pass of every sample against passes of one and of two: each
    lane is keyed by its pixel and sample index, so the image and the
    gradient agree to the rounding of the sums' order."""
    s = mt.load_dict(st.cornell_box_dict(W, W, 4, DEPTH))
    p = mt.traverse(s).keep([LEFT, LIGHT])
    runs = [render_loss(s, p, l2(torch), spp=4, seed=1, spp_per_pass=k)
            for k in (4, 2, 1)]
    for _, g, img in runs[1:]:
        np.testing.assert_allclose(img.numpy(), runs[0][2].numpy(),
                                   rtol=1e-6, atol=1e-7)
        for k in (LEFT, LIGHT):
            np.testing.assert_allclose(g[k].numpy(), runs[0][1][k].numpy(),
                                       rtol=1e-5, atol=1e-9)


def test_volpath_render_rides_its_wavefront():
    """A differentiable render of the volpath slab (inside K3's scope)
    refuses the kernel and says so, and the gradient of its light's
    radiance is positive."""
    key = "shape_1.emitter.radiance.value"
    s = mt.load_dict(st.volpath_slab_dict(W, W, 2, DEPTH))
    p = mt.traverse(s).keep([key])
    _, grads, _ = render_loss(s, p, lambda im: im.mean(), spp=2, seed=0)
    assert s.integrator.last_engine == "wavefront"
    assert s.integrator.engine_reason == \
        "differentiable render (wavefront only)"
    assert (grads[key] > 0).all()


def test_render_raises_where_no_wavefront_renders():
    """No fallback: a scene neither the kernel nor the wavefront takes
    raises NotImplementedError with the gate's words, and the bound
    values are back in the scene afterwards."""
    from mitsuba2_tpu_torch.render.sensor import Sensor
    s, p = furnace(spp=1, width=4)
    # a camera of a class that gives no rays
    s.sensors[0].__class__ = type("NoRays", (Sensor,), {})
    with pytest.raises(NotImplementedError, match="has no sample_ray"):
        render_loss(s, p, lambda im: im.mean(), spp=1)
    assert not p[PLANE].requires_grad
    np.testing.assert_array_equal(
        s.shapes[0].bsdf.reflectance.rgb, np.full(3, 0.5, np.float32))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_trajectories_match_jax(opt):
    """SGD with momentum and Adam fed the same gradients for five steps
    walk the JAX optimizers' trajectory within 1e-6."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python import autodiff as aj
    from mitsuba2_tpu.python.test import scenes as sj
    mj.set_variant("scalar_rgb")
    sjx = mj.load_dict(sj.furnace_dict(width=4, height=4, spp=1,
                                       max_depth=2))
    pj = mj.traverse(sjx).keep([PLANE])
    s, pt = furnace(spp=1, width=4)
    carry(pj, pt)
    if opt == "sgd":
        oj, ot = aj.SGD(pj, lr=0.3, momentum=0.9), SGD(pt, lr=0.3,
                                                       momentum=0.9)
    else:
        oj, ot = aj.Adam(pj, lr=0.05), Adam(pt, lr=0.05)
    rng = np.random.default_rng(7)
    for _ in range(5):
        g = rng.normal(size=3).astype(np.float32)
        oj.step({PLANE: jnp.asarray(g)})
        ot.step({PLANE: torch.as_tensor(g)})
        np.testing.assert_allclose(pt[PLANE].numpy(), np.asarray(pj[PLANE]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.shapes[0].bsdf.reflectance.rgb,
                               np.asarray(pj[PLANE]), rtol=0, atol=1e-6)


def assert_card_matches_cpu(step):
    """``step`` (render_loss or render_loss_rb) on the Cornell box's red
    wall and light on the card (K2 there, its plain twin here) against
    the CPU at 32^2 x 4, within 1e-3 of the largest component: the two
    sum in different orders (chip_smoke.py holds the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = {}
    for dev in ("cpu", "cuda"):
        mt.set_device(dev)
        try:
            s = mt.load_dict(st.cornell_box_dict(32, 32, 4, 6))
            p = mt.traverse(s).keep([LEFT, LIGHT])
            out[dev] = step(s, p, l2(torch), spp=4, seed=2)[1]
        finally:
            mt.set_device("cpu")
    for k in (LEFT, LIGHT):
        ref = out["cpu"][k].numpy()
        np.testing.assert_allclose(out["cuda"][k].cpu().numpy(), ref,
                                   rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.cuda
def test_cuda_gradient_matches_cpu():
    assert_card_matches_cpu(render_loss)
