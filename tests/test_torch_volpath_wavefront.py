"""The port's volpath wavefront (``VolumetricPathIntegrator.sample`` through
``render_wavefront``) against the JAX volpath wavefront, which is what the
JAX package renders on a CPU, at equal seed: both draw from the same TEA
counter streams in the same dimension order.

Every loop of the wavefront draws for every lane of its pass while any
lane is active, so the streams hang on the trip counts of the main loop
and of each NEE shadow walk: those are compared first, every count equal
(the JAX side's through ``jax_trips``, a counter carried in each
``jax.lax.while_loop`` and read by an ordered debug callback; the port
keeps its own in ``integrator.last_trips``). Then the parity bar of
tests/test_torch_wavefront.py: at least 99% of pixels within 1e-4 relative
and the means within 1e-5, on every pixel that no divergent lane (> 1e-3)
reaches; a divergent lane fails (none parts in these files; a lane
allowed to part would be named in its test and traced in ROADMAP.md
queue 3, as tests/test_torch_wavefront.py does).

The JAX image is the JAX film's splat of the JAX lanes (its drive's own
branch: the box sum, or ``ImageBlock.put``), so that each scene runs the
JAX wavefront once; the port's image is its full ``render``. The JAX
grid volume interpolates grids of up to 1,024 (D * H) rows through a
one-hot matmul, a TPU form whose sums round apart from lerps and flip
null-or-real choices: ``jax_trips`` also patches it to its gather branch
(``Grid3DVolume._FACTORIZED_MAX_ROWS = 0``), whose order (x, then y, then
z) the port's lookup keeps.

This file holds the bench slab under the default (gaussian) film in its
modes; test_torch_volpath_wavefront_scenes.py the other scenes and
test_torch_volpath_wavefront_modules.py the modules, the analytic bars
and the card against the CPU.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront import (assert_coplanar_ties,
                                        assert_wavefront_parity, jax_lanes,
                                        port_lanes)

_on_cpu = cpu_device_fixture()

SEED = 3
# the gaussian film's footprint: 2 pixels around a sample's pixel
GAUSSIAN_BORDER = 2


def slab(pkg, width, spp, max_depth=16, integrator="volpath", box=False,
         medium=None, extra=None):
    """bench.py's volpath slab (a null-BSDF 2x2x2 cube bounding a 16^3
    heterogeneous medium, HG g = 0.3, before an area light of radiance 4)
    on ``pkg``'s Transform, under the default (gaussian) film unless
    ``box``; ``medium(T)`` replaces the slab's medium, ``extra(T)`` adds
    top-level entries."""
    T = pkg.Transform
    grid = np.random.default_rng(0).uniform(
        0.2, 2.0, (16, 16, 16)).astype(np.float32)
    d = {"type": "scene",
         "integrator": {"type": integrator, "max_depth": max_depth},
         "slab": {"type": "cube", "bsdf": {"type": "null"},
                  "interior": ({"type": "heterogeneous",
                                "sigma_t": {"type": "grid3d", "data": grid},
                                "albedo": {"type": "rgb", "value": [0.8] * 3},
                                "to_world": (T.translate([-1, -1, -1])
                                             @ T.scale(2.0)),
                                "phase": {"type": "hg", "g": 0.3}}
                               if medium is None else medium(T))},
         "light": {"type": "rectangle",
                   "to_world": T.translate([0, 0, -2.5]) @ T.scale(2.0),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb",
                                            "value": [4.0] * 3}}},
         "sensor": {"type": "perspective", "fov": 35.0,
                    "to_world": T.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": width,
                             "height": width},
                    "sampler": {"type": "independent",
                                "sample_count": spp}}}
    if box:
        d["sensor"]["film"]["rfilter"] = {"type": "box"}
    if extra is not None:
        d.update(extra(T))
    return d


@pytest.fixture
def jax_trips(monkeypatch):
    """The trip count of every ``jax.lax.while_loop`` the JAX package runs
    while the test runs, in the order the loops end (a list the test
    clears); the JAX grid volume held to its gather branch."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.models.media_impl import Grid3DVolume
    monkeypatch.setattr(Grid3DVolume, "_FACTORIZED_MAX_ROWS", 0)
    trips = []
    loop = jax.lax.while_loop

    def counted(cond, body, carry):
        out, k = loop(lambda c: cond(c[0]),
                      lambda c: (body(c[0]), c[1] + 1),
                      (carry, jnp.int32(0)))
        jax.debug.callback(lambda k: trips.append(int(k)), k, ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    return trips


def jax_image(scene, lanes, spp):
    """The JAX film's image of one pass's lanes, as the JAX drive splats
    them (mitsuba2_tpu/render/integrator.py:221-236) and develops them."""
    import jax.numpy as jnp
    from mitsuba2_tpu.models.rfilters import BoxFilter
    from mitsuba2_tpu.render.film import ImageBlock
    film = scene.sensors[0].film
    w, h = film.crop_size
    pos, rgb = (jnp.asarray(x) for x in lanes)
    block = ImageBlock((w, h), 3, film.rfilter)
    state = block.create()
    if isinstance(film.rfilter, BoxFilter) and block.border == 0:
        vals = jnp.concatenate([rgb, jnp.ones_like(rgb[:, :1])], -1)
        state = state._replace(
            data=vals.reshape(w * h, spp, 4).sum(1).reshape(h, w, 4))
    else:
        state = block.put(state, pos, rgb)
    return np.asarray(block.develop(state))


def volpath_pair(trips, make, variant, spp, reason=None, traced=()):
    """The JAX and port wavefronts on the dicts ``make(package)`` at one
    pass of ``spp``: equal trip counts, then the parity bar, with no lane
    allowed to part but the ``traced`` ones, each at a tie of coplanar
    faces (none parts in this file's scenes); the port's engine is the
    wavefront, with the volumetric kernel's gate's ``reason`` when given
    -> (port scene, port image)."""
    import mitsuba2_tpu as mj
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        sj = mj.load_dict(make(mj))
        trips.clear()
        ref_lanes = jax_lanes(sj, SEED, spp)
        want = list(trips)
        ref = jax_image(sj, ref_lanes, spp)
        st = mt.load_dict(make(mt))
        width = st.sensors[0].film.crop_size[0]
        img = st.integrator.render(st, seed=SEED, spp=spp)
        integ = st.integrator
        assert integ.last_engine == "wavefront"
        if reason is not None:
            assert integ.engine_reason == reason
        assert integ.last_trips == want, (integ.last_trips, want)
        assert img.shape == (width, width, 3) and torch.isfinite(img).all()
        lanes = port_lanes(st, SEED, spp)
        border = 0 if type(st.sensors[0].film.rfilter).__name__ \
            == "BoxFilter" else GAUSSIAN_BORDER
        assert_wavefront_parity(img.numpy(), ref, lanes, ref_lanes, border,
                                traced)
        assert_coplanar_ties(st, sj, traced, spp)
        return st, img
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


@pytest.mark.parametrize("integrator", ["volpath", "volpathmis"])
def test_gaussian_slab_matches_jax_wavefront(jax_trips, integrator):
    """The bench slab under the reference's default film, which the
    volumetric kernel refuses (its gate keeps the reason), at 16^2 x 4,
    depth 16: 37 loops (18 turns of the main loop and 36 walks)."""
    st, _ = volpath_pair(
        jax_trips, lambda pkg: slab(pkg, 16, 4, integrator=integrator),
        "scalar_rgb", 4, reason="rfilter GaussianFilter")
    assert len(st.integrator.last_trips) > 2


def test_spectral_volpathmis_matches_jax_wavefront(jax_trips):
    """The spectral MIS arm (the per-channel ``rho`` products of every
    distance, null and real event and of both walks) at 16^2 x 4, under
    the box film: the kernel's gate refuses the variant."""
    volpath_pair(jax_trips, lambda pkg: slab(pkg, 16, 4, box=True,
                                             integrator="volpathmis"),
                 "scalar_spectral", 4, reason="non-rgb variant")


def test_mono_volpath_matches_jax_wavefront(jax_trips):
    volpath_pair(jax_trips, lambda pkg: slab(pkg, 16, 4, box=True),
                 "scalar_mono", 4, reason="non-rgb variant")
