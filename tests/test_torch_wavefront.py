"""The port's general wavefront (``PathIntegrator.sample`` through
``render_wavefront``) against the JAX wavefront, which is what the JAX
package renders on a CPU, at equal seed: both draw from the same TEA
counter streams in the same dimension order, so they match per lane.

The parity bar: at least 99% of pixels within 1e-4 relative (1e-6
absolute) and the image means within 1e-5 relative. Each render is also
held lane by lane (``jax_lanes`` against ``wavefront_lanes``). K2's Woop
test and the JAX CPU path's Moller-Trumbore place a hit up to ~1e-5
apart and order coplanar faces by that, and the two packages' camera
rays may differ by an ulp: a lane whose path then takes another branch
(the floor and the glass box's base, in the materials box) or whose
grazing hit on matpreview's sphere and rough bounces pull the difference
apart departs by more than 1e-3. Each such lane is named in the test
that meets it, traced to its cause in ROADMAP.md queue 3; any other lane
that departs fails, and the bar is held on every pixel that the named
lanes do not reach.
The Beckmann visible-normal solve is chaotic in the reference itself:
its own image moves as far when its input moves by one ulp, and the
port is held to that (``test_matpreview_beckmann_matches_jax_wavefront``).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import (
    cornell_box_dict as cornell_t, matpreview_dict as matpreview_t)
from mitsuba2_tpu_torch.ops import path_kernel as pk
from tests.test_torch_path_kernel import cpu_device_fixture, pixel_errors

_on_cpu = cpu_device_fixture()


def one_thread_fixture():
    """A module-scoped autouse fixture that runs the module's torch ops on
    one CPU thread (restored afterwards): the test workers share the
    machine's cores, and the renders here are too small for torch's
    threads to pay (each op below torch's grain size runs on one thread
    anyway, so no sum changes its order)."""
    @pytest.fixture(scope="module", autouse=True)
    def _one_thread():
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(prev)
    return _one_thread


_one_thread = one_thread_fixture()

PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-4, 0.99, 1e-5
# a lane that took another branch than the reference's, or whose hit
# points a chain of grazing bounces pulled apart, departs by more than
# this (rounding alone moves a lane by ~1e-5 to 3e-4)
DIVERGED = 1e-3
SEED = 3


def _jax_pass(scene, spp):
    """The JAX wavefront's one pass of ``scene`` (its render_wavefront up
    to the splat, mitsuba2_tpu/render/integrator.py:176-219) as a function
    of the seed -> (film positions (n, 2), rgb and the integrator's AOVs
    (n, 3 + AOVs))."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core import spectrum as spec_j
    from mitsuba2_tpu.variants import current
    sensor = scene.sensors[0]
    sampler = sensor.sampler
    w, h = sensor.film.crop_size
    n = w * h * spp
    var = current()

    def run(seed):
        lane = jnp.arange(n, dtype=jnp.uint32)
        pixel_id = lane // jnp.uint32(spp)
        state = sampler.seed(seed, pixel_id, lane % jnp.uint32(spp))
        jitter, state = sampler.next_2d(state)
        pos_px = jnp.stack([(pixel_id % jnp.uint32(w)).astype(jnp.float32),
                            (pixel_id // jnp.uint32(w)).astype(jnp.float32)],
                           -1) + jitter
        pos01 = pos_px / jnp.asarray([w, h], jnp.float32)
        ap, state = sampler.next_2d(state)
        time, state = sampler.next_1d(state)
        wav, state = sampler.next_1d(state)
        time = sensor.shutter_open + time * (sensor.shutter_close
                                             - sensor.shutter_open)
        ray, weight = sensor.sample_ray(time, wav, pos01, ap, True)
        spec, _, aovs = scene.integrator.sample(scene, sampler, state, ray)

        def to_rgb(s):
            if var.is_spectral:
                return spec_j.spectrum_to_srgb_rows(s.T,
                                                    ray.wavelengths.T).T
            if var.is_monochromatic:
                return jnp.repeat(s, 3, axis=-1)
            return s

        spec = to_rgb(spec * weight)
        if aovs and getattr(scene.integrator, "SPECTRAL_AOVS", False):
            # spectra on the radiance's scale (the Stokes components),
            # integrator.py:210-217
            aovs = [c for a in aovs for c in to_rgb(a * weight).T]
        if aovs:
            spec = jnp.concatenate([spec] + [a[..., None] for a in aovs],
                                   -1)
        return pos_px, spec
    return run


def jax_lanes(scene, seed, spp):
    """The JAX wavefront's lanes of one pass of ``scene`` -> (film
    positions (n, 2), rgb (n, 3)) as numpy."""
    import jax
    import jax.numpy as jnp
    pos, rgb = jax.jit(_jax_pass(scene, spp))(jnp.uint32(seed))
    return np.asarray(pos), np.asarray(rgb)


def jax_lane_trace(scene, seed, spp, lanes):
    """Each of ``lanes``' closest hits in one pass of the JAX wavefront,
    call by call, as ``wavefront_spread.lane_trace`` records the port's
    -> {lane: [(o, d, t, prim), ...]} as numpy."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.render.scene import Scene as SceneJ
    order = sorted(int(k) for k in lanes)
    idx = jnp.asarray(order)
    calls = []
    query = SceneJ.ray_intersect_preliminary

    def recording(self, ray, active=None):
        pi = query(self, ray, active)
        jax.debug.callback(
            lambda *rows: calls.append([np.asarray(r, np.float64)
                                        for r in rows]),
            ray.o[idx], ray.d[idx], pi.t[idx], pi.prim_idx[idx],
            ordered=True)
        return pi

    SceneJ.ray_intersect_preliminary = recording
    try:
        jax.block_until_ready(jax.jit(_jax_pass(scene, spp))(
            jnp.uint32(seed)))
        jax.effects_barrier()
    finally:
        SceneJ.ray_intersect_preliminary = query
    return {k: [tuple(r[j] for r in rows) for rows in calls]
            for j, k in enumerate(order)}


def assert_coplanar_ties(port_scene, jax_scene, lanes, spp):
    """Each of ``lanes`` parts from the JAX lane where the two packages'
    intersectors (K2's Woop test, the JAX CPU path's Moller-Trumbore)
    break a tie between two coplanar faces hit at one point, and at no
    earlier call (both traces recorded call by call)."""
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    if not lanes:
        return
    ours = ws.lane_trace(port_scene, SEED, spp, lanes)
    ref = jax_lane_trace(jax_scene, SEED, spp, lanes)
    for k in lanes:
        assert ws.tie_parting(port_scene, ours[k], ref[k]) is not None, \
            (k, ws.first_parting(ours[k], ref[k]))


def port_lanes(scene, seed, spp):
    sensor = scene.sensors[0]
    pos, rgb = scene.integrator.wavefront_lanes(scene, sensor,
                                                sensor.sampler, seed, 0, spp)
    return pos.numpy(), rgb.numpy()


def lane_errors(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


def assert_wavefront_parity(img, ref, lanes, ref_lanes, border, traced):
    """The parity bar on every pixel that no divergent lane reaches (the
    lane's pixel and ``border`` pixels around it, the film filter's
    footprint), no divergent lane but the ``traced`` ones, the lanes' film
    positions equal."""
    np.testing.assert_allclose(lanes[0], ref_lanes[0], rtol=0, atol=1e-5)
    err_l = lane_errors(lanes[1], ref_lanes[1])
    divergent = err_l > DIVERGED
    untraced = sorted(set(np.flatnonzero(divergent).tolist()) - set(traced))
    assert not untraced, (untraced, err_l[untraced])
    h, w = ref.shape[:2]
    reached = np.zeros((h, w), bool)
    for x, y in np.floor(lanes[0][divergent]).astype(int):
        reached[max(y - border, 0):y + border + 1,
                max(x - border, 0):x + border + 1] = True
    keep = ~reached
    assert keep.mean() >= 0.5, keep.mean()
    err = pixel_errors(img, ref)[keep]
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)
    a, b = img[keep].mean(), ref[keep].mean()
    assert abs(a - b) <= MEAN_RTOL * abs(b), (a, b)


def render_pair(make, variant, width, spp, force=True, border=0, traced=()):
    """JAX and port images and lanes of the dicts ``make(package)``, held
    to the parity bar with the divergent lanes ``traced``; the port forced
    onto the wavefront (``_disable_kernel``) when ``force``."""
    import mitsuba2_tpu as mj
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        sj = mj.load_dict(make(mj))
        ref = np.asarray(sj.integrator.render(sj, seed=SEED, spp=spp))
        # the JAX integrators but path and volpath have no other engine
        assert getattr(sj.integrator, "last_engine",
                       "wavefront") == "wavefront"
        st = mt.load_dict(make(mt))
        st.integrator._disable_kernel = force
        img = st.integrator.render(st, seed=SEED, spp=spp)
        assert st.integrator.last_engine == "wavefront"
        channels = 3 + len(st.integrator.aov_names())
        assert img.shape == (width, width, channels) \
            and torch.isfinite(img).all()
        assert_wavefront_parity(img.numpy(), ref, port_lanes(st, SEED, spp),
                                jax_lanes(sj, SEED, spp), border, traced)
        return st, img
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def cornell(pkg, width, spp, edit=None):
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
    make = cornell_t if pkg is mt else cornell_j
    d = make(width=width, height=width, spp=spp, max_depth=6)
    if edit is not None:
        edit(d)
    return d


def matpreview(pkg, width, spp, **hero):
    from mitsuba2_tpu.python.test.scenes import matpreview_dict as mp_j
    d = (matpreview_t if pkg is mt else mp_j)(width, width, spp, 6)
    d["hero"]["bsdf"].update(hero)
    return d


def _edits():
    def rough_plastic(d):
        d["shortbox"]["bsdf"] = {
            "type": "roughplastic", "alpha": 0.2, "sample_visible": False,
            "diffuse_reflectance": {"type": "rgb", "value": [0.2, 0.4, 0.7]}}

    def anisotropic(d):
        d["back"]["bsdf"] = {"type": "roughconductor", "distribution": "ggx",
                             "alpha_u": 0.1, "alpha_v": 0.3}

    def flipped_sphere(d):
        d["ball"] = {"type": "sphere", "radius": 0.2, "flip_normals": True}

    return {"cornell forced": (None, 16, True),
            "roughplastic sample_visible=False": (rough_plastic, 16, False),
            "anisotropic roughconductor": (anisotropic, 16, False),
            "flipped sphere": (flipped_sphere, 12, False)}


@pytest.mark.parametrize("case", sorted(_edits()))
def test_render_matches_jax_wavefront(case):
    edit, width, force = _edits()[case]
    st, _ = render_pair(lambda pkg: cornell(pkg, width, 4, edit),
                        "scalar_rgb", width, 4, force=force)
    reason = st.integrator.engine_reason
    assert reason == ("kernel disabled (_disable_kernel)" if force
                      else pk.path_kernel_ineligibility(st))


def test_matpreview_beckmann_projected_matches_jax_wavefront():
    """Beckmann's density, shadowing (with the Abramowitz-Stegun erf) and
    its full-distribution sampling hold the bar on the matpreview hero.
    Lane 525's camera ray differs by an ulp between the packages and
    grazes the hero sphere, whose small discriminant moves the hit by
    1.4e-6 relative; a rough bounce pulls it apart by 1.7e-3 (ROADMAP.md
    queue 3)."""
    render_pair(lambda pkg: matpreview(pkg, 16, 4, distribution="beckmann",
                                       sample_visible=False),
                "scalar_rgb", 16, 4, force=False, traced=(525,))


def test_matpreview_beckmann_matches_jax_wavefront(monkeypatch):
    """The slice's path at 16^2 x 4: the means at the bar; per pixel, the
    Beckmann visible-normal solve (12 bracketed Newton steps,
    microfacet.py ``_sample_slopes``) does not converge in its steps and
    jumps between bracket midpoints, so an ulp of its input moves a lane's
    normal by up to ~1e-2; XLA's and torch's exp, log and sqrt differ by
    an ulp. The reference's own image, its solve's input moved by one
    ulp, departs from it as far: the port is held to that spread."""
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    from mitsuba2_tpu.render import microfacet as mf_j
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")

    def render_j():
        sj = mj.load_dict(matpreview(mj, 16, 4, distribution="beckmann"))
        return np.asarray(sj.integrator.render(sj, seed=SEED, spp=4))

    ref = render_j()
    st = mt.load_dict(matpreview(mt, 16, 4, distribution="beckmann"))
    img = st.integrator.render(st, seed=SEED, spp=4).numpy()
    assert st.integrator.last_engine == "wavefront"
    assert st.integrator.engine_reason == "unsupported BSDF RoughConductor"
    solve = mf_j.MicrofacetDistribution._sample_slopes
    monkeypatch.setattr(mf_j.MicrofacetDistribution, "_sample_slopes",
                        lambda self, c, s: solve(self, c,
                                                 jnp.nextafter(s, 2.0)))
    moved = render_j()
    err, err_ref = pixel_errors(img, ref), pixel_errors(moved, ref)
    assert (err <= PIX_RTOL).mean() >= min(PIX_SHARE,
                                           (err_ref <= PIX_RTOL).mean()), \
        ((err <= PIX_RTOL).mean(), (err_ref <= PIX_RTOL).mean())
    assert err.max() <= 2.0 * err_ref.max(), (err.max(), err_ref.max())
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


def test_disable_kernel_routes_eligible_scene_to_wavefront():
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(cornell_t(width=4, height=4, spp=2, max_depth=3))
    kernel = st.integrator.render(st, seed=0, spp=2)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    before = pk.path_radiance.launches
    st.integrator._disable_kernel = True
    img = st.integrator.render(st, seed=0, spp=2)
    assert st.integrator.last_engine == "wavefront"
    assert st.integrator.engine_reason == "kernel disabled (_disable_kernel)"
    assert torch.isfinite(img).all() and img.mean() > 0
    assert not torch.equal(img, kernel)      # another stream of numbers
    assert pk.path_radiance.launches == before


def test_kernel_build_failure_raises(monkeypatch):
    """A path kernel that fails to build raises: nothing falls back to the
    wavefront. The kernel's device route is taken with the library's
    compile step stubbed to fail (here the tables are on the CPU, whose plain
    version builds nothing)."""
    from mitsuba2_tpu_torch.ops import build

    def no_compiler(name, defines=None):
        raise RuntimeError(f"nvcc failed on {name}")

    def device_route(tables, *args):
        pk._path_render(pk.library_defines(tables.nc, False))

    monkeypatch.setattr(build, "build", no_compiler)
    monkeypatch.setattr(pk, "path_radiance", device_route)
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(cornell_t(width=4, height=4, spp=1))
    with pytest.raises(RuntimeError, match="nvcc failed on path_kernel"):
        st.integrator.render(st, seed=0, spp=1)
    assert st.integrator.last_engine == "kernel"


def test_wavefront_rays_pass_k2_check(monkeypatch):
    """Every ray the wavefront hands to the scene's ray queries is what
    K2's wrapper takes (ops/intersect_kernel.py ``_check``): contiguous
    float32 (n, 3) and (n,) tensors on the scene's device."""
    from mitsuba2_tpu_torch.ops import intersect_kernel as ik
    from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
    seen = []
    check = ik._check

    def recording(tables, o, d, mint, maxt):
        seen.append(all(x.is_contiguous() and x.dtype == torch.float32
                        and x.device == tables.device
                        for x in (o, d, mint, maxt)))
        return check(tables, o, d, mint, maxt)

    monkeypatch.setattr(ik, "_check", recording)
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(cornell_materials_dict(6, 6, 2, 4))
    st.integrator._disable_kernel = True
    st.integrator.render(st, seed=0, spp=2)
    assert len(seen) >= 6 and all(seen)


@pytest.mark.cuda
def test_cuda_wavefront_matches_cpu():
    """The wavefront on the card against the CPU on the slice's path at
    128^2 x 4 (K2 on the card, its plain twin on the CPU): no more pixels
    beyond the bar than the CPU's own image when its Beckmann solve's
    input moves one ulp up, within three standard deviations of the
    difference of the two counts, and the mean pixel difference within 4
    standard errors (tools/wavefront_spread.py ``spread``: the solve
    scatters lanes; it must not bias them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    mt.set_variant("scalar_rgb")
    card, engine = ws.render(mt, "cuda", 128, 4, SEED)
    assert engine == "wavefront"
    cpu, _ = ws.render(mt, "cpu", 128, 4, SEED)
    moved, _ = ws.render(mt, "cpu", 128, 4, SEED, move_up=True)
    s = ws.spread(card, cpu, moved)
    assert s["ok"], ws.describe(s)


def test_wavefront_host_waits_are_the_designed_ones():
    """A render after the first (which builds the wavefront's tables)
    waits for the device only where the design says (core/profiler.py
    ``HostTransfers``, which sees on the CPU the calls that would wait on
    the card): the depth loop's any-lane-active test and the BSDF
    partition's lane counts, once a bounce each. No copy from the host in
    a pass: every table is on the device once."""
    from mitsuba2_tpu_torch.core.profiler import HostTransfers
    from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
    mt.set_variant("scalar_rgb")
    for d, force in ((matpreview(mt, 8, 2, distribution="beckmann"), False),
                     (cornell_materials_dict(6, 6, 2, 6), True)):
        st = mt.load_dict(d)
        st.integrator._disable_kernel = force
        st.integrator.render(st, seed=0, spp=2)
        with HostTransfers() as host:
            st.integrator.render(st, seed=0, spp=2)
        assert st.integrator.last_engine == "wavefront"
        ops = {}
        for (op, _), n in host.counts.items():
            ops[op] = ops.get(op, 0) + n
        assert set(ops) == {"__bool__", "tolist"}, host.lines()
        # one pass of max_depth 6: at most 5 bounces
        assert ops["tolist"] <= ops["__bool__"] <= ops["tolist"] + 1 <= 6
