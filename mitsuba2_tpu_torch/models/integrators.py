"""Integrator plugins (reference: src/integrators/path.cpp, volpath.cpp,
volpathmis.cpp).

The path integrator renders every scene inside the path kernel's scope
through that kernel (ops/path_kernel.py) and every other scene through
the general wavefront, ``PathIntegrator.sample``, as the JAX package does
(mitsuba2_tpu/models/integrators.py:43-55); ``last_engine`` says which
ran, ``engine_reason`` keeps the kernel gate's reason. Only the gate's
scope refusal routes to the wavefront: a kernel that fails to build or
launch raises. A scene the wavefront cannot render either raises
``NotImplementedError`` with the missing piece. ``volpath`` and
``volpathmis`` render every scene inside the volumetric kernel's scope
through it (ops/volpath_kernel.py) and raise outside it: their wavefront
is not ported.
"""

from __future__ import annotations

import torch

from ..core import logger as _log
from ..core.object import register_plugin
from ..render.bsdf import BSDFContext, BSDFFlags
from ..render.integrator import MonteCarloIntegrator, mis_weight
from ..render.records import DirectionSample


class _KernelIntegrator(MonteCarloIntegrator):
    """An integrator that renders through one kernel: ``_kernel_for``
    builds the scene's kernel object once per (scene, sensor) when
    ``_ineligibility`` finds no reason against it; otherwise rendering
    raises ``NotImplementedError(engine_reason)``."""

    # a kernel keeps a path's state in registers and writes 12 B per lane,
    # so a whole 256^2 render fits in one pass
    MAX_WAVEFRONT_KERNEL = 1 << 23

    def __init__(self, props=None):
        super().__init__(props)
        self.engine_reason = None
        self.last_engine = None
        self._kernel_cache = None
        # forces a kernel-eligible scene onto the wavefront (the
        # reference's _disable_megakernel, integrators.py:38-39); for tests
        # and chip_smoke.py, not a user option
        self._disable_kernel = False

    def _kernel(self, scene, sensor):
        if self._disable_kernel:
            self.engine_reason = "kernel disabled (_disable_kernel)"
            return None
        return self._kernel_for(scene, sensor)

    def wavefront_cap(self, scene, sensor):
        if self._kernel(scene, sensor) is not None:
            return self.MAX_WAVEFRONT_KERNEL
        return self.MAX_WAVEFRONT

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total):
        mk = self._kernel(scene, sensor)
        if mk is not None:
            self.last_engine = "kernel"
            return mk.render_pass(seed, sample_base, spp_pass)
        reason = self._wavefront_ineligibility(scene, sensor)
        if reason is not None:
            self.last_engine = None
            raise NotImplementedError(
                f"{reason} (the kernel's gate: {self.engine_reason})")
        self.last_engine = "wavefront"
        return super().render_wavefront(scene, sensor, sampler, seed,
                                        sample_base, spp_pass, spp_total)

    def _wavefront_ineligibility(self, scene, sensor):
        """The missing piece that keeps the wavefront from the scene."""
        return f"{type(self).__name__}: its wavefront is not ported"

    def _kernel_for(self, scene, sensor):
        """The scene's kernel object, or None with ``engine_reason`` set."""
        cached = self._kernel_cache
        if cached is not None and cached[0] is scene and cached[1] is sensor:
            return cached[2]
        reason = self._ineligibility(scene, sensor)
        mk = None
        if reason is None:
            mk = self._make_kernel(scene, sensor)
        else:
            _log.Log(_log.Debug, f"{type(self).__name__}: outside the "
                     f"kernel's scope ({reason})")
        self.engine_reason = reason
        self._kernel_cache = (scene, sensor, mk)
        return mk


def _sensor_ineligibility(sensor, box_only=False):
    """The kernels' camera scope: a perspective pinhole and no motion
    blur; with ``box_only`` (the volumetric kernel, as the reference's
    gate at mitsuba2_tpu/models/integrators.py:510-511) a box filter. The
    path kernel splats through any filter (ops/splat.py)."""
    from ..models.rfilters import BoxFilter
    from ..models.sensors import PerspectiveCamera
    if type(sensor) is not PerspectiveCamera:
        return f"sensor {type(sensor).__name__}"
    if box_only and not isinstance(sensor.film.rfilter, BoxFilter):
        return f"rfilter {type(sensor.film.rfilter).__name__}"
    if sensor.shutter_open != sensor.shutter_close:
        return "motion blur (open shutter)"
    return None


@register_plugin("integrator", "path")
class PathIntegrator(_KernelIntegrator):
    """MIS path tracer (path.cpp:92-234), through ops/path_kernel.py."""

    def _ineligibility(self, scene, sensor):
        from ..ops.path_kernel import path_kernel_ineligibility
        if type(self) is not PathIntegrator:
            return "non-path integrator subclass"
        return _sensor_ineligibility(sensor) \
            or path_kernel_ineligibility(scene)

    def _make_kernel(self, scene, sensor):
        from ..ops.path_kernel import PathKernel
        return PathKernel(scene, sensor, self.max_depth, self.rr_depth)

    def _wavefront_ineligibility(self, scene, sensor):
        if type(self) is not PathIntegrator:
            return "non-path integrator subclass"
        return wavefront_ineligibility(scene, sensor)

    def sample(self, scene, sampler, state, ray, wavelengths):
        """Radiance along each camera ray (path.cpp:92-234;
        mitsuba2_tpu/models/integrators.py:101-204): emission at the first
        hit, then per bounce Russian roulette, next-event estimation with
        power-2 MIS against the BSDF's pdf, BSDF sampling and the MIS
        weight of the emitter the new ray hits -> (n, C). The reference's
        while_loop is a Python loop over depth that stops at max_depth or
        when no lane is active: that test reads one value on the host a
        bounce, and the BSDF dispatch's partition reads its lane counts
        (``scene.bsdf_partition``); nothing else in a pass waits for the
        device (core/profiler.py ``HostTransfers`` counts them)."""
        n = ray.o.shape[0]
        ctx = BSDFContext()
        si = scene.ray_intersect(ray, None, wavelengths)
        # emission of the first hit (path.cpp:127-129)
        active = torch.ones((n,), dtype=torch.bool, device=ray.o.device)
        result = scene.eval_emitter(si, ray.d, active)
        throughput = torch.ones_like(result)
        eta = torch.ones_like(si.t)
        active = si.is_valid()
        smooth = int(BSDFFlags.Smooth)
        delta = int(BSDFFlags.Delta)
        depth = 1
        while depth < self.max_depth:
            if not bool(active.any()):
                break
            # Russian roulette (path.cpp:133-141)
            rr_u, state = sampler.next_1d(state)
            if depth > self.rr_depth:
                q = torch.clamp(throughput.amax(-1) * (eta * eta), max=0.95)
                active = active & (rr_u < q)
                throughput = throughput * torch.where(
                    q != 0, 1.0 / torch.where(q != 0, q, 1.0), 0.0)[:, None]
            parts = scene.bsdf_partition(si, active)
            # emitter sampling (path.cpp:152-173)
            active_e = active & ((scene.bsdf_flags_at(si) & smooth) != 0)
            em_sample, state = sampler.next_2d(state)
            ds, emitter_val = scene.sample_emitter_direction(si, em_sample,
                                                             active_e)
            active_e = active_e & (ds.pdf != 0)
            bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(
                ctx, si, si.to_local(ds.d), active_e, parts)
            mis = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            result = result + torch.where(
                active_e[:, None],
                mis[:, None] * throughput * bsdf_val * emitter_val, 0.0)
            # BSDF sampling (path.cpp:177-208)
            b1, state = sampler.next_1d(state)
            b2, state = sampler.next_2d(state)
            bs, bsdf_weight = scene.bsdf_sample(ctx, si, b1, b2, active,
                                                parts)
            throughput = throughput * torch.where(active[:, None],
                                                  bsdf_weight, 1.0)
            active = active & (throughput != 0.0).any(-1)
            eta = torch.where(active, eta * bs.eta, eta)
            new_ray = si.spawn_ray(si.to_world(bs.wo))
            si_next = scene.ray_intersect(new_ray, active, wavelengths)
            # the MIS weight of the emitter the new ray hits
            ds_next = DirectionSample(
                si_next.p, si_next.n, si_next.uv, torch.zeros_like(si.t),
                torch.zeros_like(active), new_ray.d,
                torch.where(si_next.is_valid(), si_next.t, float("inf")),
                scene.emitter_index_at(si_next))
            delta_lobe = (bs.sampled_type & delta) != 0
            emitter_pdf = torch.where(
                (ds_next.emitter_idx >= 0) & ~delta_lobe,
                scene.pdf_emitter_direction(si, ds_next, active), 0.0)
            emitted = scene.eval_emitter(si_next, new_ray.d, active)
            result = result + torch.where(
                active[:, None], mis_weight(bs.pdf, emitter_pdf)[:, None]
                * throughput * emitted, 0.0)
            active = active & si_next.is_valid()
            si = si_next
            depth += 1
        return result


@register_plugin("integrator", "volpath")
class VolumetricPathIntegrator(_KernelIntegrator):
    """Volumetric path tracer (volpath.cpp:92-490 semantics), through
    ops/volpath_kernel.py: delta tracking, NEE with ratio-tracking
    transmittance, emitter hits counted on specular chains only (an
    NEE-only estimator). The gate is the reference's
    (mitsuba2_tpu/models/integrators.py:488-537)."""

    # the reference's pass cap (integrators.py:465)
    MAX_WAVEFRONT_KERNEL = 1 << 22
    # volpathmis: emitter hits on every path, MIS against NEE
    USE_MIS = False

    def _ineligibility(self, scene, sensor):
        from ..ops.volpath_kernel import vol_kernel_ineligibility
        if type(self) not in (VolumetricPathIntegrator,
                              VolumetricMISPathIntegrator):
            return "non-volpath integrator subclass"
        reason = _sensor_ineligibility(sensor, box_only=True)
        if reason is None and self.max_depth >= 64:
            reason = "max_depth >= 64 (static launch unroll)"
        return reason or vol_kernel_ineligibility(scene)

    def _make_kernel(self, scene, sensor):
        from ..ops.volpath_kernel import VolPathKernel
        return VolPathKernel(scene, sensor, self.max_depth, self.rr_depth,
                             mis=self.USE_MIS)


@register_plugin("integrator", "volpathmis")
class VolumetricMISPathIntegrator(VolumetricPathIntegrator):
    """(volpathmis.cpp) volumetric path tracing with power-2 MIS between
    NEE and phase or BSDF sampling; with the kernel's scalar extinction
    the transmittance factors are common to both strategies, so the
    weights are the directional ones."""

    USE_MIS = True


def wavefront_ineligibility(scene, sensor):
    """-> None if the general wavefront renders the scene, else the
    missing piece: another variant than float32 unpolarized, media (the
    volpath wavefront), another sensor than the pinhole, a shape that is
    not a mesh, sphere, disk or cylinder, or a BSDF, emitter or texture
    without the methods the wavefront calls."""
    from ..variants import current
    from ..models.sensors import PerspectiveCamera
    from ..models.shapes import CylinderShape, DiskShape, SphereShape
    var = current()
    if var.polarized:
        return "polarized variant: the wavefront carries no Stokes vectors"
    if var.double_precision:
        return "double-precision variant: the wavefront is float32"
    if scene.has_media:
        return "participating media need the volpath wavefront"
    if type(sensor) is not PerspectiveCamera:
        return f"sensor {type(sensor).__name__}"
    for sh in scene.shapes:
        if not sh.is_mesh() and type(sh) not in (SphereShape, DiskShape,
                                                 CylinderShape):
            return f"non-triangle shape {type(sh).__name__}"
        if not _has(sh.bsdf, "sample", "eval", "pdf"):
            return (f"BSDF {type(sh.bsdf).__name__} has no wavefront "
                    f"sample/eval/pdf")
        reason = _texture_ineligibility(sh.bsdf)
        if reason is not None:
            return reason
    for e in scene.emitters:
        if not _has(e, "eval", "sample_direction", "pdf_direction"):
            return (f"emitter {type(e).__name__} has no wavefront "
                    f"eval/sample_direction/pdf_direction")
        reason = _texture_ineligibility(e)
        if reason is not None:
            return reason
    return None


def _has(obj, *names):
    return all(callable(getattr(obj, n, None)) for n in names)


def _texture_ineligibility(obj):
    """The first texture that ``obj`` holds (a checkerboard's colors in
    turn) without an ``eval``, or None."""
    from ..render.texture import Texture
    for t in vars(obj).values():
        if isinstance(t, Texture):
            if not _has(t, "eval"):
                return f"texture {type(t).__name__} has no wavefront eval"
            reason = _texture_ineligibility(t)
            if reason is not None:
                return reason
    return None
