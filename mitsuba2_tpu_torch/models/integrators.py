"""Integrator plugins (reference: src/integrators/path.cpp, direct.cpp,
depth.cpp, aov.cpp, moment.cpp, stokes.cpp, volpath.cpp, volpathmis.cpp).

The path integrator renders every scene inside the path kernel's scope
through that kernel (ops/path_kernel.py) and every other scene through
the general wavefront, ``PathIntegrator.sample``, as the JAX package does
(mitsuba2_tpu/models/integrators.py:43-55); ``last_engine`` says which
ran, ``engine_reason`` keeps the kernel gate's reason. Only the gate's
scope refusal routes to the wavefront: a kernel that fails to build or
launch raises. A scene the wavefront cannot render either raises
``NotImplementedError`` with the missing piece. ``volpath`` and
``volpathmis`` do the same with the volumetric kernel
(ops/volpath_kernel.py) and their own wavefront,
``VolumetricPathIntegrator.sample`` (mitsuba2_tpu/models/
integrators.py:539-869). ``depth``, ``direct``, ``aov``, ``moment`` and
``stokes`` have no kernel and render through the general wavefront alone
(the JAX package's route for any integrator but ``path``, :74-75).
"""

from __future__ import annotations

import torch

from ..core import logger as _log
from ..core import math as m
from ..core.object import register_plugin
from ..core.ray import Ray
from ..render.bsdf import BSDFContext, BSDFFlags
from ..render.integrator import (MonteCarloIntegrator, SamplingIntegrator,
                                 mis_weight)
from ..render.records import DirectionSample, select


class _KernelIntegrator(MonteCarloIntegrator):
    """An integrator that renders through one kernel: ``_kernel_for``
    builds the scene's kernel object (``_make_kernel``) once per (scene,
    sensor) when ``_ineligibility`` finds no reason against it; otherwise
    the pass goes to the wavefront (``sample``), or raises
    ``NotImplementedError`` with ``_wavefront_ineligibility``'s missing
    piece."""

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
        # set by python/autodiff.py around a differentiable render: the
        # kernels have no autograd, so the pass rides the wavefront
        # (mitsuba2_tpu/models/integrators.py:36-52, :466-485)
        self._differentiable = False

    def _kernel(self, scene, sensor, banded=False):
        """The kernel object of a pass, None for the wavefront. A scene's
        replica on another device (``Scene.replica``, parallel/mesh.py)
        takes its scene's kernel object moved there (``to``); a band of
        film rows (``banded``) only a kernel that renders bands (the path
        kernel's; the volumetric kernel's passes are whole films)."""
        if self._differentiable:
            self.engine_reason = "differentiable render (wavefront only)"
            return None
        if self._disable_kernel:
            self.engine_reason = "kernel disabled (_disable_kernel)"
            return None
        home = getattr(scene, "replica_of", scene)
        mk = self._kernel_for(home, sensor)
        if mk is None or banded and not mk.BANDS:
            return None
        return mk if home is scene else mk.to(scene.device)

    def wavefront_cap(self, scene, sensor, banded=False):
        if self._kernel(scene, sensor, banded) is not None:
            return self.MAX_WAVEFRONT_KERNEL
        return self.MAX_WAVEFRONT

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total, row0=0, n_rows=None):
        mk = self._kernel(scene, sensor, n_rows is not None)
        if mk is not None:
            self.last_engine = "kernel"
            if n_rows is None:
                return mk.render_pass(seed, sample_base, spp_pass)
            return mk.render_pass(seed, sample_base, spp_pass, row0, n_rows)
        reason = self._wavefront_ineligibility(scene, sensor)
        if reason is not None:
            self.last_engine = None
            raise NotImplementedError(
                f"{reason} (the kernel's gate: {self.engine_reason})")
        self.last_engine = "wavefront"
        return super().render_wavefront(scene, sensor, sampler, seed,
                                        sample_base, spp_pass, spp_total,
                                        row0, n_rows)

    def _kernel_for(self, scene, sensor):
        """The scene's kernel object, or None with ``engine_reason`` set;
        cached by scene, sensor and parameter epoch: after a parameter
        write the scene re-packs its tables and the kernel object is built
        anew from them (the JAX package keys its kernel cache on the scene
        and sensor alone, mitsuba2_tpu/models/integrators.py:57-63, and
        renders stale tables after an update; ROADMAP queue 3)."""
        from ..core.object import param_epoch
        cached = self._kernel_cache
        if cached is not None and cached[0] is scene \
                and cached[1] is sensor and cached[2] == param_epoch():
            return cached[3]
        reason = self._ineligibility(scene, sensor)
        mk = None
        if reason is None:
            scene.refresh_tables()
            mk = self._make_kernel(scene, sensor)
        else:
            _log.Log(_log.Debug, f"{type(self).__name__}: outside the "
                     f"kernel's scope ({reason})")
        self.engine_reason = reason
        self._kernel_cache = (scene, sensor, param_epoch(), mk)
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
        device (core/profiler.py ``HostTransfers`` counts them). A
        differentiable render takes at most 32 bounces, the length of the
        JAX package's scan (mitsuba2_tpu/models/integrators.py:192-200)."""
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
        last = self.max_depth if not self._differentiable \
            else min(self.max_depth, 33)
        while depth < last:
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


class _WavefrontIntegrator(SamplingIntegrator):
    """An integrator that only the general wavefront renders: no kernel
    takes it, for the kernels' gates' reason ("non-path integrator
    subclass", ``engine_reason``); a scene the wavefront cannot render
    (``wavefront_ineligibility``, and the nested integrators' own
    refusals) raises ``NotImplementedError`` with the missing piece."""

    def __init__(self, props=None):
        super().__init__(props)
        self.engine_reason = "non-path integrator subclass"
        self.last_engine = None
        self.nested = []
        if props is not None:
            for _, obj in props.objects():
                if getattr(obj, "plugin_category", "") == "integrator":
                    self.nested.append(obj)

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total, row0=0, n_rows=None):
        reason = wavefront_ineligibility(scene, sensor)
        for nested in self.nested:
            check = getattr(nested, "_wavefront_ineligibility", None)
            reason = reason or (check(scene, sensor) if check else None)
        if reason is not None:
            self.last_engine = None
            raise NotImplementedError(
                f"{reason} (the kernel's gate: {self.engine_reason})")
        self.last_engine = "wavefront"
        return super().render_wavefront(scene, sensor, sampler, seed,
                                        sample_base, spp_pass, spp_total,
                                        row0, n_rows)


@register_plugin("integrator", "depth")
class DepthIntegrator(_WavefrontIntegrator):
    """(depth.cpp) the distance to the first hit, 0 on a miss, in every
    channel (mitsuba2_tpu/models/integrators.py:207-216)."""

    def sample(self, scene, sampler, state, ray, wavelengths):
        from ..variants import current
        si = scene.ray_intersect(ray, None, wavelengths)
        depth = torch.where(si.is_valid(), si.t, 0.0)
        return depth[:, None].expand(-1, current().n_channels)


@register_plugin("integrator", "direct")
class DirectIntegrator(_WavefrontIntegrator):
    """(direct.cpp:1-226; mitsuba2_tpu/models/integrators.py:219-305)
    direct illumination: the emission the camera ray hits, then
    ``emitter_samples`` emitter samples and ``bsdf_samples`` BSDF samples
    (both ``shading_samples`` when given), combined with the power-2
    heuristic over the strategies' sample fractions. Shadow rays go
    through ``ray_test`` (K2's any hit), the BSDF samples' rays through
    ``ray_intersect`` (K2's closest hit)."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        if p is not None and p.has_property("shading_samples"):
            self.emitter_samples = self.bsdf_samples = \
                p.int_("shading_samples")
        else:
            self.emitter_samples = p.int_("emitter_samples", 1) if p else 1
            self.bsdf_samples = p.int_("bsdf_samples", 1) if p else 1
        self.weight_em = 1.0 / max(self.emitter_samples, 1)
        self.weight_bsdf = 1.0 / max(self.bsdf_samples, 1)
        self.frac_bsdf = self.bsdf_samples / max(
            self.emitter_samples + self.bsdf_samples, 1)
        self.frac_lum = 1.0 - self.frac_bsdf

    def sample(self, scene, sampler, state, ray, wavelengths):
        n = ray.o.shape[0]
        ctx = BSDFContext()
        si = scene.ray_intersect(ray, None, wavelengths)
        active = torch.ones((n,), dtype=torch.bool, device=ray.o.device)
        result = scene.eval_emitter(si, ray.d, active)
        active = si.is_valid()
        parts = scene.bsdf_partition(si, active)
        smooth = (scene.bsdf_flags_at(si) & int(BSDFFlags.Smooth)) != 0
        for _ in range(self.emitter_samples):
            em_sample, state = sampler.next_2d(state)
            active_e = active & smooth
            ds, emitter_val = scene.sample_emitter_direction(si, em_sample,
                                                             active_e)
            active_e = active_e & (ds.pdf != 0)
            bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(
                ctx, si, si.to_local(ds.d), active_e, parts)
            mis = torch.where(ds.delta, 1.0,
                              mis_weight(ds.pdf * self.frac_lum,
                                         bsdf_pdf * self.frac_bsdf))
            result = result + torch.where(
                active_e[:, None], mis[:, None] * bsdf_val * emitter_val
                * self.weight_em, 0.0)
        for _ in range(self.bsdf_samples):
            b1, state = sampler.next_1d(state)
            b2, state = sampler.next_2d(state)
            bs, bsdf_weight = scene.bsdf_sample(ctx, si, b1, b2, active,
                                                parts)
            active_b = active & (bsdf_weight != 0).any(-1)
            new_ray = si.spawn_ray(si.to_world(bs.wo))
            si_next = scene.ray_intersect(new_ray, active_b, wavelengths)
            emitted = scene.eval_emitter(si_next, new_ray.d, active_b)
            ds = DirectionSample(
                si_next.p, si_next.n, si_next.uv, torch.zeros_like(si.t),
                torch.zeros_like(active), new_ray.d,
                torch.where(si_next.is_valid(), si_next.t, float("inf")),
                scene.emitter_index_at(si_next))
            delta_lobe = (bs.sampled_type & int(BSDFFlags.Delta)) != 0
            emitter_pdf = torch.where(
                (ds.emitter_idx >= 0) & ~delta_lobe,
                scene.pdf_emitter_direction(si, ds, active_b), 0.0)
            mis = torch.where(delta_lobe, 1.0,
                              mis_weight(bs.pdf * self.frac_bsdf,
                                         emitter_pdf * self.frac_lum))
            result = result + torch.where(
                active_b[:, None], mis[:, None] * bsdf_weight * emitted
                * self.weight_bsdf, 0.0)
        return result


@register_plugin("integrator", "aov")
class AOVIntegrator(_WavefrontIntegrator):
    """(aov.cpp; mitsuba2_tpu/models/integrators.py:314-391) arbitrary
    output variables of the first hit, and nested integrators' outputs.
    ``aovs`` lists "name:type" pairs, a type one of ``TYPES``; each
    nested integrator adds its rgb (its first three channels, or its one
    channel three times) and its own AOVs, and the color channels are
    the nested integrators' mean radiance."""

    TYPES = ("depth", "position", "uv", "geo_normal", "sh_normal",
             "dp_du", "dp_dv", "prim_index", "shape_index")
    # channels of each type, three for the rest
    _WIDTH = {"depth": 1, "uv": 2, "prim_index": 1, "shape_index": 1}

    def __init__(self, props=None):
        super().__init__(props)
        self.outputs = []       # (name, type)
        spec = props.string("aovs", "") if props is not None else ""
        for item in (x for x in spec.split(",") if x.strip()):
            name, _, typ = item.partition(":")
            typ = typ.strip()
            if typ not in self.TYPES:
                raise ValueError(f"unknown AOV type {typ!r}; "
                                 f"supported: {self.TYPES}")
            self.outputs.append((name.strip(), typ))

    def aov_names(self):
        names = []
        for name, typ in self.outputs:
            k = self._WIDTH.get(typ, 3)
            names.extend([name] if k == 1
                         else [f"{name}.{c}" for c in "xyz"[:k]])
        for i, nested in enumerate(self.nested):
            names.extend([f"nested_{i}.{c}" for c in "rgb"]
                         + nested.aov_names())
        return names

    def sample(self, scene, sampler, state, ray, wavelengths):
        return self.sample_aovs(scene, sampler, state, ray, wavelengths)[0]

    def sample_aovs(self, scene, sampler, state, ray, wavelengths):
        from ..variants import current
        si = scene.ray_intersect(ray, None, wavelengths)
        fields = {"position": si.p, "uv": si.uv, "geo_normal": si.n,
                  "sh_normal": si.sh_frame.n, "dp_du": si.dp_du,
                  "dp_dv": si.dp_dv}
        aovs = []
        for _, typ in self.outputs:
            if typ == "depth":
                aovs.append(torch.where(si.is_valid(), si.t, 0.0))
            elif typ == "prim_index":
                aovs.append(si.prim_idx.to(si.t.dtype))
            elif typ == "shape_index":
                aovs.append(si.shape_idx.to(si.t.dtype))
            else:
                aovs.extend(fields[typ].unbind(-1))
        result = torch.zeros((ray.o.shape[0], current().n_channels),
                             device=ray.o.device)
        for nested in self.nested:
            r, sub_aovs = nested.sample_aovs(scene, sampler, state, ray,
                                             wavelengths)
            result = result + r
            aovs.extend(r[:, i] for i in range(min(3, r.shape[1])))
            aovs.extend([r[:, 0]] * (3 - r.shape[1]))
            aovs.extend(sub_aovs)
        if self.nested:
            result = result / len(self.nested)
        return result, aovs


@register_plugin("integrator", "moment")
class MomentIntegrator(_WavefrontIntegrator):
    """(moment.cpp; mitsuba2_tpu/models/integrators.py:394-430) the
    nested integrators' mean radiance, and each one's second moment: the
    square of its rgb (its first channel three times unless it has
    three), three AOV channels each."""

    def __init__(self, props=None):
        super().__init__(props)
        if not self.nested:
            raise RuntimeError("moment integrator needs nested integrators")

    def aov_names(self):
        return [f"m2_{i}.{c}" for i in range(len(self.nested))
                for c in "rgb"]

    def sample(self, scene, sampler, state, ray, wavelengths):
        return self.sample_aovs(scene, sampler, state, ray, wavelengths)[0]

    def sample_aovs(self, scene, sampler, state, ray, wavelengths):
        from ..variants import current
        result = torch.zeros((ray.o.shape[0], current().n_channels),
                             device=ray.o.device)
        aovs = []
        for nested in self.nested:
            r = nested.sample(scene, sampler, state, ray, wavelengths)
            result = result + r
            r3 = r if r.shape[1] == 3 else r[:, :1].expand(-1, 3)
            aovs.extend((r3 * r3).unbind(-1))
        return result / len(self.nested), aovs


@register_plugin("integrator", "stokes")
class StokesIntegrator(_WavefrontIntegrator):
    """(stokes.cpp; mitsuba2_tpu/models/integrators.py:1023-1177) the
    full Stokes vector of each camera ray: S0 the image, S1, S2 and S3 its
    AOVs (``S1.r`` ... ``S3.b``), spectra on S0's scale
    (``SPECTRAL_AOVS``). A Mueller path trace in any variant: the
    throughput is (n, C, 4, 4), each BSDF contributes its ``eval_pol`` and
    ``sample_pol`` matrices (a depolarizer unless it polarizes), rotated
    into the canonical bases of the path's directions
    (``mueller.to_world_mueller``). Emission is unpolarized; NEE runs at
    BSDFs with a smooth lobe, emitter hits take power-2 MIS against it,
    and no Russian roulette. ``max_depth`` (6; below 0 means 16) is a
    nested integrator's where one is given. Ray queries go through
    ``ray_intersect`` and ``ray_test`` (K2's entries on the card)."""

    SPECTRAL_AOVS = True

    def __init__(self, props=None):
        super().__init__(props)
        self.max_depth = int(props.int_("max_depth", 6)) if props else 6
        if self.max_depth < 0:
            self.max_depth = 16
        for nested in self.nested:
            self.max_depth = getattr(nested, "max_depth", self.max_depth)

    def aov_names(self):
        return [f"S{i}.{c}" for i in (1, 2, 3) for c in "rgb"]

    def sample(self, scene, sampler, state, ray, wavelengths):
        return self.sample_aovs(scene, sampler, state, ray, wavelengths)[0]

    def sample_aovs(self, scene, sampler, state, ray, wavelengths):
        """-> (S0 (n, C), [S1, S2, S3] (n, C) each). Per bounce the
        draws of the JAX package: ``next_2d`` for NEE, then ``next_1d``
        and ``next_2d`` for the BSDF. The loop and the partition read the
        host as the path wavefront's do. Emission is unpolarized, so a
        matrix meets a Stokes vector through its first column alone."""
        from ..render import mueller as mu
        from ..variants import current
        n, dev = ray.o.shape[0], ray.o.device
        nch = current().n_channels
        ctx = BSDFContext()
        smooth = int(BSDFFlags.Smooth)
        delta_null = int(BSDFFlags.Delta | BSDFFlags.Null)

        def add(stokes, T, L, mask):
            """stokes + T (L, 0, 0, 0) where ``mask``."""
            return stokes + torch.where(mask[:, None, None],
                                        T[..., 0] * L[..., None], 0.0)

        si = scene.ray_intersect(ray, None, wavelengths)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        T = torch.eye(4, device=dev).repeat(n, nch, 1, 1)
        stokes = add(torch.zeros((n, nch, 4), device=dev), T,
                     scene.eval_emitter(si, ray.d, active), active)
        active = si.is_valid()
        depth = 1
        while depth < self.max_depth:
            if not bool(active.any()):
                break
            parts = scene.bsdf_partition(si, active)
            # NEE: a depolarized emitter through the BSDF's matrix
            active_e = active & ((scene.bsdf_flags_at(si) & smooth) != 0)
            em_u, state = sampler.next_2d(state)
            ds, emitter_val = scene.sample_emitter_direction(si, em_u,
                                                             active_e)
            active_e = active_e & (ds.pdf != 0)
            wo = si.to_local(ds.d)
            bsdf_M = mu.to_world_mueller(
                si, scene.bsdf_eval_pol(ctx, si, wo, active_e, parts), -wo,
                si.wi)
            bsdf_pdf = scene.bsdf_pdf(ctx, si, wo, active_e, parts)
            mis = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            col = (T @ bsdf_M[..., :1])[..., 0]
            stokes = stokes + torch.where(
                active_e[:, None, None],
                mis[:, None, None] * (col * emitter_val[..., None]), 0.0)
            # BSDF sampling
            b1, state = sampler.next_1d(state)
            b2, state = sampler.next_2d(state)
            bs, M = scene.bsdf_sample_pol(ctx, si, b1, b2, active, parts)
            M = mu.to_world_mueller(si, M, -bs.wo, si.wi)
            T = torch.where(active[:, None, None, None], T @ M, T)
            active = active & (bs.pdf > 0)
            new_ray = si.spawn_ray(si.to_world(bs.wo))
            si_next = scene.ray_intersect(new_ray, active, wavelengths)
            ds_next = DirectionSample(
                si_next.p, si_next.n, si_next.uv, torch.zeros_like(si.t),
                torch.zeros_like(active), new_ray.d,
                torch.where(si_next.is_valid(), si_next.t, float("inf")),
                scene.emitter_index_at(si_next))
            delta_lobe = (bs.sampled_type & delta_null) != 0
            emitter_pdf = torch.where(
                (ds_next.emitter_idx >= 0) & ~delta_lobe,
                scene.pdf_emitter_direction(si, ds_next, active), 0.0)
            emitted = scene.eval_emitter(si_next, new_ray.d, active) \
                * mis_weight(bs.pdf, emitter_pdf)[:, None]
            stokes = add(stokes, T, emitted, active)
            active = active & si_next.is_valid()
            si = si_next
            depth += 1
        return stokes[..., 0], [stokes[..., k] for k in (1, 2, 3)]


def _index_spectrum(vec, channel):
    """Each lane's ``channel`` (n,) component of vec (n, C)
    (volpath.cpp index_spectrum)."""
    return vec.gather(1, channel.long()[:, None])[:, 0]


@register_plugin("integrator", "volpath")
class VolumetricPathIntegrator(_KernelIntegrator):
    """Volumetric path tracer (volpath.cpp:92-490 semantics): delta
    tracking, NEE with ratio-tracking transmittance, emitter hits counted
    on specular chains only (an NEE-only estimator). Scenes inside the
    volumetric kernel's scope render through it (ops/volpath_kernel.py;
    its gate is the reference's, mitsuba2_tpu/models/integrators.py:
    488-537), every other through the wavefront, ``sample``."""

    # the reference's pass caps (integrators.py:452, :465): the kernel
    # keeps a path in registers; the wavefront's passes stay at the
    # reference's 2^18 lanes, which also fixes its sample streams (every
    # loop draws for the whole pass while any lane of it is active)
    MAX_WAVEFRONT_KERNEL = 1 << 22
    MAX_WAVEFRONT = 1 << 18
    # main-loop turns per unit of depth (bounces plus null collisions)
    NULL_BUDGET = 16
    # volpathmis: emitter hits on every path, MIS against NEE
    USE_MIS = False

    def __init__(self, props=None):
        super().__init__(props)
        # turns of one NEE shadow walk
        self.nee_loop_cap = 64
        # every loop's trip count in the last ``sample`` call, in the
        # order the loops ended: each NEE walk, then the main loop
        self.last_trips = []

    @property
    def max_iters(self):
        """The main loop's cap: bounces plus null collisions."""
        return self.max_depth * self.NULL_BUDGET if self.max_depth < 256 \
            else 1024

    def _ineligibility(self, scene, sensor):
        from ..ops.volpath_kernel import vol_kernel_ineligibility
        reason = self._subclass_ineligibility()
        reason = reason or _sensor_ineligibility(sensor, box_only=True)
        if reason is None and self.max_depth >= 64:
            reason = "max_depth >= 64 (static launch unroll)"
        return reason or vol_kernel_ineligibility(scene)

    def _subclass_ineligibility(self):
        if type(self) not in (VolumetricPathIntegrator,
                              VolumetricMISPathIntegrator):
            return "non-volpath integrator subclass"
        return None

    def _make_kernel(self, scene, sensor):
        from ..ops.volpath_kernel import VolPathKernel
        return VolPathKernel(scene, sensor, self.max_depth, self.rr_depth,
                             mis=self.USE_MIS)

    def _wavefront_ineligibility(self, scene, sensor):
        return self._subclass_ineligibility() \
            or wavefront_ineligibility(scene, sensor) \
            or _media_ineligibility(scene)

    def sample(self, scene, sampler, state, ray, wavelengths):
        """Radiance along each camera ray (volpath.cpp:92-490;
        mitsuba2_tpu/models/integrators.py:539-869) -> (n, C). A hero
        channel per lane drives distance sampling; each turn of the loop
        samples a collision in the lane's medium, re-intersects the lanes
        whose ray changed, takes a null collision straight through or a
        real one with phase NEE and phase sampling, and at a surface adds
        emission, surface NEE and BSDF sampling, follows the medium
        transition and plays Russian roulette. ``volpathmis`` weighs
        emitter hits against NEE, and in spectral variants carries the
        per-channel pdf ratios ``rho`` (the reference's ``smis`` arm).

        The loop turns while any lane is active, up to ``max_iters``
        turns, and every turn draws for every lane, so the
        streams hang on the pass's trip counts: the loop reads its test
        on the host each turn, as the NEE walks do, the BSDF partition
        reads its lane counts (``scene.bsdf_partition``), and the trip
        counts are kept in ``last_trips``."""
        from ..variants import current
        n, dev = ray.o.shape[0], ray.o.device
        var = current()
        nch = var.n_channels
        ctx = BSDFContext()
        self.last_trips = []
        ch_u, state = sampler.next_1d(state)
        channel = torch.clamp((ch_u * nch).to(torch.int32), max=nch - 1)
        smis = self.USE_MIS and nch > 1 and var.is_spectral
        si = scene.ray_intersect(ray, None, wavelengths)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        needs_isect = torch.zeros_like(active)
        throughput = torch.ones((n, nch), device=dev)
        result = torch.zeros((n, nch), device=dev)
        medium_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
        specular_chain = active.clone()
        depth = torch.zeros((n,), dtype=torch.int32, device=dev)
        prev_pdf = torch.zeros((n,), device=dev)
        prev_p = ray.o
        prev_delta = active.clone()          # camera rays count as delta
        rho_dir = rho_nee = torch.ones((n, nch if smis else 1), device=dev)
        ray_o, ray_d = ray.o, ray.d
        zero = torch.zeros((n,), device=dev)
        inf = torch.full((n,), float("inf"), device=dev)
        smooth, null = int(BSDFFlags.Smooth), int(BSDFFlags.Null)
        delta = int(BSDFFlags.Delta)

        def where(mask, a, b):
            return torch.where(mask[:, None], a, b)

        it = 0
        while it < self.max_iters and bool(active.any()):
            ray_it = Ray(ray_o.contiguous(), ray_d.contiguous(), zero, inf)
            active_medium = active & (medium_idx >= 0)
            active_surface = active & ~active_medium

            # ---- free flight in the lane's medium ----
            u_t, state = sampler.next_1d(state)
            mi = scene.medium_sample_interaction(
                ray_it, u_t, channel, medium_idx, active_medium, wavelengths)
            # the surface hits of the lanes whose last event changed the ray
            si = select(needs_isect, scene.ray_intersect(
                ray_it, needs_isect, wavelengths), si)
            needs_isect = needs_isect & ~active_medium & ~active_surface
            # a surface before the sampled collision voids the collision
            mi = mi._replace(t=torch.where(active_medium & (si.t < mi.t),
                                           float("inf"), mi.t))
            tr, ff_pdf = scene.medium_eval_tr_and_pdf(mi, si.t, medium_idx,
                                                      active_medium)
            tr_pdf = _index_spectrum(ff_pdf, channel)
            throughput = where(active_medium, throughput * m.safe_div(
                tr, tr_pdf[:, None], 0.0), throughput)
            if smis:
                r_ff = m.safe_div(ff_pdf, tr_pdf[:, None], 0.0)
                rho_dir = where(active_medium, rho_dir * r_ff, rho_dir)
                rho_nee = where(active_medium, rho_nee * r_ff, rho_nee)
            collided = torch.isfinite(mi.t)
            escaped = active_medium & ~collided
            active_medium = active_medium & collided

            # ---- null or real collision (volpath.cpp:123-151) ----
            u_e, state = sampler.next_1d(state)
            sig_t_c = _index_spectrum(mi.sigma_t, channel)
            maj_c = _index_spectrum(mi.combined_extinction, channel)
            null_scatter = u_e >= m.safe_div(sig_t_c, maj_c, 0.0)
            act_null = null_scatter & active_medium
            act_real = ~null_scatter & active_medium
            sig_n_c = _index_spectrum(mi.sigma_n, channel)
            throughput = where(act_null, throughput * (mi.sigma_n * m.safe_div(
                maj_c, sig_n_c, 0.0)[:, None]), throughput)
            if smis:
                # p(null) = sigma_n_c / maj_c; the directional strategy
                # takes it with (sigma_n / maj)_j, NEE crosses with p = 1
                # (volpathmis.cpp:203-204)
                p_null = m.safe_div(sig_n_c, maj_c, 0.0)
                r_d = m.safe_div(m.safe_div(mi.sigma_n,
                                            mi.combined_extinction, 0.0),
                                 p_null[:, None], 0.0)
                rho_dir = where(act_null, rho_dir * r_d, rho_dir)
                rho_nee = where(act_null, rho_nee * m.safe_div(
                    1.0, p_null, 0.0)[:, None], rho_nee)
            depth = torch.where(act_real, depth + 1, depth)
            active = active & (depth < self.max_depth)
            act_real = act_real & active
            # a null collision continues straight on from its point
            ray_o = where(act_null, mi.p, ray_o)
            si = si._replace(t=torch.where(act_null, si.t - mi.t, si.t))

            # ---- real scattering: phase NEE and phase sampling ----
            throughput = where(act_real, throughput * (mi.sigma_s * m.safe_div(
                maj_c, sig_t_c, 0.0)[:, None]), throughput)
            if smis:
                # p(real) = sigma_t_c / maj_c (volpathmis.cpp:218); NEE
                # restarts at every real scatter (:237)
                p_real = m.safe_div(sig_t_c, maj_c, 0.0)
                r_real = m.safe_div(m.safe_div(mi.sigma_t,
                                               mi.combined_extinction, 0.0),
                                    p_real[:, None], 0.0)
                rho_dir = where(act_real, rho_dir * r_real, rho_dir)
                rho_nee = where(act_real, rho_dir, rho_nee)
            specular_chain = specular_chain & ~act_real
            nee_u, state = sampler.next_2d(state)
            mi_as_si = si._replace(t=mi.t, p=mi.p, n=mi.sh_frame.n,
                                   sh_frame=mi.sh_frame, wi=mi.wi)
            ds_m, em_m, state, rho_n_arm, rho_d_arm = \
                self._sample_emitter_attenuated(
                    scene, sampler, state, mi_as_si, medium_idx, channel,
                    nee_u, act_real, True, wavelengths, smis)
            phase_val = scene.medium_phase_eval(mi, ds_m.d, medium_idx,
                                                act_real)
            if smis:
                # the balance heuristic over every channel's strategies
                # (volpathmis.cpp:229-233)
                vr = m.safe_div(torch.where(ds_m.delta, 0.0, phase_val),
                                ds_m.pdf, 0.0)
                s_nee = (rho_dir * rho_n_arm).sum(-1)
                s_dir = (rho_dir * rho_d_arm).sum(-1) * vr
                w_nee = m.safe_div(float(nch), s_nee + s_dir, 0.0)
            elif self.USE_MIS:
                # a normalized phase function's value is its pdf
                w_nee = torch.where(ds_m.delta, 1.0,
                                    mis_weight(ds_m.pdf, phase_val))
            else:
                w_nee = torch.ones_like(phase_val)
            result = result + where(
                act_real, w_nee[:, None] * throughput * phase_val[:, None]
                * em_m, 0.0)
            ph_u, state = sampler.next_2d(state)
            wo_m, ph_pdf = scene.medium_phase_sample(mi, medium_idx, ph_u,
                                                     act_real)
            if smis:
                rho_nee = where(act_real, rho_nee * m.safe_div(
                    1.0, ph_pdf, 0.0)[:, None], rho_nee)
            ray_o = where(act_real, mi.p, ray_o)
            ray_d = where(act_real, wo_m, ray_d)
            needs_isect = needs_isect | act_real
            prev_pdf = torch.where(act_real, ph_pdf, prev_pdf)
            prev_p = where(act_real, mi.p, prev_p)
            prev_delta = prev_delta & ~act_real

            # ---- surfaces: emission ----
            active_surface = active_surface | escaped
            if self.USE_MIS:
                # emitter hits on every path, against NEE's density for
                # the same vertex
                emit_mask = active_surface
                ds_hit = DirectionSample(
                    si.p, si.n, si.uv, zero, torch.zeros_like(active), ray_d,
                    torch.where(si.is_valid(), m.norm(si.p - prev_p),
                                float("inf")), scene.emitter_index_at(si))
                em_pdf = torch.where(
                    (ds_hit.emitter_idx >= 0) & ~prev_delta,
                    scene.pdf_emitter_direction(si._replace(p=prev_p),
                                                ds_hit, emit_mask), 0.0)
                if smis:
                    s_dir = rho_dir.sum(-1)
                    s_nee = rho_nee.sum(-1) * em_pdf
                    w_hit = torch.where(
                        prev_delta, m.safe_div(float(nch), s_dir, 0.0),
                        m.safe_div(float(nch), s_dir + s_nee, 0.0))
                else:
                    w_hit = torch.where(prev_delta, 1.0,
                                        mis_weight(prev_pdf, em_pdf))
            else:
                emit_mask = active_surface & specular_chain
                w_hit = torch.ones_like(zero)
            emitted = scene.eval_emitter(si, ray_d, emit_mask)
            result = result + where(emit_mask, w_hit[:, None] * throughput
                                    * emitted, 0.0)
            active_surface = active_surface & si.is_valid()

            # ---- surface NEE ----
            parts = scene.bsdf_partition(si, active_surface)
            active_e = active_surface \
                & ((scene.bsdf_flags_at(si) & smooth) != 0) \
                & (depth + 1 < self.max_depth)
            nee_u2, state = sampler.next_2d(state)
            ds_s, em_s, state, rho_n_s, rho_d_s = \
                self._sample_emitter_attenuated(
                    scene, sampler, state, si, medium_idx, channel, nee_u2,
                    active_e, False, wavelengths, smis)
            wo_local = si.to_local(ds_s.d)
            bsdf_val = scene.bsdf_eval(ctx, si, wo_local, active_e, parts)
            if self.USE_MIS:
                bsdf_pdf = scene.bsdf_pdf(ctx, si, wo_local, active_e, parts)
            if smis:
                vr_s = m.safe_div(torch.where(ds_s.delta, 0.0, bsdf_pdf),
                                  ds_s.pdf, 0.0)
                s_nee = (rho_dir * rho_n_s).sum(-1)
                s_dir = (rho_dir * rho_d_s).sum(-1) * vr_s
                mis = m.safe_div(float(nch), s_nee + s_dir, 0.0)
            elif self.USE_MIS:
                mis = torch.where(ds_s.delta, 1.0,
                                  mis_weight(ds_s.pdf, bsdf_pdf))
            else:
                # the directional arm never collects non-delta emitter
                # hits, so NEE carries full weight
                mis = torch.ones_like(zero)
            result = result + where(
                active_e, mis[:, None] * throughput * bsdf_val * em_s, 0.0)

            # ---- BSDF sampling and the medium transition ----
            b1, state = sampler.next_1d(state)
            b2, state = sampler.next_2d(state)
            bs, bsdf_weight = scene.bsdf_sample(ctx, si, b1, b2,
                                                active_surface, parts)
            throughput = throughput * where(active_surface, bsdf_weight, 1.0)
            non_null = (bs.sampled_type & null) == 0
            delta_lobe = (bs.sampled_type & delta) != 0
            real_bounce = active_surface & non_null
            depth = torch.where(real_bounce, depth + 1, depth)
            specular_chain = (specular_chain | (real_bounce & delta_lobe)) \
                & ~(real_bounce & ~delta_lobe)
            new_dir = si.to_world(bs.wo)
            ray_o = where(active_surface, si.offset_p(new_dir), ray_o)
            ray_d = where(active_surface, new_dir, ray_d)
            needs_isect = needs_isect | active_surface
            # a null lobe keeps the previous strategy's pdf and origin:
            # the straight segment belongs to the same directional sample
            if smis:
                # a real bounce restarts NEE (volpathmis.cpp:317-318)
                rho_nee = where(real_bounce, rho_dir * m.safe_div(
                    1.0, bs.pdf, 0.0)[:, None], rho_nee)
            prev_pdf = torch.where(real_bounce, bs.pdf, prev_pdf)
            prev_p = where(real_bounce, si.p, prev_p)
            prev_delta = torch.where(real_bounce, delta_lobe, prev_delta)
            medium_idx = scene.medium_transition(si, new_dir, medium_idx,
                                                 active_surface)
            alive = (throughput != 0.0).any(-1)
            active = ((active_surface & alive) | act_real | act_null) \
                & (depth < self.max_depth) & alive

            # ---- Russian roulette on the total turns ----
            rr_u, state = sampler.next_1d(state)
            q = torch.clamp(throughput.amax(-1), max=0.95)
            do_rr = depth > self.rr_depth
            cont = ~do_rr | (rr_u < q)
            active = active & cont
            throughput = where(do_rr & cont, throughput * m.safe_div(
                1.0, q, 0.0)[:, None], throughput)
            it += 1
        self.last_trips.append(it)
        return result

    def _sample_emitter_attenuated(self, scene, sampler, state, ref_si,
                                   medium_idx, channel, sample2, active,
                                   from_medium, wavelengths, smis):
        """NEE with the transmittance through media and null interfaces
        (volpath.cpp sample_emitter:258-360; mitsuba2_tpu/models/
        integrators.py:871-985) -> (direction sample, radiance over pdf
        times transmittance, state, and the walk's per-channel pdf-ratio
        products of the NEE and directional strategies, ones without
        ``smis``). Without media one shadow ray through ``ray_test``;
        else a walk that finds each next surface with a closest hit,
        ratio-tracks the medium segments before it (every collision
        crossed with weight sigma_n) and passes null surfaces, while any
        lane walks, up to ``nee_loop_cap`` turns."""
        from ..variants import current
        n, dev = ref_si.t.shape[0], ref_si.t.device
        nch = current().n_channels
        ds, emitter_val = scene.sample_emitter_direction(
            ref_si, sample2, active, test_visibility=False)
        active = active & (ds.pdf != 0)
        ones = torch.ones((n, nch), device=dev)
        if not scene.has_media:
            active = active & ~scene.shadow_test(ref_si, ds, active)
            return (ds, torch.where(active[:, None], emitter_val, 0.0),
                    state, ones, ones)
        d = ds.d.contiguous()
        o = ref_si.p if from_medium else ref_si.offset_p(d)
        remaining = ds.dist
        tr_acc, rho_n, rho_d = ones, ones, ones
        med_idx = medium_idx
        act = active
        zero = torch.zeros((n,), device=dev)
        it = 0
        while it < self.nee_loop_cap and bool(act.any()):
            ray = Ray(o.contiguous(), d, zero,
                      (remaining * (1.0 - m.ShadowEpsilon)).contiguous())
            si = scene.ray_intersect(ray, act, wavelengths)
            act_med = act & (med_idx >= 0)
            u_t, state = sampler.next_1d(state)
            mi = scene.medium_sample_interaction(ray, u_t, channel, med_idx,
                                                 act_med, wavelengths)
            # collisions behind the surface or past the emitter are void
            mi = mi._replace(t=torch.where(
                act_med & ((si.t < mi.t) | (mi.t > remaining)),
                float("inf"), mi.t))
            tr, ff_pdf = scene.medium_eval_tr_and_pdf(
                mi, torch.minimum(si.t, remaining), med_idx, act_med)
            tr_pdf = _index_spectrum(ff_pdf, channel)
            tr_acc = torch.where(act_med[:, None], tr_acc * m.safe_div(
                tr, tr_pdf[:, None], 0.0), tr_acc)
            collided = act_med & torch.isfinite(mi.t)
            if smis:
                # both strategies cross the same distances
                # (volpathmis.cpp:177-178); the directional one takes each
                # collision as a null event with p = sigma_n / majorant
                r_ff = m.safe_div(ff_pdf, tr_pdf[:, None], 0.0)
                rho_n = torch.where(act_med[:, None], rho_n * r_ff, rho_n)
                rho_d = torch.where(act_med[:, None], rho_d * r_ff, rho_d)
                rho_d = torch.where(collided[:, None], rho_d * m.safe_div(
                    mi.sigma_n, mi.combined_extinction, 0.0), rho_d)
            # ratio tracking: a collision is crossed with weight sigma_n
            tr_acc = torch.where(collided[:, None], tr_acc * mi.sigma_n,
                                 tr_acc)
            o = torch.where(collided[:, None], mi.p, o)
            remaining = torch.where(collided, remaining - mi.t, remaining)
            # lanes that reached a surface first pass a null one
            reach = act & ~collided & si.is_valid() & (si.t < remaining)
            null_tr = self._null_transmission(scene, si, reach)
            blocked = reach & (null_tr == 0.0).all(-1)
            tr_acc = torch.where(reach[:, None], tr_acc * null_tr, tr_acc)
            o = torch.where(reach[:, None], si.offset_p(d), o)
            remaining = torch.where(reach, remaining - si.t, remaining)
            med_idx = scene.medium_transition(si, d, med_idx, reach)
            done = act & ~collided & ~reach          # at the emitter
            act = act & ~done & ~blocked & (remaining > 1e-5) \
                & (tr_acc > 0).any(-1)
            it += 1
        self.last_trips.append(it)
        # lanes still walking at the cap keep their transmittance
        tr_acc = torch.where(active[:, None], tr_acc, 0.0)
        return ds, emitter_val * tr_acc, state, rho_n, rho_d

    @staticmethod
    def _null_transmission(scene, si, active):
        """What each lane's BSDF passes straight through (n, C)."""
        from ..variants import current
        out = torch.zeros((si.t.shape[0], current().n_channels),
                          device=si.t.device)
        idx = scene.bsdf_index_at(si)
        for i, b in enumerate(scene.wavefront_tables().bsdfs):
            mask = active & (idx == i)
            out = torch.where(mask[:, None],
                              b.eval_null_transmission(si, mask), out)
        return out


@register_plugin("integrator", "volpathmis")
class VolumetricMISPathIntegrator(VolumetricPathIntegrator):
    """(volpathmis.cpp) volumetric path tracing with power-2 MIS between
    NEE and phase or BSDF sampling. In the kernel's scalar extinction the
    transmittance factors are common to both strategies, so the weights
    are the directional ones; the wavefront carries, in spectral
    variants, the reference's per-channel weight matrix
    (volpathmis.cpp:447-499) in its separable pdf-ratio form."""

    USE_MIS = True


def wavefront_ineligibility(scene, sensor):
    """-> None if the general wavefront renders the scene, else the
    missing piece: a sensor without ``sample_ray``, a shape that is not a
    mesh, sphere, disk or cylinder, or a BSDF, emitter or texture without
    the methods the wavefront calls. A ``_double`` variant renders in
    float32 and a ``_polarized`` one as the unpolarized variant, as the
    reference's wavefronts do (nothing there enables 64-bit floats or
    reads the polarized flag; the ``stokes`` integrator carries Stokes
    vectors in any variant). The path wavefront passes media by, as the
    reference's does (a null boundary lets its rays through); the volpath
    wavefront also asks ``_media_ineligibility``."""
    from ..render.sensor import Sensor
    from ..models.shapes import CylinderShape, DiskShape, SphereShape
    if not _overrides(sensor, Sensor, "sample_ray"):
        return f"sensor {type(sensor).__name__} has no sample_ray"
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


def _media_ineligibility(scene):
    """The first medium, phase function or volume of the scene without
    the methods the volpath wavefront calls, or None."""
    from ..models.media import Medium, Volume
    from ..models.phase import PhaseFunction
    for med in scene.media:
        if not _overrides(med, Medium, "intersect_aabb",
                          "get_combined_extinction",
                          "get_scattering_coefficients"):
            return f"medium {type(med).__name__} has no wavefront sampling"
        ph = med.phase_function
        if not _overrides(ph, PhaseFunction, "sample", "eval"):
            return (f"phase {type(ph).__name__} has no wavefront "
                    f"sample/eval")
        for v in vars(med).values():
            if isinstance(v, Volume) and not _overrides(v, Volume, "eval",
                                                        "eval_1"):
                return f"volume {type(v).__name__} has no wavefront eval"
        reason = _texture_ineligibility(med)
        if reason is not None:
            return reason
    return None


def _overrides(obj, base, *names):
    """Whether ``obj``'s class gives its own ``names`` over ``base``'s."""
    return all(getattr(type(obj), n, None) not in (None, getattr(base, n))
               for n in names)


def _has(obj, *names):
    return all(callable(getattr(obj, n, None)) for n in names)


def _texture_ineligibility(obj):
    """The first texture that ``obj`` holds (a checkerboard's colors, a
    wrapper BSDF's children and their textures in turn) without an
    ``eval`` of its own, or None."""
    from ..render.bsdf import BSDF
    from ..render.texture import Texture
    for t in vars(obj).values():
        if isinstance(t, Texture) and not _overrides(t, Texture, "eval"):
            return f"texture {type(t).__name__} has no wavefront eval"
        if isinstance(t, (Texture, BSDF)):
            reason = _texture_ineligibility(t)
            if reason is not None:
                return reason
    return None
