"""Radiative backprop: the path-replay adjoint (mitsuba2_tpu/models/rb.py).

A taped differentiable render keeps every bounce's autograd graph for all
lanes until the backward pass. The replay bounds that: two passes over the
same random stream --

1. a pass without a graph that gives each lane's total radiance ``L``
   (``PathIntegrator.sample``);
2. a replay that walks the identical path with the transport
   (throughput, directions, intersections, MIS, Russian roulette)
   detached and only the local factors attached: BSDF evaluations,
   BSDF-sample weights and emitter radiances. A factor ``w`` that scales
   the radiance still to come contributes ``w * detach(tail / w)``, so the
   surrogate's gradient is the differential path tracer's estimate.

``render_backward`` runs the two for one pass of lanes at a time, calls
``backward`` on the pass's surrogate and frees it before the next pass
(the role of the JAX package's ``jax.checkpoint``): peak memory is a
pass's, whatever the sample count. Visibility (silhouette) derivatives are
out of scope, as in the reference's autodiff integrators.
"""

from __future__ import annotations

import torch

from ..core.object import register_plugin
from ..render.bsdf import BSDFContext, BSDFFlags
from ..render.integrator import mis_weight
from ..render.records import DirectionSample
from .integrators import PathIntegrator, wavefront_ineligibility


def _ratio(att, det, tail):
    """Per channel ``att * detach(tail / det)`` where det > 1e-12, else 0
    (the divisor guarded on both sides of the mask)."""
    det = det.detach()
    ok = det > 1e-12
    return torch.where(ok, att * (tail / torch.where(ok, det, 1.0))
                       .detach(), 0.0)


@register_plugin("integrator", "rb")
class RBIntegrator(PathIntegrator):
    """Path-replay radiative backprop (``rb``, alias ``prb``): renders as
    ``path`` does through the path wavefront (the path kernel's gate
    refuses a subclass), and takes gradients through ``render_backward``
    (python/autodiff.py ``render_loss_rb``)."""

    def _wavefront_ineligibility(self, scene, sensor):
        return wavefront_ineligibility(scene, sensor)

    def replay(self, scene, sampler, state, ray, wavelengths, L_total):
        """The replay pass: ``PathIntegrator.sample``'s random stream and
        trajectory, returning the surrogate (n, C) whose gradient with
        respect to the bound parameters is the RB estimate."""
        n = ray.o.shape[0]
        ctx = BSDFContext()
        L_total = L_total.detach()
        si = scene.ray_intersect(ray, None, wavelengths)
        active = torch.ones((n,), dtype=torch.bool, device=ray.o.device)
        # emission at the first hit, attached through the emitter's values
        surr = scene.eval_emitter(si, ray.d, active)
        result = surr.detach()
        throughput = torch.ones_like(result)
        eta = torch.ones_like(si.t)
        active = si.is_valid()
        smooth = int(BSDFFlags.Smooth)
        delta = int(BSDFFlags.Delta)
        depth = 1
        last = min(self.max_depth, 33)
        while depth < last:
            if not bool(active.any()):
                break
            rr_u, state = sampler.next_1d(state)
            if depth > self.rr_depth:
                q = torch.clamp(throughput.amax(-1) * (eta * eta), max=0.95)
                active = active & (rr_u < q)
                throughput = throughput * torch.where(
                    q != 0, 1.0 / torch.where(q != 0, q, 1.0), 0.0)[:, None]
            parts = scene.bsdf_partition(si, active)
            # NEE: the BSDF value and the emitter's radiance attached
            active_e = active & ((scene.bsdf_flags_at(si) & smooth) != 0)
            em_sample, state = sampler.next_2d(state)
            ds, emitter_val = scene.sample_emitter_direction(si, em_sample,
                                                             active_e)
            active_e = active_e & (ds.pdf.detach() != 0)
            bsdf_val, bsdf_pdf = scene.bsdf_eval_pdf(
                ctx, si, si.to_local(ds.d), active_e, parts)
            mis = torch.where(ds.delta, 1.0, mis_weight(
                ds.pdf.detach(), bsdf_pdf.detach()))
            c_nee = torch.where(active_e[:, None], mis[:, None] * throughput
                                * bsdf_val * emitter_val, 0.0)
            surr = surr + c_nee
            result = result + c_nee.detach()
            # BSDF sampling: the weight scales all radiance downstream
            b1, state = sampler.next_1d(state)
            b2, state = sampler.next_2d(state)
            bs, bsdf_weight = scene.bsdf_sample(ctx, si, b1, b2, active,
                                                parts)
            tail = (L_total - result).detach()
            surr = surr + torch.where(active[:, None], _ratio(
                bsdf_weight, bsdf_weight, tail), 0.0)
            throughput = (throughput * torch.where(
                active[:, None], bsdf_weight, 1.0)).detach()
            active = active & (throughput != 0.0).any(-1)
            eta = torch.where(active, eta * bs.eta.detach(), eta)
            new_ray = si.spawn_ray(si.to_world(bs.wo.detach()))
            si_next = scene.ray_intersect(new_ray, active, wavelengths)
            ds_next = DirectionSample(
                si_next.p, si_next.n, si_next.uv, torch.zeros_like(si.t),
                torch.zeros_like(active), new_ray.d,
                torch.where(si_next.is_valid(), si_next.t, float("inf")),
                scene.emitter_index_at(si_next))
            delta_lobe = (bs.sampled_type & delta) != 0
            emitter_pdf = torch.where(
                (ds_next.emitter_idx >= 0) & ~delta_lobe,
                scene.pdf_emitter_direction(si, ds_next, active).detach(),
                0.0)
            ew = mis_weight(bs.pdf.detach(), emitter_pdf)
            emitted = scene.eval_emitter(si_next, new_ray.d, active)
            c_emit = torch.where(active[:, None], ew[:, None] * throughput
                                 * emitted, 0.0)
            surr = surr + c_emit
            result = result + c_emit.detach()
            active = active & si_next.is_valid()
            si = si_next
            depth += 1
        return surr

    def render_backward(self, scene, params, values, grad_image, seed=0,
                        spp=4, sensor_index=0, spp_per_pass=None):
        """The RB gradient of ``sum(image * grad_image)`` with respect to
        ``values`` (key -> tensor) -> dict of gradients shaped as the
        values. Each pass of lanes renders its detached totals without a
        graph, replays, and back-propagates its surrogate at once; lanes
        are pixel-major and seeded by (seed, pixel, sample), as the
        forward drive's (render/integrator.py ``camera_lanes``), with the
        image's gradient spread over each pixel's samples."""
        from ..render.integrator import camera_lanes, lanes_to_rgb, pass_spp
        sensor = scene.sensors[sensor_index] \
            if isinstance(sensor_index, int) else sensor_index
        sampler = sensor.sampler
        w, h = sensor.film.crop_size
        gi = grad_image.detach().reshape(w * h, -1)[:, :3] / spp
        vals = {k: v.detach().clone().requires_grad_(True)
                for k, v in values.items()}
        self._differentiable = True
        try:
            k = spp_per_pass or pass_spp(self, scene, sensor, spp)
            with params.bind(vals):
                for p in range(spp // k):
                    lanes = camera_lanes(scene, sensor, sampler, seed,
                                         p * k, k)
                    with torch.no_grad():
                        L_total = PathIntegrator.sample(
                            self, scene, sampler, lanes.state, lanes.ray,
                            lanes.wavelengths)
                    surr = self.replay(scene, sampler, lanes.state,
                                       lanes.ray, lanes.wavelengths,
                                       L_total)
                    rgb = lanes_to_rgb(surr * lanes.ray_weight.detach(),
                                       lanes.wavelengths)
                    objective = (rgb * gi[lanes.pixel_id]).sum()
                    if objective.requires_grad:
                        objective.backward()
                    del surr, rgb, objective
        finally:
            self._differentiable = False
        return {k: v.grad if v.grad is not None else torch.zeros_like(v)
                for k, v in vals.items()}


# the path-replay backprop alias
register_plugin("integrator", "prb")(RBIntegrator)
