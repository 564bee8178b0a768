"""Integrator bases + the render drive.

Parity: include/mitsuba/render/integrator.h:37-143 and
``mitsuba2_tpu.render.integrator``. A render splits its samples into passes
of at most ``wavefront_cap`` lanes (lanes = pixels x samples per pass),
renders each pass with ``render_wavefront`` at its own ``sample_base``,
accumulates the passes into an image block and develops it. PyTorch runs
eagerly, so there is no compiled-pass cache. Between passes the drive
checks ``should_stop`` (``cancel()`` or the ``timeout`` property) and
develops what it has.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..core import logger as _log
from ..core.object import Object
from ..core import math as m
from ..render.film import ImageBlock


class Integrator(Object):
    """(integrator.h:37-51) with the cooperative stop: ``cancel()``, a
    wall-clock ``timeout`` property in seconds (integrator.h:136-145; -1
    never) and the partial image of the passes done so far
    (``develop_partial``, the reference's SIGHUP develop,
    mitsuba.cpp:109-121); as ``mitsuba2_tpu.render.integrator``."""

    def __init__(self, props=None):
        super().__init__(props)
        self.timeout = float(props.float_("timeout", -1.0)) \
            if props is not None else -1.0
        self._cancel = False
        self._render_start = None
        self._partial = None          # (ImageBlock, data) of the last pass

    def render(self, scene, sensor=0, seed=0, spp=None):
        raise NotImplementedError

    def cancel(self):
        """(integrator.h:51) asks the render drive to stop after the pass
        it is in and develop what it has."""
        self._cancel = True

    def should_stop(self):
        """(integrator.h:136-145) true once cancelled or past the
        timeout."""
        if self._cancel:
            return True
        return (self.timeout > 0.0 and self._render_start is not None
                and time.time() - self._render_start > self.timeout)

    def develop_partial(self):
        """The image of the passes accumulated so far, None before the
        first pass ends. A pass's block carries its own weights, so the
        partial image is normalized."""
        if self._partial is None:
            return None
        block, data = self._partial
        return block.develop(data)


class SamplingIntegrator(Integrator):
    """(integrator.h:70) renders by Monte Carlo sampling per film sample:
    ``sample`` gives each camera ray's radiance, ``sample_aovs`` that and
    the integrator's arbitrary output variables, one (n,) tensor for each
    of ``aov_names()``, which the image carries after its three color
    channels."""

    # lanes per pass of the general wavefront
    MAX_WAVEFRONT = 1 << 20
    # whether ``sample_aovs``' AOVs are spectra on the radiance's scale
    SPECTRAL_AOVS = False

    def aov_names(self):
        return []

    def sample(self, scene, sampler, state, ray, wavelengths):
        """Radiance along each camera ray -> (n, C)."""
        raise NotImplementedError

    def sample_aovs(self, scene, sampler, state, ray, wavelengths):
        """-> (radiance (n, C), list of (n,) AOV channels)."""
        return self.sample(scene, sampler, state, ray, wavelengths), []

    def wavefront_cap(self, scene, sensor):
        """Max lanes per pass; engines with a smaller per-lane footprint
        (the path kernel) override this upward."""
        return self.MAX_WAVEFRONT

    def render(self, scene, sensor=0, seed=0, spp=None, develop=True):
        """-> (h, w, 3 + len(aov_names())) float32 image on the scene's
        device (or, with ``develop=False``, the accumulation block, one
        weight channel more)."""
        from ..variants import variant as _variant_name
        if scene.variant_name != _variant_name():
            raise RuntimeError(
                f"scene was loaded under variant {scene.variant_name!r} but "
                f"the active variant is {_variant_name()!r}; reload the "
                "scene after set_variant")
        if isinstance(sensor, int):
            sensor = scene.sensors[sensor]
        film = sensor.film
        sampler = sensor.sampler
        w, h = film.crop_size
        if spp is None:
            spp = sampler.sample_count
        cap = self.wavefront_cap(scene, sensor)
        spp_per_pass = max(1, min(spp, cap // (w * h)))
        while spp % spp_per_pass != 0:
            spp_per_pass -= 1
        n_passes = spp // spp_per_pass

        block = ImageBlock((w, h), 3 + len(self.aov_names()), film.rfilter,
                           scene.device)
        data = block.create()
        self._cancel = False
        self._render_start = time.time()
        for p in range(n_passes):
            if p > 0 and self.should_stop():
                _log.Log(_log.Warn,
                         f"render stopped after {p}/{n_passes} passes "
                         f"({'cancelled' if self._cancel else 'timeout'}); "
                         f"developing the partial image")
                break
            data = data + self.render_wavefront(
                scene, sensor, sampler, seed, p * spp_per_pass,
                spp_per_pass, spp)
            self._partial = (block, data)
        return block.develop(data) if develop else data

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total):
        """One pass of the general wavefront over w*h*spp_pass lanes ->
        the pass's image block (mitsuba2_tpu/render/integrator.py:159-236):
        ``wavefront_lanes``, then under a box filter the sum over each
        pixel's samples, else the image block's ``put``."""
        from ..models.rfilters import BoxFilter
        w, h = sensor.film.crop_size
        pos_px, value = self.wavefront_lanes(scene, sensor, sampler, seed,
                                             sample_base, spp_pass)
        block = ImageBlock((w, h), value.shape[1], sensor.film.rfilter,
                           scene.device)
        if isinstance(sensor.film.rfilter, BoxFilter) and block.border == 0:
            return box_sum(value, w, h, spp_pass)
        return block.put(block.create(), pos_px, value)

    def wavefront_lanes(self, scene, sensor, sampler, seed, sample_base,
                        spp_pass):
        """Each lane's film position (n, 2) in pixels and values (n, 3 +
        len(aov_names())): the camera lanes (``camera_lanes``),
        ``sample_aovs``' radiance times the ray's weight, converted to rgb
        (``lanes_to_rgb``), then the AOV channels as they come, or, with
        ``SPECTRAL_AOVS``, each AOV spectrum (n, C) converted as the
        radiance is, three channels each
        (mitsuba2_tpu/render/integrator.py:210-217)."""
        lanes = camera_lanes(scene, sensor, sampler, seed, sample_base,
                             spp_pass)
        value, aovs = self.sample_aovs(scene, sampler, lanes.state,
                                       lanes.ray, lanes.wavelengths)
        value = lanes_to_rgb(value * lanes.ray_weight, lanes.wavelengths)
        if aovs and self.SPECTRAL_AOVS:
            # spectra on the radiance's scale (Stokes components): the
            # ray's weight and the color conversion of the radiance
            aovs = [c for a in aovs for c in lanes_to_rgb(
                a * lanes.ray_weight, lanes.wavelengths).unbind(-1)]
        if aovs:
            value = torch.cat([value] + [a[:, None] for a in aovs], -1)
        return lanes.pos_px, value


class CameraLanes(NamedTuple):
    pos_px: torch.Tensor        # (n, 2) film position in pixels
    pixel_id: torch.Tensor      # (n,) int64, pixel-major lanes
    state: object               # the sampler state after the camera draws
    ray: object
    ray_weight: torch.Tensor
    wavelengths: object         # (n, 4) hero wavelengths, or None


def camera_lanes(scene, sensor, sampler, seed, sample_base, spp_pass):
    """The camera rays of a pass of w * h * spp_pass lanes, pixel-major,
    each lane's stream seeded by (seed, pixel, sample_base + its sample
    index), then a jittered film position, an aperture sample, a time and
    a wavelength sample drawn in that order
    (mitsuba2_tpu/render/integrator.py:176-191)."""
    from ..models.textures import on_device
    w, h = sensor.film.crop_size
    n = w * h * spp_pass
    dev = scene.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pixel_id = lane // spp_pass
    state = sampler.seed(seed, pixel_id, lane % spp_pass + sample_base)
    jitter, state = sampler.next_2d(state)
    pos_px = torch.stack([(pixel_id % w).float(),
                          (pixel_id // w).float()], -1) + jitter
    pos01 = pos_px / on_device(sensor.film, "crop_size", [w, h], dev)
    ap_sample, state = sampler.next_2d(state)
    time_sample, state = sampler.next_1d(state)
    wav_sample, state = sampler.next_1d(state)
    time = sensor.shutter_open
    if sensor.shutter_close != sensor.shutter_open:
        time = sensor.shutter_open + time_sample \
            * (sensor.shutter_close - sensor.shutter_open)
    ray, ray_weight, wavelengths = sensor.sample_ray(
        time, wav_sample, pos01, ap_sample)
    return CameraLanes(pos_px, pixel_id, state, ray, ray_weight,
                       wavelengths)


def lanes_to_rgb(s, wavelengths):
    """Lane spectra (n, C) -> rgb (n, 3): spectral through the hero
    wavelengths and the CIE curves, mono repeated, rgb as it is."""
    from ..core import spectrum as spec
    from ..variants import current
    var = current()
    if var.is_spectral:
        return spec.spectrum_to_srgb_rows(s.T, wavelengths.T).T
    if var.is_monochromatic:
        return s.repeat(1, 3)
    return s


def box_sum(value, w, h, spp):
    """The image block of pixel-major lanes ``value`` (w * h * spp, C)
    under a box filter: jittered samples stay in their pixel, so the splat
    is a sum over each pixel's samples, with the weight channel last ->
    (h, w, C + 1). The channels are summed three at a time beside the
    weights, each group as an (n, spp, 4) tensor, so that a channel's sum
    is the same whatever channels stand beside it (an AOV's depth is a
    depth render's, bit for bit) and rgb alone sums as one group."""
    ones = torch.ones_like(value[:, :1])
    c = value.shape[1]
    groups = torch.nn.functional.pad(value, (0, -c % 3)).split(3, 1)
    sums = [torch.cat([g, ones], -1).reshape(w * h, spp, 4).sum(1)
            for g in groups]
    if len(sums) == 1:
        return sums[0].reshape(h, w, 4)
    out = torch.cat([x[:, :3] for x in sums], -1)[:, :c]
    return torch.cat([out, sums[0][:, 3:]], -1).reshape(h, w, c + 1)


class MonteCarloIntegrator(SamplingIntegrator):
    """(integrator.h:143) adds max_depth / rr_depth handling
    (integrator.cpp:302-315)."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        self.max_depth = int(p.int_("max_depth", -1)) if p else -1
        self.rr_depth = int(p.int_("rr_depth", 5)) if p else 5
        if self.max_depth < 0:
            if self.max_depth != -1:
                raise RuntimeError("max_depth must be >= 0 or -1")
            # unbounded depth: RR terminates lanes; hard cap for safety
            self.max_depth = 1024


def mis_weight(pdf_a, pdf_b):
    """Power-2 MIS heuristic (path.cpp:223-227)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    return m.safe_div(pdf_a, pdf_a + pdf_b, 0.0)
