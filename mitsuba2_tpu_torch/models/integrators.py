"""Integrator plugins (reference: src/integrators/path.cpp, volpath.cpp,
volpathmis.cpp).

The path integrator renders every scene inside the path kernel's scope
through that kernel (ops/path_kernel.py); ``volpath`` and ``volpathmis``
render every scene inside the volumetric kernel's scope through it
(ops/volpath_kernel.py). A scene outside a kernel's scope raises
``NotImplementedError`` with the reason, which also stays readable in
``engine_reason``: the torch wavefronts that will take such scenes
(``mitsuba2_tpu.models.integrators.PathIntegrator.sample`` and
``VolumetricPathIntegrator.sample``) are not ported yet, and nothing falls
back silently.
"""

from __future__ import annotations

from ..core import logger as _log
from ..core.object import register_plugin
from ..render.integrator import MonteCarloIntegrator


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

    def wavefront_cap(self, scene, sensor):
        if self._kernel_for(scene, sensor) is not None:
            return self.MAX_WAVEFRONT_KERNEL
        return self.MAX_WAVEFRONT

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total):
        mk = self._kernel_for(scene, sensor)
        if mk is None:
            self.last_engine = None
            raise NotImplementedError(self.engine_reason)
        self.last_engine = "kernel"
        return mk.render_pass(seed, sample_base, spp_pass)

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
