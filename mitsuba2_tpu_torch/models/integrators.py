"""Integrator plugins (reference: src/integrators/path.cpp).

The path integrator renders every scene inside the path kernel's scope
through that kernel (ops/path_kernel.py). A scene outside it raises
``NotImplementedError`` with the reason, which also stays readable in
``engine_reason``: the torch wavefront that will take such scenes
(``mitsuba2_tpu.models.integrators.PathIntegrator.sample``) is not ported
yet, and nothing falls back silently.
"""

from __future__ import annotations

from ..core import logger as _log
from ..core.object import register_plugin
from ..render.integrator import MonteCarloIntegrator


@register_plugin("integrator", "path")
class PathIntegrator(MonteCarloIntegrator):
    """MIS path tracer (path.cpp:92-234)."""

    # the kernel keeps a path's state in registers and writes 12 B per
    # lane, so the whole 256^2 x 64 spp render fits in one pass
    MAX_WAVEFRONT_KERNEL = 1 << 23

    def __init__(self, props=None):
        super().__init__(props)
        self.engine_reason = None
        self.last_engine = None
        self._kernel_cache = None

    def wavefront_cap(self, scene, sensor):
        if self._megakernel_for(scene, sensor) is not None:
            return self.MAX_WAVEFRONT_KERNEL
        return self.MAX_WAVEFRONT

    def render_wavefront(self, scene, sensor, sampler, seed, sample_base,
                         spp_pass, spp_total):
        mk = self._megakernel_for(scene, sensor)
        if mk is None:
            self.last_engine = None
            raise NotImplementedError(self.engine_reason)
        self.last_engine = "kernel"
        return mk.render_pass(seed, sample_base, spp_pass)

    def _megakernel_for(self, scene, sensor):
        """The scene's PathKernel, or None with ``engine_reason`` set."""
        cached = self._kernel_cache
        if cached is not None and cached[0] is scene and cached[1] is sensor:
            return cached[2]
        from ..models.rfilters import BoxFilter
        from ..models.sensors import PerspectiveCamera
        from ..ops.path_kernel import PathKernel, path_kernel_ineligibility
        if type(self) is not PathIntegrator:
            reason = "non-path integrator subclass"
        elif type(sensor) is not PerspectiveCamera:
            reason = f"sensor {type(sensor).__name__}"
        elif sensor.shutter_open != sensor.shutter_close:
            reason = "motion blur (open shutter)"
        elif type(sensor.film.rfilter) is not BoxFilter:
            reason = f"rfilter {type(sensor.film.rfilter).__name__}"
        else:
            reason = path_kernel_ineligibility(scene)
        mk = None
        if reason is None:
            mk = PathKernel(scene, sensor, self.max_depth, self.rr_depth)
        else:
            _log.Log(_log.Debug, f"path: outside the kernel's scope "
                     f"({reason})")
        self.engine_reason = reason
        self._kernel_cache = (scene, sensor, mk)
        return mk
