"""Sensors (reference: include/mitsuba/render/sensor.h:16 Sensor,
sensor.h:155 ProjectiveCamera; counterpart of
``mitsuba2_tpu.render.sensor``)."""

from __future__ import annotations

from ..core.object import Object
from ..core.ray import RayDifferential


class Sensor(Object):
    def __init__(self, props=None):
        super().__init__(props)
        film = None
        sampler = None
        if props is not None:
            for _, obj in props.objects():
                kind = getattr(obj, "plugin_category", "")
                if kind == "film":
                    film = obj
                elif kind == "sampler":
                    sampler = obj
        if film is None:
            from ..models.films import HDRFilm
            from ..core.properties import Properties
            film = HDRFilm(Properties("hdrfilm"))
        if sampler is None:
            from ..render.sampler import Sampler
            sampler = Sampler()
        self.film = film
        self.sampler = sampler
        # set_crop_window rebuilds the cameras that expose this film
        film._sensors.add(self)
        self.shutter_open = props.float_("shutter_open", 0.0) \
            if props else 0.0
        self.shutter_close = props.float_("shutter_close", 0.0) \
            if props else 0.0

    def traverse(self, cb):
        cb.put_object("film", self.film)

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample, active=True):
        """Rays for film positions (n, 2) in [0, 1]^2 over the crop
        window -> (Ray, its spectral weight (n, C), hero wavelengths (n, 4)
        or None); ``wavelength_sample`` (n,) draws the wavelengths in
        spectral variants, ``aperture_sample`` (n, 2) the point on a
        lens or a direction (sensor.h sample_ray)."""
        raise NotImplementedError

    def sample_ray_differential(self, time, wavelength_sample,
                                position_sample, aperture_sample,
                                active=True):
        """``sample_ray`` with finite-difference neighbours one crop pixel
        over in x and in y (sensor.cpp sample_ray_differential) -> (a
        RayDifferential, the spectral weight, the wavelengths), as
        ``sample_ray`` returns its ray's."""
        ray, weight, wav = self.sample_ray(time, wavelength_sample,
                                           position_sample, aperture_sample,
                                           active)
        w, h = self.film.crop_size
        ray_x = self.sample_ray(time, wavelength_sample,
                                position_sample
                                + position_sample.new_tensor([1.0 / w, 0.0]),
                                aperture_sample, active)[0]
        ray_y = self.sample_ray(time, wavelength_sample,
                                position_sample
                                + position_sample.new_tensor([0.0, 1.0 / h]),
                                aperture_sample, active)[0]
        return RayDifferential(ray, ray_x.o, ray_y.o, ray_x.d, ray_y.d,
                               True), weight, wav

    def needs_aperture_sample(self) -> bool:
        return False

    def film_changed(self):
        """Called by ``Film.set_crop_window``: a camera rebuilds what it
        derived from the film's window."""


class ProjectiveCamera(Sensor):
    """(sensor.h:155) adds near/far clip and focus distance."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        self.near_clip = p.float_("near_clip", 1e-2) if p else 1e-2
        self.far_clip = p.float_("far_clip", 1e4) if p else 1e4
        self.focus_distance = p.float_("focus_distance", self.far_clip) \
            if p else 1e4
        from ..core.transform import Transform
        self.world_transform = p.transform("to_world", Transform.identity()) \
            if p else Transform.identity()
