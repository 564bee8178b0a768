"""Fixture scenes (fork of mitsuba2_tpu/python/test/scenes.py, built with
this package's Transform)."""

from __future__ import annotations

import numpy as np

from ...core.transform import Transform


def cornell_box_dict(width=256, height=256, spp=64, max_depth=6,
                     rfilter="box", light_scale=1.0):
    """The classic Cornell box as a scene dict: 5 diffuse walls, 2 boxes
    and one area light (36 triangles)."""
    T = Transform

    def rect(name, to_world, albedo):
        return {
            "type": "rectangle",
            "id": name,
            "to_world": to_world,
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": albedo}},
        }

    white = [0.725, 0.71, 0.68]
    red = [0.570068, 0.0430135, 0.0443706]
    green = [0.105421, 0.37798, 0.076425]

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {
            "type": "perspective",
            "fov": 39.3077,
            "near_clip": 0.01,
            "far_clip": 100.0,
            "to_world": T.look_at([0, 0, 3.9], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": rfilter}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": rect("floor", T.translate([0, -1, 0])
                      @ T.rotate([1, 0, 0], -90), white),
        "ceiling": rect("ceiling", T.translate([0, 1, 0])
                        @ T.rotate([1, 0, 0], 90), white),
        "back": rect("back", T.translate([0, 0, -1]), white),
        "left": rect("left", T.translate([-1, 0, 0])
                     @ T.rotate([0, 1, 0], 90), red),
        "right": rect("right", T.translate([1, 0, 0])
                      @ T.rotate([0, 1, 0], -90), green),
        "light": {
            "type": "rectangle",
            "id": "light",
            "to_world": (T.translate([0, 0.99, 0]) @ T.rotate([1, 0, 0], 90)
                         @ T.scale(0.23)),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [0, 0, 0]}},
            "emitter": {
                "type": "area",
                "radiance": {"type": "rgb",
                             "value": [x * light_scale for x in
                                       [18.387, 13.9873, 6.75357]]},
            },
        },
        "tallbox": {
            "type": "cube",
            "to_world": (T.translate([-0.35, -0.4, -0.35])
                         @ T.rotate([0, 1, 0], 20)
                         @ T.scale([0.25, 0.6, 0.25])),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": white}},
        },
        "shortbox": {
            "type": "cube",
            "to_world": (T.translate([0.4, -0.7, 0.2])
                         @ T.rotate([0, 1, 0], -18)
                         @ T.scale([0.25, 0.3, 0.25])),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": white}},
        },
    }


def _sky_exr_path():
    """Synthesized lat-long sky HDR (cached in the temp directory): a
    gradient dome and a sun blob, the texels of mitsuba2_tpu's fixture
    sky, written by this package's own EXR writer to a file of its own."""
    import os
    import tempfile
    import numpy as np
    from ...utils.io_exr import write_exr
    path = os.path.join(tempfile.gettempdir(),
                        "mitsuba2_tpu_torch_sky_v1.exr")
    if not os.path.exists(path):
        h, w = 64, 128
        th = np.linspace(0, np.pi, h)[:, None]
        ph = np.linspace(0, 2 * np.pi, w)[None, :]
        sky = np.stack([
            0.25 + 0.35 * np.cos(th / 2) ** 2 + 0 * ph,
            0.35 + 0.40 * np.cos(th / 2) ** 2 + 0 * ph,
            0.55 + 0.45 * np.cos(th / 2) ** 2 + 0 * ph], -1)
        # sun: bright blob at theta=60deg, phi=45deg
        ang = (np.sin(th) * np.sin(np.pi / 3)
               * np.cos(ph - np.pi / 4)
               + np.cos(th) * np.cos(np.pi / 3))
        sun = np.clip(ang, 0, 1) ** 400
        sky = sky + sun[..., None] * np.asarray([900.0, 800.0, 600.0])
        # write beside and rename, so a concurrent reader never sees a
        # partial file
        tmp = f"{path}.{os.getpid()}.tmp"
        write_exr(tmp, sky.astype(np.float32))
        os.replace(tmp, path)
    return path


def matpreview_dict(width=256, height=256, spp=64, max_depth=6,
                    alpha=0.1, material="Au"):
    """The matpreview scene (bench.py's second config): a rough gold
    sphere on a rough aluminium stand above a checkerboard floor, lit only
    by an importance-sampled HDR sky (1 sphere, 14 triangles)."""
    T = Transform
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "envmap": {"type": "envmap", "filename": _sky_exr_path()},
        "hero": {"type": "sphere", "radius": 1.0, "center": [0, 0, 1.35],
                 "bsdf": {"type": "roughconductor", "alpha": alpha,
                          "distribution": "ggx", "material": material}},
        "stand": {"type": "cube",
                  "to_world": (T.translate([0, 0, 0.175])
                               @ T.scale([0.6, 0.6, 0.175])),
                  "bsdf": {"type": "roughconductor", "alpha": 0.3,
                           "distribution": "ggx", "material": "Al"}},
        "floor": {"type": "rectangle", "to_world": T.scale([8, 8, 1]),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {
                               "type": "checkerboard",
                               "color0": {"type": "rgb", "value": 0.4},
                               "color1": {"type": "rgb", "value": 0.2},
                               "to_uv": T.scale([8, 8, 1])}}},
        "sensor": {
            "type": "perspective", "fov": 34.0,
            "to_world": T.look_at(origin=[3.2, -3.8, 2.4],
                                  target=[0, 0, 1.0], up=[0, 0, 1]),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
    }


def volpath_slab_dict(width=256, height=256, spp=16, max_depth=16,
                      grid=None, albedo=0.8, g=0.3, **extra):
    """bench.py's volpath scene (``bench_volpath``): a null-BSDF 2x2x2 cube
    bounding a heterogeneous medium (sigma_t a 16^3 grid drawn from
    ``default_rng(0)`` in [0.2, 2.0] unless ``grid`` is given, rgb albedo,
    HG phase of anisotropy g) in front of a rectangular area light of
    radiance 4, seen by a 35-degree pinhole through a box filter, under
    ``volpath``. ``extra`` adds or replaces top-level entries."""
    T = Transform
    if grid is None:
        grid = np.random.default_rng(0).uniform(
            0.2, 2.0, (16, 16, 16)).astype(np.float32)
    d = {"type": "scene",
         "integrator": {"type": "volpath", "max_depth": max_depth},
         "slab": {"type": "cube", "bsdf": {"type": "null"},
                  "interior": {"type": "heterogeneous",
                               "sigma_t": {"type": "grid3d", "data": grid},
                               "albedo": {"type": "rgb",
                                          "value": [albedo] * 3},
                               "to_world": (T.translate([-1, -1, -1])
                                            @ T.scale(2.0)),
                               "phase": {"type": "hg", "g": g}}},
         "light": {"type": "rectangle",
                   "to_world": T.translate([0, 0, -2.5]) @ T.scale(2.0),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb",
                                            "value": [4.0] * 3}}},
         "sensor": {"type": "perspective", "fov": 35.0,
                    "to_world": T.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": width,
                             "height": height,
                             "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent",
                                "sample_count": spp}}}
    d.update(extra)
    return d
