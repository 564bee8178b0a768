"""Fixture scenes (fork of mitsuba2_tpu/python/test/scenes.py, built with
this package's Transform)."""

from __future__ import annotations

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
