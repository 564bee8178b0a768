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


def _write_once(path, write):
    """``path``, written by ``write(tmp)`` first if it does not exist: the
    file is written beside and renamed, so a concurrent reader (another
    test worker) never sees a partial file."""
    import os
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        write(tmp)
        os.replace(tmp, path)
    return path


def _sky_exr_path():
    """Synthesized lat-long sky HDR (cached in the temp directory): a
    gradient dome and a sun blob, the texels of mitsuba2_tpu's fixture
    sky, written by this package's own EXR writer to a file of its own."""
    import os
    import tempfile
    from ...utils.io_exr import write_exr
    path = os.path.join(tempfile.gettempdir(),
                        "mitsuba2_tpu_torch_sky_v1.exr")

    def write(tmp):
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
        write_exr(tmp, sky.astype(np.float32))

    return _write_once(path, write)


def _materials_texture_path():
    """Synthesized 64x64 albedo texture (cached in the temp directory under
    this package's own name): a red gradient along u, a green one along v
    and a blue 8x8-texel checker, as the reference's bitmap tests draw
    theirs (tests/test_megakernel.py:150-154), written by this package's
    EXR writer."""
    import os
    import tempfile
    from ...utils.io_exr import write_exr
    path = os.path.join(tempfile.gettempdir(),
                        "mitsuba2_tpu_torch_materials_v1.exr")

    def write(tmp):
        n = 64
        tex = np.zeros((n, n, 3), np.float32)
        tex[..., 0] = np.linspace(0.1, 0.9, n)[None, :]
        tex[..., 1] = np.linspace(0.8, 0.2, n)[:, None]
        tex[..., 2] = (np.add.outer(np.arange(n) // 8,
                                    np.arange(n) // 8) % 2) * 0.5 + 0.2
        write_exr(tmp, tex)

    return _write_once(path, write)


def cornell_materials_dict(width=256, height=256, spp=64, max_depth=6,
                           rfilter="gaussian", base=None, T=Transform):
    """The Cornell box with the reference's default film filter and the
    path kernel's other lobes and shapes: a glass tall box, a rough
    plastic short box (GGX, alpha 0.2), a plastic floor, a nonlinear
    plastic ceiling, a bitmap-textured back wall, and on the floor a
    textured disk rug and a plastic cylinder rod. ``base`` is the Cornell
    dict to edit (this package's ``cornell_box_dict`` by default) and
    ``T`` its Transform, so the same edits apply to another package's
    dict."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth, rfilter=rfilter)
    tex = {"type": "bitmap", "filename": _materials_texture_path()}

    def rgb(v):
        return {"type": "rgb", "value": v}

    d["tallbox"]["bsdf"] = {"type": "dielectric"}
    d["shortbox"]["bsdf"] = {"type": "roughplastic", "distribution": "ggx",
                             "alpha": 0.2,
                             "diffuse_reflectance": rgb([0.2, 0.4, 0.7])}
    d["floor"]["bsdf"] = {"type": "plastic",
                          "diffuse_reflectance": rgb([0.5, 0.2, 0.2])}
    d["ceiling"]["bsdf"] = {"type": "plastic", "nonlinear": True,
                            "diffuse_reflectance": rgb(0.8)}
    d["back"]["bsdf"] = {"type": "diffuse", "reflectance": dict(tex)}
    d["rug"] = {"type": "disk",
                "to_world": (T.translate([-0.3, -0.995, 0.55])
                             @ T.rotate([1, 0, 0], -90) @ T.scale(0.35)),
                "bsdf": {"type": "diffuse", "reflectance": dict(tex)}}
    d["rod"] = {"type": "cylinder", "radius": 0.1,
                "p0": [0.05, -0.9, 0.7], "p1": [0.75, -0.9, 0.7],
                "bsdf": {"type": "plastic",
                         "diffuse_reflectance": rgb([0.7, 0.6, 0.2])}}
    return d


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


def _bumpy_sphere_obj_path(nu=64, nv=48, bump=0.15, version=1):
    """Synthesized dense OBJ mesh (cached in the temp directory under this
    package's own name): a displaced UV sphere with 2 nu (nv - 1)
    triangles, the vertices, faces and text of mitsuba2_tpu's fixture
    (``mitsuba2_tpu/python/test/scenes.py:174``)."""
    import os
    import tempfile
    path = os.path.join(tempfile.gettempdir(),
                        f"mitsuba2_tpu_torch_bumpy_{nu}x{nv}_v{version}.obj")

    def write(tmp):
        th = np.linspace(0, np.pi, nv)
        ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        T, P = np.meshgrid(th, ph, indexing="ij")        # (nv, nu)
        r = 1.0 + bump * np.sin(6 * T) * np.cos(5 * P)
        x = r * np.sin(T) * np.cos(P)
        y = r * np.cos(T)
        z = r * np.sin(T) * np.sin(P)
        verts = np.stack([x, y, z], -1).reshape(-1, 3)   # (nv*nu, 3)
        faces = []
        for i in range(nv - 1):
            for j in range(nu):
                a = i * nu + j
                b = i * nu + (j + 1) % nu
                c = (i + 1) * nu + j
                d = (i + 1) * nu + (j + 1) % nu
                faces.append((a, b, d))
                faces.append((a, d, c))
        with open(tmp, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for a, b, c in faces:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")

    return _write_once(path, write)


def bumpy_sphere_dict(width=128, height=128, spp=32, max_depth=4,
                      nu=64, nv=48):
    """bench.py's biggeo scene (``bench.py:140-152`` renders it with nu=512,
    nv=257: 262,144 mesh faces): a displaced sphere loaded from an OBJ
    file over a diffuse floor under a rectangular area light, box filter."""
    T = Transform
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "hero": {"type": "obj", "filename": _bumpy_sphere_obj_path(nu, nv),
                 "to_world": T.translate([0, 0.2, 0]),
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "rgb",
                                          "value": [0.55, 0.35, 0.25]}}},
        "floor": {"type": "rectangle",
                  "to_world": (T.translate([0, -1.3, 0])
                               @ T.rotate([1, 0, 0], -90) @ T.scale(6)),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.5}}},
        "light": {"type": "rectangle",
                  "to_world": (T.translate([0, 3.5, 1.0]) @ T.scale(1.2)
                               @ T.rotate([1, 0, 0], 90)),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 10.0}}},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": T.look_at([0, 0.6, 4.2], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
    }


def _hero_serialized_path(nu=512, nv=200, bump=0.12, version=1):
    """Synthesized smooth-shaded hero mesh in the Mitsuba 0.x .serialized
    container (cached in the temp directory under this package's own
    name): 2 nu (nv - 1) triangles with area-weighted vertex normals and
    uvs, the arrays of mitsuba2_tpu's fixture
    (``mitsuba2_tpu/python/test/scenes.py:243``)."""
    import os
    import tempfile
    from ...utils.serialized import write_serialized
    path = os.path.join(tempfile.gettempdir(),
                        f"mitsuba2_tpu_torch_hero_{nu}x{nv}_v{version}"
                        ".serialized")

    def write(tmp):
        th = np.linspace(0, np.pi, nv)
        ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        T, P = np.meshgrid(th, ph, indexing="ij")        # (nv, nu)
        r = 1.0 + bump * (np.sin(6 * T) * np.cos(5 * P)
                          + 0.4 * np.sin(13 * T + 2.0) * np.sin(11 * P))
        x = r * np.sin(T) * np.cos(P)
        y = r * np.cos(T)
        z = r * np.sin(T) * np.sin(P)
        verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
        uv = np.stack([P / (2 * np.pi), T / np.pi],
                      -1).reshape(-1, 2).astype(np.float32)
        idx = np.arange(nv * nu).reshape(nv, nu)
        a = idx[:-1, :]
        b = np.roll(idx[:-1, :], -1, axis=1)
        c = idx[1:, :]
        d = np.roll(idx[1:, :], -1, axis=1)
        faces = np.concatenate([
            np.stack([a, b, d], -1).reshape(-1, 3),
            np.stack([a, d, c], -1).reshape(-1, 3)]).astype(np.int32)
        # smooth vertex normals: area-weighted sum of face normals
        fv = verts[faces]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        normals = np.zeros_like(verts)
        for k in range(3):
            np.add.at(normals, faces[:, k], fn)
        nl = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = (normals / np.maximum(nl, 1e-20)).astype(np.float32)
        write_serialized(tmp, [(verts, faces, normals, uv)])

    return _write_once(path, write)


def hero_serialized_dict(width=256, height=256, spp=32, max_depth=5,
                         nu=512, nv=200):
    """bench.py's hero scene (``bench.py:125-137``; 203,776 mesh faces at
    the default nu=512, nv=200): a smooth-shaded .serialized mesh with a
    GGX gold finish under the importance-sampled sky, on a checkerboard
    floor, box filter. ``nu`` and ``nv`` size the mesh."""
    T = Transform
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "envmap": {"type": "envmap", "filename": _sky_exr_path()},
        "hero": {"type": "serialized",
                 "filename": _hero_serialized_path(nu, nv),
                 "to_world": T.translate([0, 0, 1.1]),
                 "bsdf": {"type": "roughconductor", "alpha": 0.12,
                          "distribution": "ggx", "material": "Au"}},
        "floor": {"type": "rectangle",
                  "to_world": (T.translate([0, 0, -0.15])
                               @ T.scale([8, 8, 1])),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {
                               "type": "checkerboard",
                               "color0": {"type": "rgb", "value": 0.45},
                               "color1": {"type": "rgb", "value": 0.2},
                               "to_uv": T.scale([8, 8, 1])}}},
        "sensor": {
            "type": "perspective", "fov": 36.0,
            "to_world": T.look_at(origin=[3.1, -3.7, 2.6],
                                  target=[0, 0, 0.9], up=[0, 0, 1]),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp}},
    }


def _surface_maps_path(kind):
    """Synthesized 64x64 surface maps (cached in the temp directory under
    this package's own name), written by this package's EXR writer:
    ``height``, a bump height field of crossed sines in [0.25, 0.75]
    (one channel, repeated); ``normal``, a tangent-space normal map of
    tilts along u and v, encoded as (n + 1) / 2."""
    import os
    import tempfile
    from ...utils.io_exr import write_exr
    path = os.path.join(tempfile.gettempdir(),
                        f"mitsuba2_tpu_torch_{kind}_map_v1.exr")

    def write(tmp):
        n = 64
        u = (np.arange(n) + 0.5) / n
        U, V = np.meshgrid(u, u)                  # U along the width
        if kind == "height":
            h = 0.5 + 0.25 * np.sin(2 * np.pi * 6 * U) \
                * np.sin(2 * np.pi * 6 * V)
            img = np.repeat(h[..., None], 3, -1)
        else:
            nrm = np.stack([0.35 * np.sin(2 * np.pi * 5 * U),
                            0.35 * np.cos(2 * np.pi * 3 * V),
                            np.ones_like(U)], -1)
            nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
            img = 0.5 * nrm + 0.5
        write_exr(tmp, img.astype(np.float32))

    return _write_once(path, write)


def cornell_surfaces_dict(width=256, height=256, spp=64, max_depth=6,
                          base=None, T=Transform):
    """The Cornell box with the surfaces users write (Mitsuba's own cbox
    scene writes its walls ``twosided``): the ceiling and the side walls
    ``twosided`` over ``diffuse``, the floor a ``bumpmap`` (a bitmap
    height field) and the back wall a ``normalmap`` (a ``raw`` bitmap),
    each over ``diffuse``; the tall box ``roughdielectric`` (GGX, alpha
    0.1), standing on the floor as in the bench's box; the short box a
    ``blendbsdf`` of a gold ``conductor`` and a ``diffuse`` by a
    checkerboard weight; a ``thindielectric`` pane, a
    ``mask`` card (a checkerboard opacity) and a copper ``conductor``
    panel on the left wall; the area light as before. ``base`` is the
    Cornell dict to edit (this package's ``cornell_box_dict`` by default)
    and ``T`` its Transform, so the same edits apply to another package's
    dict."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)

    def rgb(v):
        return {"type": "rgb", "value": v}

    def diffuse(v):
        return {"type": "diffuse", "reflectance": rgb(v)}

    def checker(c0, c1, n):
        return {"type": "checkerboard", "color0": rgb(c0), "color1": rgb(c1),
                "to_uv": T.scale([n, n, 1])}

    for wall in ("ceiling", "left", "right"):
        d[wall]["bsdf"] = {"type": "twosided", "material": d[wall]["bsdf"]}
    d["floor"]["bsdf"] = {
        "type": "bumpmap", "scale": 0.02,
        "height": {"type": "bitmap", "raw": True,
                   "filename": _surface_maps_path("height")},
        "material": diffuse([0.725, 0.71, 0.68])}
    d["back"]["bsdf"] = {
        "type": "normalmap",
        "normals": {"type": "bitmap", "raw": True,
                    "filename": _surface_maps_path("normal")},
        "material": diffuse([0.725, 0.71, 0.68])}
    d["tallbox"]["bsdf"] = {"type": "roughdielectric",
                            "distribution": "ggx", "alpha": 0.1}
    d["shortbox"]["bsdf"] = {
        "type": "blendbsdf", "weight": checker(0.85, 0.15, 4),
        "bsdf_0": {"type": "conductor", "material": "Au"},
        "bsdf_1": diffuse([0.2, 0.4, 0.7])}
    d["pane"] = {"type": "rectangle",
                 "to_world": (T.translate([0.45, 0.3, 0.55])
                              @ T.rotate([0, 1, 0], -15) @ T.scale(0.22)),
                 "bsdf": {"type": "thindielectric"}}
    d["card"] = {"type": "rectangle",
                 "to_world": (T.translate([-0.4, 0.3, 0.5])
                              @ T.rotate([0, 1, 0], 20) @ T.scale(0.22)),
                 "bsdf": {"type": "mask", "opacity": checker(1.0, 0.0, 4),
                          "material": diffuse([0.8, 0.5, 0.1])}}
    d["panel"] = {"type": "rectangle",
                  "to_world": (T.translate([-0.98, 0.25, -0.35])
                               @ T.rotate([0, 1, 0], 90)
                               @ T.scale([0.4, 0.35, 1.0])),
                  "bsdf": {"type": "conductor", "material": "Cu"}}
    return d


def cornell_lights_dict(width=256, height=256, spp=64, max_depth=6,
                        base=None, T=Transform):
    """The Cornell box's diffuse walls lit by the emitters users write
    instead of its area light: a ``spot`` whose intensity is a 2000 K
    ``blackbody``, a ``point`` whose intensity is an ``irregular`` curve in
    the dict's list form, a ``projector`` throwing a bitmap onto the back
    wall, a ``directional`` light in through the open front and a
    ``constant`` environment of ``uniform`` radiance seen around the box;
    the left wall's reflectance a ``regular`` spectrum. ``base`` and
    ``T`` as ``cornell_surfaces_dict``."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    del d["light"]
    d["left"]["bsdf"]["reflectance"] = {
        "type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
        "values": "0.05, 0.08, 0.3, 0.7"}
    d["spot"] = {"type": "spot", "cutoff_angle": 40.0, "beam_width": 25.0,
                 "to_world": T.look_at([0.0, 0.95, -0.1], [0.0, -1.0, -0.1],
                                       [0, 0, 1]),
                 "intensity": {"type": "blackbody", "temperature": 2000.0}}
    d["point"] = {"type": "point", "position": [0.55, 0.55, 0.45],
                  "intensity": {"type": "spectrum", "value": [
                      (400.0, 0.4), (480.0, 1.2), (560.0, 2.0),
                      (640.0, 2.6), (720.0, 1.0)]}}
    d["projector"] = {"type": "projector", "fov": 45.0, "scale": 2.5,
                      "to_world": T.look_at([0.0, 0.1, 0.95],
                                            [0.0, 0.1, -1.0], [0, 1, 0]),
                      "irradiance": {"type": "bitmap",
                                     "filename": _materials_texture_path()}}
    d["sun"] = {"type": "directional", "direction": [-0.3, -0.4, -1.0],
                "irradiance": {"type": "rgb", "value": [1.2, 1.05, 0.8]}}
    d["sky"] = {"type": "constant",
                "radiance": {"type": "spectrum", "value": 0.35}}
    return d


def fog_spot_dict(width=32, height=32, spp=4, max_depth=8,
                  integrator="volpath", T=Transform):
    """Delta emitters in fog: a null cube bounding a chromatic
    ``homogeneous`` medium (isotropic phase) with a ``spot`` and a
    ``point`` inside it, a diffuse floor and a ``mask`` card (a
    checkerboard opacity over diffuse) in the medium, seen through a
    35-degree pinhole and a box filter, under ``integrator``."""
    def rgb(v):
        return {"type": "rgb", "value": v}

    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "fog": {"type": "cube", "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous", "sigma_t":
                             rgb([0.35, 0.5, 0.7]), "albedo": rgb(0.8),
                             "phase": {"type": "isotropic"}}},
        "floor": {"type": "rectangle",
                  "to_world": (T.translate([0, -0.9, 0])
                               @ T.rotate([1, 0, 0], -90) @ T.scale(0.9)),
                  "bsdf": {"type": "diffuse", "reflectance": rgb(0.6)}},
        "card": {"type": "rectangle",
                 "to_world": (T.translate([0.15, -0.2, 0.2])
                              @ T.rotate([0, 1, 0], 25) @ T.scale(0.45)),
                 "bsdf": {"type": "mask", "opacity": {
                     "type": "checkerboard", "color0": rgb(1.0),
                     "color1": rgb(0.0), "to_uv": T.scale([3, 3, 1])},
                     "material": {"type": "diffuse",
                                  "reflectance": rgb([0.8, 0.4, 0.1])}}},
        "spot": {"type": "spot", "cutoff_angle": 30.0,
                 "to_world": T.look_at([0.0, 0.8, 0.0], [0.0, -1.0, 0.0],
                                       [0, 0, 1]),
                 "intensity": rgb([4.0, 3.5, 3.0])},
        "point": {"type": "point", "position": [-0.5, 0.3, 0.4],
                  "intensity": rgb(1.5)},
        "sensor": {"type": "perspective", "fov": 35.0,
                   "to_world": T.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": width,
                            "height": height, "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
    }


def cornell_thinlens_dict(width=256, height=256, spp=64, max_depth=6,
                          base=None, T=Transform):
    """The Cornell box through a ``thinlens`` camera (aperture radius
    0.05, focused at 3.9, the camera's distance to the box's centre) and
    an ``ldsampler``. ``base`` and ``T`` as ``cornell_surfaces_dict``."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["sensor"]["type"] = "thinlens"
    d["sensor"]["aperture_radius"] = 0.05
    d["sensor"]["focus_distance"] = 3.9
    d["sensor"]["sampler"]["type"] = "ldsampler"
    return d


def cornell_direct_dict(width=256, height=256, spp=64, max_depth=6,
                        base=None, T=Transform):
    """The Cornell box under the ``direct`` integrator (one emitter and
    one BSDF sample) and a ``stratified`` sampler."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["integrator"] = {"type": "direct"}
    d["sensor"]["sampler"]["type"] = "stratified"
    return d


# the AOVs of cornell_aov_dict: 1 + 3 + 3 + 2 channels, then the nested
# path's rgb
CORNELL_AOVS = "dd:depth,nn:sh_normal,pp:position,uv:uv"


def cornell_aov_dict(width=256, height=256, spp=16, max_depth=6,
                     base=None, T=Transform):
    """The Cornell box under ``aov`` (``CORNELL_AOVS`` over a nested
    ``path``) and a ``multijitter`` sampler."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["integrator"] = {"type": "aov", "aovs": CORNELL_AOVS,
                       "image": {"type": "path", "max_depth": max_depth}}
    d["sensor"]["sampler"]["type"] = "multijitter"
    return d


def cornell_moment_dict(width=256, height=256, spp=64, max_depth=6,
                        base=None, T=Transform):
    """The Cornell box under ``moment`` over a nested ``path`` and an
    ``orthogonal`` sampler (p = 8 at 64 spp)."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["integrator"] = {"type": "moment",
                       "image": {"type": "path", "max_depth": max_depth}}
    d["sensor"]["sampler"]["type"] = "orthogonal"
    return d


# the back wall's corner colors in cornell_mesh_attribute_dict
BACK_WALL_COLORS = np.asarray([[0.85, 0.2, 0.2], [0.2, 0.85, 0.2],
                               [0.2, 0.2, 0.85], [0.85, 0.85, 0.2]],
                              np.float32)


def cornell_mesh_attribute_dict(width=256, height=256, spp=64, max_depth=6,
                                base=None, T=Transform, load_dict=None):
    """The Cornell box whose back wall's reflectance is a
    ``mesh_attribute`` texture of its ``vertex_color`` attribute, set
    with ``add_attribute`` (``BACK_WALL_COLORS`` at its four corners): the
    wall is loaded on its own through ``load_dict`` (this package's by
    default; another package's for its dict ``base``) and put in the dict
    as a shape object."""
    if load_dict is None:
        from ... import load_dict
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    back = dict(d["back"])
    back["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "mesh_attribute", "name": "vertex_color"}}
    mesh = load_dict(back).expand()[0]
    mesh.add_attribute("vertex_color", 3, BACK_WALL_COLORS)
    d["back"] = mesh
    return d


def cornell_xml_path(width=256, height=256, spp=64, max_depth=6):
    """``cornell_box_dict`` written as Mitsuba XML by this package's
    ``dict_to_xml`` (cached in the temp directory under this package's own
    name) -> its path, for ``load_file``. The writer rounds floats to
    ``%.6g``, so the file's scene is the dict's within that rounding."""
    import os
    import tempfile
    from ..xml import dict_to_xml
    path = os.path.join(
        tempfile.gettempdir(), f"mitsuba2_tpu_torch_cornell_{width}x"
        f"{height}_{spp}spp_d{max_depth}_v1.xml")
    return _write_once(path, lambda tmp: dict_to_xml(
        cornell_box_dict(width, height, spp, max_depth), tmp))


def bumpy_sphere_ply_path(nu=64, nv=48):
    """The bumpy sphere of ``_bumpy_sphere_obj_path(nu, nv)`` as a binary
    little-endian PLY file (cached in the temp directory): the vertices
    and faces this package's OBJ loader reads from that file, written as
    float32 and int32, so the PLY's mesh is the OBJ's bit for bit, and a
    ``vertex_color`` attribute (uchar red, green, blue of the vertex's
    position)."""
    import os
    import tempfile
    from ...utils.io_obj import load_obj
    path = os.path.join(tempfile.gettempdir(),
                        f"mitsuba2_tpu_torch_bumpy_{nu}x{nv}_v1.ply")

    def write(tmp):
        v, f, _, _ = load_obj(_bumpy_sphere_obj_path(nu, nv))
        rgb = np.clip((v + 1.2) / 2.4 * 255.0 + 0.5, 0, 255).astype(np.uint8)
        vert = np.zeros(len(v), np.dtype(
            [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
             ("green", "u1"), ("blue", "u1")]))
        for k, name in enumerate("xyz"):
            vert[name] = v[:, k]
        for k, name in enumerate(("red", "green", "blue")):
            vert[name] = rgb[:, k]
        face = np.zeros(len(f), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
        face["n"] = 3
        face["i"] = f
        with open(tmp, "wb") as out:
            out.write(
                b"ply\nformat binary_little_endian 1.0\n"
                b"comment mitsuba2_tpu_torch bumpy sphere\n"
                + f"element vertex {len(v)}\n".encode()
                + b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\n"
                + f"element face {len(f)}\n".encode()
                + b"property list uchar int vertex_indices\nend_header\n")
            out.write(vert.tobytes())
            out.write(face.tobytes())

    return _write_once(path, write)


def instanced_spheres_dict(n_inst=3, materialize=None, nu=40, nv=20,
                           width=24, height=24, spp=32, max_depth=3,
                           T=Transform, filename=None):
    """The instancing scene of the JAX tests (tests/test_instancing.py:
    13-50): a floor and a rectangular area light, and ``n_inst`` instances
    of one shapegroup, a bumpy sphere (``_bumpy_sphere_obj_path(nu, nv)``,
    2 nu (nv - 1) faces) scaled by 0.45 in diffuse terracotta, in a row
    along x; ``materialize`` is each instance's property (None: absent,
    the group's size decides). ``T`` is the Transform and ``filename`` the
    OBJ file of the package the dict is for (this package's by
    default)."""
    group = {"type": "shapegroup", "id": "grp",
             "m": {"type": "obj",
                   "filename": filename or _bumpy_sphere_obj_path(nu, nv),
                   "to_world": T.scale(0.45),
                   "bsdf": {"type": "diffuse",
                            "reflectance": {"type": "rgb",
                                            "value": [0.6, 0.4, 0.3]}}}}
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": max_depth},
         "grp": group,
         "light": {"type": "rectangle",
                   "to_world": (T.translate([0, 3, 1]) @ T.scale(1.5)
                                @ T.rotate([1, 0, 0], 90)),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb", "value": 10.0}}},
         "floor": {"type": "rectangle",
                   "to_world": (T.translate([0, -1, 0])
                                @ T.rotate([1, 0, 0], -90) @ T.scale(4)),
                   "bsdf": {"type": "diffuse",
                            "reflectance": {"type": "rgb", "value": 0.5}}},
         "sensor": {"type": "perspective", "fov": 50,
                    "to_world": T.look_at([0, 0.8, 4.5], [0, 0, 0],
                                          [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": width,
                             "height": height, "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent",
                                "sample_count": spp}}}
    for i in range(n_inst):
        x = -1.4 + 2.8 * i / max(n_inst - 1, 1)
        inst = {"type": "instance",
                "shapegroup": {"type": "ref", "id": "grp"},
                "to_world": T.translate([x, 0, 0])}
        if materialize is not None:
            inst["materialize"] = materialize
        d[f"i{i}"] = inst
    return d


def measured_ggx_path(alpha=0.4, res=48, n_theta=16):
    """An RGL-layout tensor file of an analytic GGX material (the JAX
    tests' synthesized file, tests/test_measured.py:12-72; cached in the
    temp directory): ``res``^2 tables over ``n_theta`` incident angles, the
    NDF, its projected area sigma, the visible-NDF warp with the square's
    jacobian, a uniform luminance warp and flat unit spectra over four
    wavelengths -> its path, for the ``measured`` BSDF."""
    import os
    import tempfile
    from ...utils.tensorfile import write_tensor_file
    path = os.path.join(tempfile.gettempdir(), f"mitsuba2_tpu_torch_ggx_"
                        f"a{alpha}_{res}_{n_theta}_v1.bsdf")

    def write(tmp):
        theta_i = np.linspace(0, np.pi / 2 * 0.98, n_theta).astype(np.float32)
        uu = np.linspace(0, 1, res)
        tm = uu ** 2 * (np.pi / 2)
        pm = (2 * np.linspace(0, 1, res) - 1) * np.pi
        ct = np.cos(tm)
        a2 = alpha * alpha
        D = a2 / (np.pi * ((ct ** 2) * (a2 - 1) + 1) ** 2)
        ndf = np.tile(D[None, :], (res, 1)).astype(np.float32)
        tg, pg = np.meshgrid(tm, pm, indexing="ij")
        mx = np.sin(tg) * np.cos(pg)
        my = np.sin(tg) * np.sin(pg)
        mz = np.cos(tg)
        Dg = a2 / (np.pi * ((mz ** 2) * (a2 - 1) + 1) ** 2)
        dA = np.gradient(tm)[:, None] * np.gradient(pm)[None, :] * np.sin(tg)
        sigma = np.zeros((res, res), np.float32)
        for i, th in enumerate(tm):
            w = np.asarray([np.sin(th), 0, np.cos(th)])
            proj = np.maximum(0.0, mx * w[0] + my * w[1] + mz * w[2])
            sigma[:, i] = (Dg * proj * dA).sum()
        vndf = np.zeros((1, n_theta, res, res), np.float32)
        lum = np.ones((1, n_theta, res, res), np.float32)
        jac_u = (np.pi * uu)[None, :] * np.sin(tg) * 2 * np.pi
        for k, th in enumerate(theta_i):
            w = np.asarray([np.sin(th), 0, np.cos(th)])
            proj = np.maximum(0.0, mx * w[0] + my * w[1] + mz * w[2])
            vndf[0, k] = (Dg * proj * jac_u).astype(np.float32)
        wav = np.linspace(400, 700, 4).astype(np.float32)
        write_tensor_file(tmp, {
            "theta_i": theta_i, "phi_i": np.asarray([0.0], np.float32),
            "ndf": ndf, "sigma": sigma, "vndf": vndf, "luminance": lum,
            "spectra": np.ones((1, n_theta, 4, res, res), np.float32),
            "wavelengths": wav,
            "description": np.frombuffer(b"synthetic ggx", np.uint8),
            "jacobian": np.asarray([1], np.uint8)})

    return _write_once(path, write)


def kaist_pbrdf_path(eta=1.5, alpha=0.25, diffuse=0.2):
    """A KAIST-layout pBRDF tensor file (cached in the temp directory):
    Mueller matrices M (9, 8, 8, 5, 4, 4) over phi_d, theta_d, theta_h
    and five wavelength bands (450-650 nm), a depolarizing diffuse part
    ``diffuse`` / pi (reddening with the wavelength) plus the polarized
    Fresnel reflection of a dielectric of IOR ``eta`` at theta_d
    (``render/mueller.py specular_reflection``) under a GGX lobe of
    ``alpha`` in theta_h, so that S1 and S2 of reflected light are not
    zero -> its path, for ``measured_polarized``."""
    import os
    import tempfile
    import torch
    from ...render import mueller as mu
    from ...utils.tensorfile import write_tensor_file
    path = os.path.join(tempfile.gettempdir(), f"mitsuba2_tpu_torch_kaist_"
                        f"e{eta}_a{alpha}_d{diffuse}_v1.bsdf")

    def write(tmp):
        P, D, H = 9, 8, 8
        phi_d = np.linspace(0, 2 * np.pi, P, dtype=np.float32)
        theta_d = np.linspace(0, np.pi / 2, D, dtype=np.float32)
        theta_h = np.linspace(0, np.pi / 2, H, dtype=np.float32)
        wvls = np.array([450, 500, 550, 600, 650], np.uint16)
        F = mu.specular_reflection(torch.as_tensor(np.cos(theta_d)),
                                   eta).numpy()                 # (D, 4, 4)
        a2 = alpha * alpha
        ggx = a2 / (np.pi * ((np.cos(theta_h) ** 2) * (a2 - 1) + 1) ** 2)
        M = np.zeros((P, D, H, len(wvls), 4, 4), np.float32)
        for iw, w in enumerate(wvls):
            rho = diffuse * (0.5 + (float(w) - 450.0) / 400.0)
            M[:, :, :, iw] = (F[None, :, None] * (0.25 * ggx)[None, None, :,
                                                              None, None])
            M[:, :, :, iw, 0, 0] += rho / np.pi
        write_tensor_file(tmp, {
            "phi_d": phi_d.reshape(1, -1), "theta_d": theta_d.reshape(1, -1),
            "theta_h": theta_h.reshape(1, -1), "wvls": wvls, "M": M})

    return _write_once(path, write)


def cornell_stokes_dict(width=256, height=256, spp=64, max_depth=6,
                        base=None, T=Transform):
    """The Cornell box under the ``stokes`` integrator with the four
    polarizing BSDFs: a ``polarizer`` pane (theta 0) just under the
    ceiling light, a ``retarder`` pane (delta 90, theta 45) before the
    short box, a left-handed ``circular`` pane before the tall box, and
    the tall box in ``pplastic``; so S1, S2 and S3 are each non-zero
    somewhere in the image. ``base`` and ``T`` as
    ``cornell_surfaces_dict``."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["integrator"] = {"type": "stokes", "max_depth": max_depth}
    d["polarizer"] = {"type": "rectangle",
                      "to_world": (T.translate([0, 0.9, 0])
                                   @ T.rotate([1, 0, 0], 90) @ T.scale(0.3)),
                      "bsdf": {"type": "polarizer", "theta": 0.0}}
    d["retarder"] = {"type": "rectangle",
                     "to_world": (T.translate([0.4, -0.65, 0.6])
                                  @ T.scale([0.3, 0.35, 1.0])),
                     "bsdf": {"type": "retarder", "theta": 45.0,
                              "delta": 90.0}}
    d["circular"] = {"type": "rectangle",
                     "to_world": (T.translate([-0.35, -0.4, 0.05])
                                  @ T.scale([0.3, 0.6, 1.0])),
                     "bsdf": {"type": "circular", "left_handed": True}}
    d["tallbox"]["bsdf"] = {
        "type": "pplastic",
        "diffuse_reflectance": {"type": "rgb", "value": [0.2, 0.3, 0.6]}}
    return d


def cornell_measured_dict(width=256, height=256, spp=64, max_depth=6,
                          base=None, T=Transform):
    """The Cornell box under ``path`` with the tall box ``measured`` (the
    GGX file of ``measured_ggx_path``) and the short box
    ``measured_polarized`` (``kaist_pbrdf_path``; its ``wavelength``, 550
    nm, is read outside spectral variants). ``base`` and ``T`` as
    ``cornell_surfaces_dict``."""
    d = base if base is not None else cornell_box_dict(
        width, height, spp, max_depth)
    d["tallbox"]["bsdf"] = {"type": "measured",
                            "filename": measured_ggx_path()}
    d["shortbox"]["bsdf"] = {"type": "measured_polarized",
                             "filename": kaist_pbrdf_path(),
                             "wavelength": 550.0}
    return d
