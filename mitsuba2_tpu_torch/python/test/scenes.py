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
