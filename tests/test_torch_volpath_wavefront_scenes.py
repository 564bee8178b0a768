"""The volpath wavefront against the JAX wavefront on the scenes beyond the
bench slab (tests/test_torch_volpath_wavefront.py has the bar and the
helpers): a homogeneous medium (rgb, mono and spectral: its textures at
the lanes' wavelengths), a diffuse sphere and a glass cube inside
the slab's medium, two media side by side, an albedo grid, an envmap and
the vacuum Cornell box, each at most 16^2 x 4 and each JAX render once.
"""

import numpy as np
import pytest

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import (jax_trips, slab,
                                                volpath_pair)

_on_cpu = cpu_device_fixture()
_jax_trips = jax_trips


def homogeneous(T):
    """A chromatic homogeneous medium: the hero channel picks the
    majorant, so the other channels' free-flight pdfs differ."""
    return {"type": "homogeneous",
            "sigma_t": {"type": "rgb", "value": [0.5, 0.9, 1.4]},
            "albedo": {"type": "rgb", "value": [0.9, 0.7, 0.5]},
            "phase": {"type": "hg", "g": -0.4}}


def objects(T):
    """A diffuse sphere and a glass cube inside the slab: surface NEE from
    inside the medium through its null boundary, and the medium
    transitions out of and back into the medium at the glass (its
    exterior is the slab's medium, by reference)."""
    return {"ball": {"type": "sphere", "radius": 0.35,
                     "center": [-0.45, 0.1, 0.2],
                     "bsdf": {"type": "diffuse",
                              "reflectance": {"type": "rgb",
                                              "value": [0.7, 0.3, 0.2]}}},
            "glass": {"type": "cube",
                      "to_world": T.translate([0.45, -0.2, 0.1])
                      @ T.scale(0.3),
                      "bsdf": {"type": "dielectric"},
                      "exterior": {"type": "ref", "id": "fog"}}}


def fog(T):
    grid = np.random.default_rng(0).uniform(
        0.2, 2.0, (16, 16, 16)).astype(np.float32)
    return {"type": "heterogeneous", "id": "fog",
            "sigma_t": {"type": "grid3d", "data": grid},
            "albedo": {"type": "rgb", "value": [0.8] * 3},
            "to_world": T.translate([-1, -1, -1]) @ T.scale(2.0),
            "phase": {"type": "hg", "g": 0.3}}


def two_media(T):
    """A second, homogeneous slab beside the first, which shrinks to the
    left half: lanes pass from one medium into the other."""
    return {"slab2": {"type": "cube", "bsdf": {"type": "null"},
                      "to_world": T.translate([0.6, 0, 0])
                      @ T.scale([0.5, 1.0, 1.0]),
                      "interior": homogeneous(T)}}


def albedo_grid(T):
    """A 3-channel albedo grid over the slab's medium."""
    grid = np.random.default_rng(0).uniform(
        0.2, 2.0, (16, 16, 16)).astype(np.float32)
    albedo = np.random.default_rng(1).uniform(
        0.3, 0.95, (4, 6, 5, 3)).astype(np.float32)
    return {"type": "heterogeneous",
            "sigma_t": {"type": "grid3d", "data": grid},
            "albedo": {"type": "grid3d", "data": albedo},
            "to_world": T.translate([-1, -1, -1]) @ T.scale(2.0)}


def sky(pkg):
    if pkg is mt:
        from mitsuba2_tpu_torch.python.test.scenes import _sky_exr_path
    else:
        from mitsuba2_tpu.python.test.scenes import _sky_exr_path
    return {"sky": {"type": "envmap", "filename": _sky_exr_path()}}


def _scenes():
    def left_slab(pkg, width, spp):
        d = slab(pkg, width, spp, extra=two_media)
        T = pkg.Transform
        d["slab"]["to_world"] = T.translate([-0.6, 0, 0]) \
            @ T.scale([0.5, 1.0, 1.0])
        return d

    def with_objects(pkg, width, spp):
        d = {"fog": fog(pkg.Transform)}
        d.update(slab(pkg, width, spp, extra=objects))
        d["slab"]["interior"] = {"type": "ref", "id": "fog"}
        return d

    # (dict of (package, width, spp), variant, the kernel gate's reason);
    # no lane of these scenes parts from the JAX wavefront's
    return {
        "homogeneous": (lambda pkg, w, s: slab(
            pkg, w, s, integrator="volpathmis", box=True,
            medium=homogeneous), "scalar_rgb",
            "medium HomogeneousMedium (heterogeneous only)"),
        "homogeneous mono": (lambda pkg, w, s: slab(
            pkg, w, s, box=True, medium=homogeneous), "scalar_mono",
            "non-rgb variant"),
        # the spectral MIS arm where the channels' extinctions differ:
        # the heterogeneous medium's majorant is one for every channel,
        # so there its free-flight pdf ratios are all one
        "homogeneous spectral volpathmis": (lambda pkg, w, s: slab(
            pkg, w, s, integrator="volpathmis", box=True,
            medium=homogeneous), "scalar_spectral", "non-rgb variant"),
        "sphere and glass in the medium": (
            with_objects, "scalar_rgb", "rfilter GaussianFilter"),
        "two media": (left_slab, "scalar_rgb", "rfilter GaussianFilter"),
        "albedo grid": (lambda pkg, w, s: slab(
            pkg, w, s, box=True, medium=albedo_grid), "scalar_rgb",
            "non-constant medium albedo"),
        "envmap": (lambda pkg, w, s: slab(pkg, w, s, box=True, extra=(
            lambda T: sky(pkg))), "scalar_rgb", "environment emitter"),
    }


@pytest.mark.parametrize("case", sorted(_scenes()))
def test_scene_matches_jax_wavefront(_jax_trips, case):
    make, variant, reason = _scenes()[case]
    volpath_pair(_jax_trips, lambda pkg: make(pkg, 12, 4), variant, 4,
                 reason=reason)


def test_vacuum_cornell_matches_jax_wavefront(_jax_trips):
    """``volpath`` without media: the shadow rays go through ``ray_test``
    (K2's any hit), no walk runs, and the main loop is the only loop."""
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as ct

    def make(pkg):
        d = (ct if pkg is mt else cj)(width=16, height=16, spp=4,
                                      max_depth=6)
        d["integrator"] = {"type": "volpath", "max_depth": 6}
        return d

    st, _ = volpath_pair(_jax_trips, make, "scalar_rgb", 4,
                         reason="0 media (kernel supports exactly 1)")
    assert len(st.integrator.last_trips) == 1
