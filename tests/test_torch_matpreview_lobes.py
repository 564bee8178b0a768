"""The matpreview lobes under an area light: the Cornell box with a GGX gold
tall box and a checker-textured diffuse sphere. This runs what matpreview
(lit by its sky alone) does not: area NEE evaluated through the GGX lobe,
emission MIS after a GGX bounce, and the checker resolved from a sphere's
spherical uv.

Held like test_torch_matpreview.py: the reference's polynomial
atan2/acos patched to exact math, at least 99% of pixels within 1e-4
relative, means within 1e-5, for the plain version on the reference's
tables and for the port's own load_dict + render. Measured at this size:
every pixel within 7.6e-5, means 4.9e-7 (plain) and 4.3e-7 (render)
apart."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cb_t
from tests.test_torch_matpreview import jax_tables
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 8, 4, 2, 13
FLAGS = pk.HAS_SPHERES | pk.HAS_GGX | pk.HAS_CHECKER


def scene_dict(make, T, width=W, spp=SPP, max_depth=MAX_DEPTH):
    d = make(width=width, height=width, spp=spp, max_depth=max_depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    d["tallbox"]["bsdf"] = {"type": "roughconductor", "distribution": "ggx",
                            "alpha": 0.15, "material": "Au"}
    d["ball"] = {"type": "sphere", "radius": 0.25,
                 "center": [0.4, -0.15, 0.2],
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "checkerboard",
                     "color0": {"type": "rgb", "value": [0.8, 0.1, 0.1]},
                     "color1": {"type": "rgb", "value": 0.9},
                     "to_uv": T.scale([6, 3, 1])}}}
    return d


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cb_j
    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(scene_dict(cb_j, mj.Transform))
    assert mk_mod.megakernel_ineligibility(scene) is None
    mk = mk_mod.DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_atan2", jnp.arctan2)
        mp.setattr(mk_mod, "_acos",
                   lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
        acc = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    tables, cam = jax_tables(mk, scene.sensors[0])
    return tables, cam, acc[..., :3] / acc[..., 3:]


def test_plain_version_matches_jax_kernel(reference):
    tables, cam, ref = reference
    assert tables.flags == FLAGS and tables.p_env == 0.0
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert torch.isfinite(rad).all() and (rad >= 0).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_render_matches_jax_kernel(reference):
    ref = reference[2]
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(scene_dict(cb_t, mt.Transform))
    assert st.tables.flags == FLAGS
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert_images_agree(img.numpy(), ref)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The spheres+ggx+checker instantiation on the card against the
    plain version, at the main path's depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(scene_dict(cb_t, mt.Transform, 32, 16, 6))
    finally:
        mt.set_device(prev)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 16, 32, 32, 6, 3)
    before = pk.path_radiance.launches_by_kernel[(FLAGS, 3)]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[(FLAGS, 3)] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
