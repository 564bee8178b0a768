"""The envmap beside an area light: the Cornell box with the matpreview sky
seen through its open front, rotated by a rigid ``to_world``. This runs
the two-armed NEE (env with probability p_env = 1/2, else a light face
whose density carries the 1 - p_env factor) and the env rotation, which
matpreview itself (no area light, identity rotation) does not reach.

Held like test_torch_matpreview.py: the reference's polynomial
atan2/acos patched to exact math, at least 99% of pixels within 1e-4
relative, means within 1e-5, for the plain version on the reference's
tables and for the port's own load_dict + render. Measured at this size:
every pixel within 2.4e-5, means 3.6e-7 apart, both ways."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (cornell_box_dict as cb_t,
                                                   _sky_exr_path as sky_t)
from tests.test_torch_matpreview import jax_tables
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 8, 3, 2, 11


def port_dict(width=W, spp=SPP, max_depth=MAX_DEPTH):
    d = cb_t(width=width, height=width, spp=spp, max_depth=max_depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    d["sky"] = {"type": "envmap", "filename": sky_t(), "scale": 0.5,
                "to_world": mt.Transform.rotate([0, 1, 0], 30)}
    return d


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    from mitsuba2_tpu.python.test.scenes import (cornell_box_dict as cb_j,
                                                 _sky_exr_path as sky_j)
    mj.set_variant("scalar_rgb")
    d = cb_j(width=W, height=W, spp=SPP, max_depth=MAX_DEPTH)
    d["integrator"]["rr_depth"] = RR_DEPTH
    d["sky"] = {"type": "envmap", "filename": sky_j(), "scale": 0.5,
                "to_world": mj.Transform.rotate([0, 1, 0], 30)}
    scene = mj.load_dict(d)
    assert mk_mod.megakernel_ineligibility(scene) is None
    mk = mk_mod.DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_atan2", jnp.arctan2)
        mp.setattr(mk_mod, "_acos",
                   lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
        acc = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    tables, cam = jax_tables(mk, scene.sensors[0])
    return mk, tables, cam, acc[..., :3] / acc[..., 3:]


def test_plain_version_matches_jax_kernel(reference):
    mk, tables, cam, ref = reference
    assert mk.p_env == tables.p_env == 0.5
    assert tables.flags == pk.HAS_ENV | pk.HAS_ENV_ROT
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert torch.isfinite(rad).all() and (rad >= 0).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_port_tables_match_reference(reference):
    _, ref, _, _ = reference
    mt.set_variant("scalar_rgb")
    t = mt.load_dict(port_dict()).tables
    assert t.flags == ref.flags and t.p_env == ref.p_env
    # light densities carry 1 - p_env; the cdf is unchanged
    np.testing.assert_allclose(t.lights.numpy(), ref.lights.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.env_rot.numpy(), ref.env_rot.numpy(),
                               atol=1e-7)
    np.testing.assert_array_equal(t.env.numpy(), ref.env.numpy())
    np.testing.assert_array_equal(t.env_pmf.numpy(), ref.env_pmf.numpy())


def test_render_matches_jax_kernel(reference):
    ref = reference[3]
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(port_dict())
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert_images_agree(img.numpy(), ref)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The env instantiation with a rotated env and two NEE arms, on the
    card, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(port_dict(32, 16, 6))
    finally:
        mt.set_device(prev)
    assert scene.tables.flags & pk.TEMPLATE_FLAGS == pk.HAS_ENV
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 16, 32, 32, 6, 3)
    before = pk.path_radiance.launches_by_kernel[(pk.HAS_ENV, 3)]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[(pk.HAS_ENV, 3)] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
