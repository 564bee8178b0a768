"""The path kernel module on the matpreview scene (analytic sphere, envmap
with importance-sampled NEE, GGX rough conductors, checkerboard floor):
its plain PyTorch version against the JAX package's Pallas path kernel
(interpret mode) on the reference's own tables, the port's packed tables
against the reference's, lane locality, and the CUDA kernel against the
plain version on the card.

Tolerance. The JAX kernel computes atan2 and acos through polynomials
(megakernel.py:174-191), which move the env lookups, the env pdf and the
sphere uv by up to ~1e-5 rad, and so shift a pixel by up to ~3e-4
relative. Here both are patched to exact ``jnp.arctan2``/``jnp.arccos`` in
``mitsuba2_tpu.ops.megakernel`` for the reference render (the JAX package
itself is not edited), and the bar is the Cornell one of
test_torch_path_kernel.py: at least 99% of pixels within 1e-4 relative,
image means within 1e-5. What remains is the reference's bf16 3-pass
table reads (about 2^-16 relative). Measured at this size: 99.6% of
pixels within 1e-4, the worst 1.7e-4, means 3.2e-6 apart.
test_torch_matpreview_render.py holds the unpatched reference at 1e-3.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import matpreview_dict as mp_t
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 16, 4, 2, 3
FULL = pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER


def jax_cam(sensor):
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    return np.concatenate([mat[:3, :3].reshape(-1), mat[:3, 3],
                           [np.tan(np.deg2rad(sensor.x_fov) * 0.5)],
                           np.zeros(3)]).astype(np.float32)


def jax_tables(mk, sensor):
    """(PathTables, camera row) of a DiffusePathMegakernel's own tables."""
    env = {}
    if mk.has_env:
        env = dict(env=np.asarray(mk.env), envs=np.asarray(mk.envs),
                   env_size=(mk.env_w, mk.env_h, mk.env_ws, mk.env_hs),
                   p_env=mk.p_env, env_rot=mk.env_rot)
    return pk.tables_from_reference(
        np.asarray(mk.woop), np.asarray(mk._fattr()), np.asarray(mk.lights),
        jax_cam(sensor), sph=np.asarray(mk.sph),
        sattr=np.asarray(mk._sattr()), nc=mk.nc, **env)


def port_scene(width=W, spp=SPP, max_depth=MAX_DEPTH):
    mt.set_variant("scalar_rgb")
    d = mp_t(width, width, spp, max_depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    return mt.load_dict(d)


@pytest.fixture(scope="module")
def reference():
    """The JAX kernel's scene, megakernel, its tables and its image with
    exact atan2/acos."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    from mitsuba2_tpu.python.test.scenes import matpreview_dict as mp_j
    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(mp_j(W, W, SPP, MAX_DEPTH))
    mk = mk_mod.DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_atan2", jnp.arctan2)
        mp.setattr(mk_mod, "_acos",
                   lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
        acc = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    tables, cam = jax_tables(mk, scene.sensors[0])
    return scene, mk, tables, cam, acc[..., :3] / acc[..., 3:]


def test_plain_version_matches_jax_kernel(reference):
    _, _, tables, cam, ref = reference
    assert tables.flags & pk.TEMPLATE_FLAGS == FULL and tables.p_env == 1.0
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert rad.shape == (3, W * W * SPP) and rad.dtype == torch.float32
    assert torch.isfinite(rad).all() and (rad >= 0).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_port_tables_render_like_reference_tables(reference):
    """The port's own packing renders the same lanes as the reference's
    tables (the tables differ only in face order and float rounding)."""
    _, _, tables, cam, _ = reference
    st = port_scene()
    args = (SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    ours = pk.path_radiance_reference(
        st.tables, pk.camera_row(st.sensors[0], "cpu"), *args)
    theirs = pk.path_radiance_reference(tables, cam, *args)
    assert_images_agree(box_develop(ours, W, W, SPP).numpy(),
                        box_develop(theirs, W, W, SPP).numpy())


def _face_rows(tables):
    return np.concatenate([tables.woop.numpy(), tables.fattr.numpy()], 1)


def test_face_tables_match_as_sets(reference):
    """Woop rows and every attribute column (normal, light pdf, albedo,
    kind, alpha, eta, k, color1, uv, to_uv) pair one to one."""
    _, _, ref, _ = reference[:4]
    port = _face_rows(port_scene().tables)
    jax = _face_rows(ref)
    pad = np.all(jax[:, 8:12] == [0, 0, 0, 1], axis=1) \
        & np.all(jax[:, :8] == 0, axis=1)
    jax = jax[~pad]
    assert len(port) == len(jax) == 14
    scale = np.maximum(1.0, np.abs(jax))
    dist = (np.abs(port[:, None, :] - jax[None, :, :]) / scale).max(-1)
    match = dist.argmin(1)
    assert sorted(match) == list(range(14)), "faces must pair one to one"
    assert dist[np.arange(14), match].max() <= 1e-6
    kinds = sorted(port[:, 12 + pk.C_KIND])
    assert kinds == [pk.KIND_GGX] * 12 + [pk.KIND_CHECKER] * 2


def test_sphere_rows(reference):
    _, _, ref, _ = reference[:4]
    t = port_scene().tables
    assert t.n_spheres == ref.n_spheres == 1
    np.testing.assert_allclose(t.sph.numpy(), ref.sph.numpy(), rtol=1e-6)
    np.testing.assert_allclose(t.sattr.numpy(), ref.sattr.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert t.sattr[0, pk.C_KIND] == pk.KIND_GGX
    np.testing.assert_allclose(t.sattr[0, pk.C_ALPHA].item(), 0.1)


def test_env_tables_and_light_densities(reference):
    _, mk, ref, _ = reference[:4]
    t = port_scene().tables
    assert t.env.shape == (mk.env_h, mk.env_w, 4) == (64, 128, 4)
    assert t.env_pmf.shape == (mk.env_hs, mk.env_ws) == (64, 128)
    for name in ("env", "env_marg", "env_cond", "env_pmf"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(ref, name).numpy(), name)
    assert t.p_env == ref.p_env == mk.p_env == 1.0
    assert not t.flags & pk.HAS_ENV_ROT
    np.testing.assert_array_equal(t.lights.numpy(), ref.lights.numpy())
    # no area light: the dummy row with cdf 1, then never-picked padding
    assert t.lights.shape == (8, 24) and t.lights[0, 12] == 1.0
    assert (t.lights[1:, 12] == 2.0).all()


def test_plain_version_is_lane_local():
    """A lane's radiance depends only on its (pixel, sample) key: the lane
    chunking of the plain version and pass splitting change nothing.
    Chunks are whole multiples of 64 lanes: torch's CPU atan2 rounds the
    scalar tail of a tensor differently from its vectorised body."""
    st = port_scene()
    cam = pk.camera_row(st.sensors[0], "cpu")
    args = (st.tables, cam, SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    full = pk.path_radiance_reference(*args)
    old = pk._CHUNK_ELEMS
    try:
        pk._CHUNK_ELEMS = 1024 * 128     # 1024-lane chunks
        chunked = pk.path_radiance_reference(*args)
    finally:
        pk._CHUNK_ELEMS = old
    assert torch.equal(full, chunked)
    second = pk.path_radiance_reference(st.tables, cam, SEED, 8, 8, W, W,
                                        MAX_DEPTH, RR_DEPTH)
    assert torch.equal(full.reshape(3, W * W, SPP)[:, :, 8:],
                       second.reshape(3, W * W, 8))


def test_pass_splitting_keeps_the_image():
    st = port_scene(width=8, spp=8, max_depth=3)
    one = st.integrator.render(st, seed=1, spp=8)
    st.integrator.MAX_WAVEFRONT_KERNEL = 8 * 8 * 2      # 4 passes
    four = st.integrator.render(st, seed=1, spp=8)
    torch.testing.assert_close(four, one, rtol=1e-6, atol=1e-7)


def test_wrapper_runs_plain_version_on_cpu():
    st = port_scene(width=8, spp=2)
    cam = pk.camera_row(st.sensors[0], "cpu")
    before = pk.path_radiance.launches
    before_by = dict(pk.path_radiance.launches_by_kernel)
    out = pk.path_radiance(st.tables, cam, SEED, 0, 2, 8, 8, MAX_DEPTH,
                           RR_DEPTH)
    assert pk.path_radiance.launches == before       # no kernel launched
    assert dict(pk.path_radiance.launches_by_kernel) == before_by
    assert torch.equal(out, pk.path_radiance_reference(
        st.tables, cam, SEED, 0, 2, 8, 8, MAX_DEPTH, RR_DEPTH))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The matpreview instantiation against the plain version on the card,
    on the port's own tables (the main path's depth, RR exercised)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(mp_t(32, 32, 16, 6))
    finally:
        mt.set_device(prev)
    assert scene.tables.flags & pk.TEMPLATE_FLAGS == FULL
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 16, 32, 32, 6, 3)
    before = pk.path_radiance.launches_by_kernel[(FULL, 3)]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[(FULL, 3)] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
