"""The port's packed Cornell-box tables against the tables the JAX
package's DiffusePathMegakernel builds for the same dict.

Each package builds the scene with its own Transform. The reference
permutes faces into BVH leaf order and pads them to its chunk size with
never-hit rows, so faces are matched as sets; the light table and the
camera row are compared in order."""

import numpy as np
import pytest

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cornell_t
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

TOL = 1e-6


def _jax_cam(sensor):
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    tan_half = float(np.tan(np.deg2rad(sensor.x_fov) * 0.5))
    return np.concatenate([mat[:3, :3].reshape(-1), mat[:3, 3], [tan_half],
                           np.zeros(3)]).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    sj = mj.load_dict(cornell_j(width=16, height=12, spp=4))
    st = mt.load_dict(cornell_t(width=16, height=12, spp=4))
    mk = DiffusePathMegakernel(sj, interpret=True)
    ref, cam = pk.tables_from_reference(np.asarray(mk.woop),
                                        np.asarray(mk._fattr()),
                                        np.asarray(mk.lights),
                                        _jax_cam(sj.sensors[0]))
    return st, ref, cam


def _rows(tables):
    """Woop rows and the attribute columns the Cornell kernel reads
    (normal, light pdf, albedo, kind, emission, alpha)."""
    return np.concatenate([tables.woop.numpy(), tables.fattr.numpy()[:, :12]],
                          1)


def test_face_tables_match_as_sets(both):
    st, ref, _ = both
    port = _rows(st.tables)
    jax = _rows(ref)
    # drop the reference's never-hit padding faces (Wz = [0, 0, 0, 1])
    pad = np.all(jax[:, 8:12] == [0, 0, 0, 1], axis=1) \
        & np.all(jax[:, :8] == 0, axis=1)
    jax = jax[~pad]
    assert st.tables.n_faces == len(jax) == 36
    scale = np.maximum(1.0, np.abs(jax))
    dist = (np.abs(port[:, None, :] - jax[None, :, :]) / scale).max(-1)
    match = dist.argmin(1)
    assert sorted(match) == list(range(36)), "faces must pair one to one"
    err = dist[np.arange(36), match]
    assert err.max() <= TOL, err.max()
    # per-face content: normals, albedo, emission and light pdf columns
    assert (port[:, 12 + 8:12 + 11].sum(1) > 0).sum() == 2   # light faces
    np.testing.assert_allclose(np.linalg.norm(port[:, 12:15], axis=1), 1.0,
                               atol=1e-6)


def test_light_table_in_order(both):
    st, ref, _ = both
    lt, lj = st.tables.lights.numpy(), ref.lights.numpy()
    assert lt.shape == lj.shape == (8, 24)
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    assert (lt[2:, 12] == 2.0).all()                 # never-picked padding
    np.testing.assert_allclose(lt[1, 12], 1.0, atol=1e-6)


def test_camera_row(both):
    st, _, cam = both
    row = pk.camera_row(st.sensors[0], st.device)
    assert row.shape == (16,)
    np.testing.assert_allclose(row.numpy(), cam.numpy(), rtol=TOL, atol=TOL)
