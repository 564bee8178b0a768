"""The measured BSDFs of the port (models/measured.py ``measured`` and
``measured_polarized``) and its tensor files (utils/tensorfile.py)
against the JAX package's: a tensor file written by either package reads
the same in the other, byte for byte; both BSDFs lane for lane on the
same numpy surface records made from a seed (a quarter of them below the
surface), in rgb and spectral (``measured_polarized`` also in mono, and
on a file with a NaN region); the refusals. The files are the fixtures'
synthesized GGX RGL file and KAIST table
(``python/test/scenes.py measured_ggx_path``, ``kaist_pbrdf_path``).
Tolerance: 1e-5 relative and 1e-6 absolute on values and pdfs (3e-5 on
sampled weights and pdfs, 5e-5 on sampled directions, as
tests/test_torch_surface_plugins.py holds sampled microfacets), on 99.9%
of the lanes; Mueller matrices to 2e-5 of each lane's largest entry, the
sampled ones (over the sampled pdf) to 1e-4; the per-lane prefix sums bit for bit the JAX package's on
the CPU."""

import os

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import (kaist_pbrdf_path,
                                                   measured_ggx_path)
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_polarized_bsdfs import matrices_close
from tests.test_torch_surface_plugins import N, surface_records, variant
from tests.test_torch_wavefront import one_thread_fixture
from tests.test_torch_wavefront_modules import (T, close_lanes, hemisphere,
                                                rng)

_on_cpu = cpu_device_fixture()
_one_thread = one_thread_fixture()
_variant = variant


def _fields(seed):
    r = rng(seed)
    return {"a": r.random((3, 4)).astype(np.float32),
            "b": np.arange(7, dtype=np.uint8),
            "c": r.random((2, 2, 2)),
            "d": np.arange(-5, 5, dtype=np.int16).reshape(2, 5),
            "e": np.asarray([1.5], np.float16)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tensor_file_round_trip_across_packages(tmp_path, writer):
    """A file either package writes reads the same in both, and the two
    writers' files are the same bytes."""
    from mitsuba2_tpu.utils import tensorfile as tj
    from mitsuba2_tpu_torch.utils import tensorfile as tt
    fields = _fields(1)
    paths = {}
    for name, mod in (("port", tt), ("jax", tj)):
        paths[name] = str(tmp_path / f"{name}.tensor")
        mod.write_tensor_file(paths[name], fields)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    for mod in (tt, tj):
        tf = mod.TensorFile(paths[writer])
        for k, v in fields.items():
            assert tf.has_field(k)
            got = tf.field(k)
            assert got.dtype == v.dtype and got.shape == v.shape
            np.testing.assert_array_equal(got, v)
        assert not tf.has_field("missing")
    bad = tmp_path / "bad.tensor"
    bad.write_bytes(b"not a tensor file")
    with pytest.raises(ValueError, match="not a tensor_file"):
        tt.TensorFile(str(bad))


@pytest.mark.parametrize("width", [15, 16, 17, 47])
def test_row_prefix_sums_are_the_jax_order(width):
    """``cumsum16`` over rows of the tables' widths (the measured warp's
    conditional rows are 47 wide) is bit for bit the JAX package's
    per-lane ``cumsum`` on the CPU."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu_torch.core.distr_1d import cumsum16
    x = (rng(width).random((257, width)) * 3.0).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, -1))(jnp.asarray(x)))
    np.testing.assert_array_equal(cumsum16(T(x)).numpy(), want)


def _load(d):
    import mitsuba2_tpu as mj
    return mj.load_dict(d), mt.load_dict(d)


def _queries(seed, variant):
    import jax.numpy as jnp
    sj, st = surface_records(seed, variant)
    r = rng(seed + 1)
    wo = hemisphere(r, N, lower=True)
    s1 = r.random(N).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    act_t = torch.ones(N, dtype=torch.bool)
    act_t[1::5] = False
    return (sj, st, wo, s1, s2, jnp.asarray(act_t.numpy()), act_t)


def _check_scalar_lanes(bj, bt, variant, seed):
    """eval, pdf and sample of both packages' BSDF on the same lanes."""
    import jax.numpy as jnp
    from mitsuba2_tpu.render.bsdf import BSDFContext as CJ
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext as CT
    sj, st, wo, s1, s2, act_j, act_t = _queries(seed, variant)
    ev_t = bt.eval(CT(), st, T(wo), act_t)
    ev_j = bj.eval(CJ(), sj, jnp.asarray(wo), act_j)
    close_lanes(ev_t, ev_j, rtol=1e-5, atol=1e-6)
    close_lanes(bt.pdf(CT(), st, T(wo), act_t),
                bj.pdf(CJ(), sj, jnp.asarray(wo), act_j), rtol=1e-5,
                atol=1e-6)
    bs_t, w_t = bt.sample(CT(), st, T(s1), T(s2), act_t)
    bs_j, w_j = bj.sample(CJ(), sj, jnp.asarray(s1), jnp.asarray(s2), act_j)
    close_lanes(bs_t.wo, bs_j.wo, rtol=0, atol=5e-5)
    close_lanes(bs_t.pdf, bs_j.pdf, rtol=3e-5, atol=1e-6)
    close_lanes(w_t, w_j, rtol=3e-5, atol=1e-6)
    np.testing.assert_array_equal(bs_t.sampled_type.numpy(),
                                  np.asarray(bs_j.sampled_type))
    np.testing.assert_array_equal(bs_t.sampled_component.numpy(),
                                  np.asarray(bs_j.sampled_component))
    # back-facing and inactive lanes give nothing
    dead = (st.wi[:, 2] <= 0) | ~act_t
    assert bool((ev_t[dead] == 0).all()) and bool((w_t[dead] == 0).all())
    assert bool((ev_t[~dead] > 0).any()) and bool((w_t[~dead] > 0).any())
    return st, wo, bs_t


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"],
                         indirect=True)
def test_measured_lanes(variant):
    """``measured`` on the GGX file: the theta_i slices blend between the
    16 tabulated angles, the sampled and evaluated spectra come from the
    warp's square (the forward vndf cdf), the rgb tables from the load's
    CIE integration."""
    bj, bt = _load({"type": "measured", "filename": measured_ggx_path()})
    assert bt.n_theta == bj.n_theta == 16
    if variant == "scalar_rgb":
        np.testing.assert_allclose(bt.spectra_rgb, np.asarray(
            bj.spectra_rgb), rtol=1e-6, atol=1e-7)
    _check_scalar_lanes(bj, bt, variant, 30)


def test_measured_refusals(tmp_path):
    """Anisotropic files and mono variants are refused."""
    from mitsuba2_tpu_torch.utils.tensorfile import TensorFile, \
        write_tensor_file
    tf = TensorFile(measured_ggx_path())
    fields = dict(tf.fields)
    fields["phi_i"] = np.linspace(0, np.pi, 3).astype(np.float32)
    aniso = str(tmp_path / "aniso.bsdf")
    write_tensor_file(aniso, fields)
    with pytest.raises(NotImplementedError, match="anisotropic"):
        mt.load_dict({"type": "measured", "filename": aniso})
    mt.set_variant("scalar_mono")
    try:
        with pytest.raises(NotImplementedError, match="mono"):
            mt.load_dict({"type": "measured",
                          "filename": measured_ggx_path()})
    finally:
        mt.set_variant("scalar_rgb")


def _nan_file(tmp_path):
    """The fixture's KAIST table with the upper half of theta_h NaN (the
    dataset's invalid configurations)."""
    from mitsuba2_tpu_torch.utils.tensorfile import TensorFile, \
        write_tensor_file
    fields = dict(TensorFile(kaist_pbrdf_path()).fields)
    M = fields["M"].copy()
    M[:, :, M.shape[2] // 2:] = np.nan
    fields["M"] = M
    path = str(tmp_path / "nan.bsdf")
    write_tensor_file(path, fields)
    return path


@pytest.mark.parametrize("variant,nan", [
    ("scalar_rgb", False), ("scalar_spectral", False),
    ("scalar_mono", False), ("scalar_rgb", True)],
    ids=["rgb", "spectral", "mono", "rgb-nan-region"], indirect=["variant"])
def test_measured_polarized_lanes(variant, nan, tmp_path):
    """``measured_polarized`` on the KAIST table (550 nm outside spectral
    variants): the scalar methods, ``eval_pol`` and ``sample_pol`` lane
    for lane; with a NaN region, its lanes are zero in both packages."""
    import jax.numpy as jnp
    from mitsuba2_tpu.render.bsdf import BSDFContext as CJ
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext as CT
    d = {"type": "measured_polarized", "wavelength": 550.0,
         "filename": _nan_file(tmp_path) if nan else kaist_pbrdf_path()}
    bj, bt = _load(d)
    st, wo, _ = _check_scalar_lanes(bj, bt, variant, 40)
    sj, st, wo, s1, s2, act_j, act_t = _queries(40, variant)
    M_t = bt.eval_pol(CT(), st, T(wo), act_t)
    matrices_close(M_t, bj.eval_pol(CJ(), sj, jnp.asarray(wo), act_j))
    bs_t, W_t = bt.sample_pol(CT(), st, T(s1), T(s2), act_t)
    bs_j, W_j = bj.sample_pol(CJ(), sj, jnp.asarray(s1), jnp.asarray(s2),
                              act_j)
    close_lanes(bs_t.wo, bs_j.wo, rtol=0, atol=5e-5)
    matrices_close(W_t, W_j, rtol=1e-4)
    # the polarized part is not zero: reflection polarizes
    assert float(M_t[..., 1:, 0].abs().max()) > 1e-3
    if nan:
        # lanes whose half vector lies past the NaN rows read zero
        h = torch.nn.functional.normalize(st.wi + T(wo), dim=-1)
        past = torch.acos(h[:, 2].clamp(-1, 1)) > np.pi / 4 + 0.05
        assert bool(past.any()) and bool((M_t[past] == 0).all())


def test_measured_polarized_needs_a_wavelength_outside_spectral():
    for pkg_variant in ("scalar_rgb", "scalar_mono"):
        mt.set_variant(pkg_variant)
        try:
            with pytest.raises(RuntimeError, match="wavelength"):
                mt.load_dict({"type": "measured_polarized",
                              "filename": kaist_pbrdf_path()})
        finally:
            mt.set_variant("scalar_rgb")
    mt.set_variant("scalar_spectral")
    try:
        b = mt.load_dict({"type": "measured_polarized",
                          "filename": kaist_pbrdf_path()})
        assert b.wavelength == -1.0
    finally:
        mt.set_variant("scalar_rgb")
    assert os.path.basename(kaist_pbrdf_path()).startswith(
        "mitsuba2_tpu_torch_")
