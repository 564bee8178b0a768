"""The volpath slice's modules against the JAX package, with no reference
render: the mix32 tracking RNG (bit-exact), the grid volume's trilinear
lookup, the HG and isotropic phase functions, the dielectric Fresnel term
and IOR names, loading media through ``load_dict``, the volumetric
kernel's tables against the JAX kernel's own, and the gates (the
volumetric kernel's refusals, with the reference's reasons, whose scenes
the volpath wavefront renders, and the path kernel's refusal of media,
whose scene the path wavefront renders as the reference's does).

Tolerances: the RNG is compared bit for bit; the float functions at 1e-6
(both sides compute them in float32 from the same inputs, in the same
order up to the reference's matmul and gather forms), except the sampled
phase directions at 5e-6 and their pdfs at 1e-5 relative (the libraries'
cos and sin differ in the last bit, and a steep HG lobe magnifies it);
the tables at 1e-6 (the Woop rows are built in float64 and rounded once
on both sides).
"""

import types

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.rng import mix32
from mitsuba2_tpu_torch.models import media_impl, phase as phase_t
from mitsuba2_tpu_torch.ops import volpath_kernel as vk
from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
from mitsuba2_tpu_torch.render import fresnel as fresnel_t
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath import jax_slab_dict, surfaces

_on_cpu = cpu_device_fixture()


def _jax():
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    return mj, jnp


def test_mix32_is_bit_exact():
    from mitsuba2_tpu.ops.megakernel import _mix32
    _, jnp = _jax()
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    dims = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(_mix32(jnp.asarray(keys), jnp.asarray(dims)))
    got = mix32(torch.as_tensor(keys.astype(np.int64)),
                torch.as_tensor(dims.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # a scalar dim, as the kernel's per-round windows use it
    for dim in (0, 2, 2 + 64 * 17 + 53, 2 ** 32 - 1):
        want = np.asarray(_mix32(jnp.asarray(keys), np.uint32(dim)))
        got = mix32(torch.as_tensor(keys.astype(np.int64)), dim)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("shape,seed", [((8, 6, 5), 7), ((48, 48, 48), 11)])
def test_grid_volume_trilinear_matches_jax(shape, seed):
    from mitsuba2_tpu.models.media_impl import Grid3DVolume as GridJ
    _, jnp = _jax()
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.1, 3.0, shape).astype(np.float32)
    D, H, W = shape
    # points inside, on and near the voxel-centre edges, and outside
    pts = [rng.uniform(-0.2, 1.2, (512, 3)),
           rng.uniform(0.0, 1.0, (256, 3)),
           np.stack(np.meshgrid([0.0, 0.5 / W, 1.0 - 0.5 / W, 1.0],
                                [0.0, 0.5 / H, 1.0],
                                [0.0, 0.5 / D, 1.0 - 1e-7, 1.0 + 1e-6]),
                    -1).reshape(-1, 3)]
    pts = np.concatenate(pts).astype(np.float32)
    want = np.asarray(GridJ(data=data).eval_1(jnp.asarray(pts)))
    got = media_impl.Grid3DVolume(data=data).eval_1(torch.as_tensor(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got[(pts < 0).any(1) | (pts > 1).any(1)] == 0).all()


@pytest.mark.parametrize("value", [0.8, [0.2, 0.5, 0.9]])
def test_constant_volume_matches_jax(value):
    from mitsuba2_tpu.models.media import ConstantVolume as ConstJ
    from mitsuba2_tpu_torch.models.media import ConstantVolume, as_volume
    _, jnp = _jax()
    pts = np.random.default_rng(2).uniform(-1, 2, (64, 3)).astype(np.float32)
    vj, vt = ConstJ(value=value), as_volume(value)
    assert isinstance(vt, ConstantVolume) and vt.max() == vj.max()
    np.testing.assert_allclose(vt.eval_1(torch.as_tensor(pts)).numpy(),
                               np.asarray(vj.eval_1(jnp.asarray(pts))),
                               rtol=1e-6)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name,g", [("hg", 0.3), ("hg", -0.7), ("hg", 0.0),
                                    ("isotropic", None)])
def test_phase_functions_match_jax(name, g):
    mj, jnp = _jax()
    rng = np.random.default_rng(5)
    wi = _unit(rng.normal(size=(1024, 3)))
    wo = _unit(rng.normal(size=(1024, 3)))
    u = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    props = {"type": name} if g is None else {"type": name, "g": g}
    pj = mj.load_dict(props)
    pt = mt.load_dict(props)
    assert isinstance(pt, phase_t.HGPhase if name == "hg"
                      else phase_t.IsotropicPhase)
    mi = types.SimpleNamespace(wi=jnp.asarray(wi))
    np.testing.assert_allclose(
        pt.eval(torch.as_tensor(wi), torch.as_tensor(wo)).numpy(),
        np.asarray(pj.eval(mi, jnp.asarray(wo))), rtol=1e-6, atol=1e-6)
    wo_t, pdf_t = pt.sample(torch.as_tensor(wi), torch.as_tensor(u))
    wo_j, pdf_j = pj.sample(mi, jnp.asarray(u))
    # the two libraries' cos and sin differ in the last bit, and the HG
    # inversion and the frame carry that into the direction and its pdf
    np.testing.assert_allclose(wo_t.numpy(), np.asarray(wo_j), atol=5e-6)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-5)


@pytest.mark.parametrize("eta", [1.5046 / 1.000277, 1.0 / 1.33, 1.0, 2.4])
def test_dielectric_fresnel_matches_jax(eta):
    from mitsuba2_tpu.render.fresnel import fresnel as fresnel_j
    _, jnp = _jax()
    cos_i = np.linspace(-1.0, 1.0, 401).astype(np.float32)
    got = fresnel_t.fresnel(torch.as_tensor(cos_i), eta)
    want = fresnel_j(jnp.asarray(cos_i), eta)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_ior_names_match_jax():
    from mitsuba2_tpu.render.fresnel import lookup_ior as lookup_j
    for name in fresnel_t.IOR_DATABASE:
        assert fresnel_t.lookup_ior(name) == lookup_j(name)
    assert fresnel_t.lookup_ior(None, "bk7") == lookup_j(None, "bk7")
    assert fresnel_t.lookup_ior(1.33) == 1.33
    with pytest.raises(ValueError, match="unknown IOR"):
        fresnel_t.lookup_ior("unobtainium")


def test_dielectric_plugin_matches_jax():
    mj, _ = _jax()
    for props in ({"type": "dielectric"},
                  {"type": "dielectric", "int_ior": "water",
                   "ext_ior": 1.0, "specular_transmittance": 0.5}):
        bj, bt = mj.load_dict(props), mt.load_dict(props)
        assert abs(bt.eta - bj.eta) < 1e-7
        assert int(bt.m_flags) == int(bj.m_flags)


def test_slab_loads_its_medium():
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(volpath_slab_dict(8, 8, 4, 4))
    slab = scene.shapes[0]
    assert scene.has_media and scene.media == [slab.interior_medium]
    med = scene.media[0]
    assert isinstance(med, media_impl.HeterogeneousMedium)
    assert isinstance(med.phase_function, phase_t.HGPhase)
    assert med.phase_function.g == pytest.approx(0.3)
    assert med.sigma_t_vol.data.shape == (16, 16, 16, 1)
    grid = np.random.default_rng(0).uniform(0.2, 2.0, (16, 16, 16))
    assert med.majorant == pytest.approx(float(grid.max()), rel=1e-6)
    assert slab.exterior_medium is None
    assert all(s.interior_medium is None for s in scene.shapes[1:])
    tables = vk.build_vol_tables(scene)
    # the light rectangle's two faces; the cube's twelve are dropped
    assert len(scene.face_shape) == 14 and tables.n_faces == 2
    assert vk.vol_kernel_ineligibility(scene) is None


def _sorted_rows(t):
    rows = np.concatenate([t.woop.numpy(), t.fattr.numpy()], 1)
    return rows[np.lexsort(rows.T[::-1])]


TABLE_CASES = {
    "bench_slab": {},
    "constant_sigma_t": {"sigma_t": 0.8},
    "grid_40": {"grid": np.random.default_rng(3).uniform(
        0.2, 1.5, (40, 40, 40)).astype(np.float32)},
    "ggx_dielectric": {"extra": surfaces},
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_tables_match_jax_kernel_tables(case):
    from mitsuba2_tpu.ops.volmegakernel import VolPathMegakernel
    mj, _ = _jax()
    kw = dict(TABLE_CASES[case])
    sigma = kw.pop("sigma_t", None)
    extra = kw.pop("extra", None)
    dj = jax_slab_dict(8, 8, 4, 4, **kw, extra=extra)
    dt = volpath_slab_dict(8, 8, 4, 4, **kw)
    if extra is not None:
        dt.update(extra(mt.Transform))
    if sigma is not None:
        dj["slab"]["interior"]["sigma_t"] = sigma
        dt["slab"]["interior"]["sigma_t"] = sigma
    ref = vk.vol_tables_from_reference(
        VolPathMegakernel(mj.load_dict(dj), interpret=True))
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(dt)
    before = vk.volpath_radiance.launches
    mine = vk.build_vol_tables(scene)
    assert vk.volpath_radiance.launches == before      # nothing launched
    assert mine.flags == ref.flags and mine.n_faces == ref.n_faces
    np.testing.assert_allclose(_sorted_rows(mine), _sorted_rows(ref),
                               rtol=1e-6, atol=1e-6)
    for name in ("lights", "grid"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(mine.med, ref.med, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mine.albedo, ref.albedo, rtol=1e-7)
    for name in ("maj", "scale", "g"):
        assert getattr(mine, name) == pytest.approx(getattr(ref, name),
                                                    rel=1e-6), name
    if sigma is not None:
        assert tuple(mine.grid.shape) == (2, 2, 2)


def _refusal_cases():
    """name -> (reason substring, edit(d, T, package_scenes))."""
    def homogeneous(d, T, sc):
        d["slab"]["interior"] = {
            "type": "homogeneous",
            "sigma_t": {"type": "rgb", "value": [1.0] * 3},
            "albedo": {"type": "rgb", "value": [0.5] * 3}}

    def non_null_boundary(d, T, sc):
        d["slab"]["bsdf"] = {"type": "diffuse"}

    def envmap(d, T, sc):
        d["env"] = sc.matpreview_dict(8, 8, 2, 3)["envmap"]

    def sphere(d, T, sc):
        d["ball"] = {"type": "sphere", "radius": 0.3,
                     "to_world": T.translate([2.5, 0, 0]),
                     "bsdf": {"type": "diffuse"}}

    def unsupported_bsdf(d, T, sc):
        d["floor"] = {"type": "rectangle",
                      "to_world": T.translate([0, -2.5, 0]),
                      "bsdf": {"type": "diffuse", "reflectance": {
                          "type": "checkerboard"}}}

    def non_box_boundary(d, T, sc):
        d["slab"]["to_world"] = T.rotate([0, 0, 1], 30.0)

    def grid_too_deep(d, T, sc):
        # D * H = 20480 > MAX_GRID_DH
        d["slab"]["interior"]["sigma_t"]["data"] = np.full(
            (256, 80, 4), 0.5, np.float32)

    def grid_too_wide(d, T, sc):
        # W = 130 > MAX_GRID_W
        d["slab"]["interior"]["sigma_t"]["data"] = np.full(
            (4, 4, 130), 0.5, np.float32)

    return {"homogeneous": ("heterogeneous", homogeneous),
            "non_null_boundary": ("null", non_null_boundary),
            "envmap": ("environment", envmap),
            "sphere": ("analytic", sphere),
            "unsupported_bsdf": ("BSDF", unsupported_bsdf),
            "non_box_boundary": ("box", non_box_boundary),
            "grid_too_deep": ("cap", grid_too_deep),
            "grid_too_wide": ("cap", grid_too_wide)}


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals_give_the_reference_reasons(case):
    """The refusals of tests/test_volmegakernel.py:57-117, through the
    port's loader: the port's reason is the reference gate's on the same
    scene, and ``render`` renders it through the volpath wavefront, with
    that reason kept. The grid cases exceed today's caps:
    the reference test's (128, 64, 16) grid has D * H = 8192, inside
    MAX_GRID_DH = 16384 since that cap was raised, so it no longer
    tests a refusal."""
    import mitsuba2_tpu.python.test.scenes as scenes_j
    import mitsuba2_tpu_torch.python.test.scenes as scenes_t
    from mitsuba2_tpu.core.transform import Transform as TJ
    from mitsuba2_tpu.ops.volmegakernel import vol_megakernel_ineligibility
    mj, _ = _jax()
    substring, edit = _refusal_cases()[case]
    dj = jax_slab_dict(8, 8, 2, 4)
    edit(dj, TJ, scenes_j)
    want = vol_megakernel_ineligibility(mj.load_dict(dj))
    mt.set_variant("scalar_rgb")
    dt = volpath_slab_dict(8, 8, 2, 4)
    edit(dt, mt.Transform, scenes_t)
    scene = mt.load_dict(dt)
    reason = vk.vol_kernel_ineligibility(scene)
    assert reason is not None and substring in reason
    assert reason == want
    img = scene.integrator.render(scene, seed=0, spp=2)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert scene.integrator.engine_reason == reason
    assert scene.integrator.last_engine == "wavefront"


def test_isotropic_and_mis_scenes_stay_eligible():
    mt.set_variant("scalar_rgb")
    for kind in ("volpath", "volpathmis"):
        d = volpath_slab_dict(8, 8, 2, 4, g=0.0)
        d["integrator"]["type"] = kind
        scene = mt.load_dict(d)
        assert vk.vol_kernel_ineligibility(scene) is None
        assert vk.build_vol_tables(scene).flags == 0
        scene.integrator.render(scene, seed=0, spp=2)
        assert scene.integrator.last_engine == "kernel"
        assert scene.integrator.USE_MIS == (kind == "volpathmis")


def test_integrator_gate_refuses_deep_paths():
    """The kernel's gate refuses max_depth 64, as the reference's does; the
    wavefront renders the scene."""
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(volpath_slab_dict(8, 8, 2, 64))
    img = scene.integrator.render(scene, seed=0, spp=2)
    assert scene.integrator.engine_reason.startswith("max_depth >= 64")
    assert scene.integrator.last_engine == "wavefront"
    assert torch.isfinite(img).all()


def test_path_integrator_refuses_media():
    """A diffuse-boundary slab under ``path``: the path kernel does not
    see media, so its gate refuses the scene as the reference's does
    (megakernel.py:3110), and the scene renders through the path
    wavefront, which passes the medium by as the reference's does: lane
    by lane the JAX wavefront's at 8^2 x 2 (the bar of
    tests/test_torch_wavefront.py, no divergent lane)."""
    from mitsuba2_tpu_torch.ops.path_kernel import path_kernel_ineligibility
    from tests.test_torch_wavefront import (assert_wavefront_parity,
                                            jax_lanes, port_lanes)
    mj, _ = _jax()
    mt.set_variant("scalar_rgb")

    def edit(d):
        d["slab"]["bsdf"] = {"type": "diffuse"}
        d["integrator"] = {"type": "path", "max_depth": 4}
        return d

    d = edit(volpath_slab_dict(8, 8, 2, 4))
    scene = mt.load_dict(d)
    assert path_kernel_ineligibility(scene) == "participating media"
    img = scene.integrator.render(scene, seed=3, spp=2)
    assert scene.integrator.last_engine == "wavefront"
    assert scene.integrator.engine_reason == "participating media"
    sj = mj.load_dict(edit(jax_slab_dict(8, 8, 2, 4)))
    ref = np.asarray(sj.integrator.render(sj, seed=3, spp=2))
    assert sj.integrator.last_engine == "wavefront"
    assert_wavefront_parity(img.numpy(), ref, port_lanes(scene, 3, 2),
                            jax_lanes(sj, 3, 2), 0, ())
    # the same boundary without its medium goes to the kernel
    del d["slab"]["interior"]
    scene = mt.load_dict(d)
    assert path_kernel_ineligibility(scene) is None