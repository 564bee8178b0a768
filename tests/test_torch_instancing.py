"""Shared-geometry instancing in the port (models/shapes.py ``shapegroup``,
``instance``; render/scene.py's instance tables; K2's instance entries,
ops/intersect_kernel.py): the seven cases of tests/test_instancing.py on
the port, the plain instance queries against the JAX package's
``_instance_closest_hit`` ray by ray, the surface records of instance hits
against the JAX package's on the same hits, and renders over shared
instances lane for lane against the JAX wavefront (``path`` and
``volpath``)."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.ray import Ray
from mitsuba2_tpu_torch.ops import intersect
from mitsuba2_tpu_torch.ops import intersect_kernel as ik
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (_bumpy_sphere_obj_path,
                                                   instanced_spheres_dict)
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront import render_pair

_on_cpu = cpu_device_fixture()

SHARED = "shared-geometry instances (wavefront path only)"


@pytest.fixture(autouse=True)
def _rgb():
    mt.set_variant("scalar_rgb")
    yield
    mt.set_variant("scalar_rgb")


def scene_t(n_inst, materialize=None, nu=40, nv=20, **kw):
    return mt.load_dict(instanced_spheres_dict(n_inst, materialize, nu, nv,
                                               **kw))


def make(n_inst, materialize=None, nu=40, nv=20, **kw):
    """``pkg`` -> the instancing scene's dict for that package (``render_
    pair``'s ``make``)."""
    def make_pkg(pkg):
        if pkg is mt:
            return instanced_spheres_dict(n_inst, materialize, nu, nv, **kw)
        from mitsuba2_tpu.core.transform import Transform as TJ
        from mitsuba2_tpu.python.test.scenes import \
            _bumpy_sphere_obj_path as obj_j
        return instanced_spheres_dict(n_inst, materialize, nu, nv, T=TJ,
                                      filename=obj_j(nu, nv), **kw)
    return make_pkg


def jax_scene(n_inst, materialize=None, nu=40, nv=20, **kw):
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    return mj.load_dict(make(n_inst, materialize, nu, nv, **kw)(mj))


# ---- tests/test_instancing.py on the port ----------------------------------

def test_shared_path_engages():
    scene = scene_t(3, materialize=False)
    assert scene.n_instances == 3
    # one packed group, whatever the instance count
    assert len(scene.inst_tables.n_faces) == 1
    assert scene.inst_tables.n_faces[0] == 1520
    # the face tables hold the light and the floor only
    assert scene.tables.n_faces == 4
    assert scene.integrator.render(scene, seed=0, spp=1).shape == (24, 24, 3)
    assert scene.integrator.last_engine == "wavefront"
    assert scene.integrator.engine_reason == SHARED


def test_shared_matches_materialized():
    """Shared and materialized instances of one group, both on the
    wavefront (as both render on the JAX package's CPU wavefront, so the
    two draw the same samples): image means within 2% (the JAX test's
    bar), mean absolute difference within 5% (the transform's round trip
    moves a few hits)."""
    s1 = scene_t(3, materialize=False, width=16, height=16)
    s2 = scene_t(3, materialize=True, width=16, height=16)
    assert s1.n_instances == 3 and s2.n_instances == 0
    s2.integrator._disable_kernel = True
    a = s1.integrator.render(s1, seed=2, spp=4).numpy()
    b = s2.integrator.render(s2, seed=2, spp=4).numpy()
    assert s1.integrator.last_engine == s2.integrator.last_engine \
        == "wavefront"
    assert np.isfinite(a).all() and b.mean() > 0
    assert abs(a.mean() - b.mean()) <= 0.02 * max(b.mean(), 1e-3)
    assert np.abs(a - b).mean() <= 0.05 * max(b.mean(), 1e-3)


def test_memory_o1_in_instances():
    s2 = scene_t(2, materialize=False)
    s8 = scene_t(8, materialize=False)
    for a, b in ((s2.inst_tables.nodes, s8.inst_tables.nodes),
                 (s2.inst_tables.woop, s8.inst_tables.woop)):
        assert a.shape == b.shape      # the geometry does not grow
    assert s8.inst_tables.rows.shape == (8, 24)   # only the rows do
    assert s8.tables.n_faces == s2.tables.n_faces
    assert s8.wavefront_tables().inst_attr.shape \
        == s2.wavefront_tables().inst_attr.shape == (1520, 33)


def test_auto_threshold():
    # a small group under the default policy: materialized copies
    from mitsuba2_tpu_torch.models.shapes import INSTANCE_MATERIALIZE_FACES
    scene = scene_t(2, materialize=None, nu=16, nv=8, width=8, height=8)
    assert scene.n_instances == 0 and scene.tables.n_faces == 4 + 2 * 224
    img = scene.integrator.render(scene, seed=0, spp=4)
    assert torch.isfinite(img).all()
    assert INSTANCE_MATERIALIZE_FACES == 65536


def test_shadows_from_instances():
    """Instanced geometry occludes shadow rays (``ray_test`` through K2's
    any-hit instance entry): from the floor under each sphere toward the
    light, and not from the open floor; a segment that ends short of the
    sphere is not occluded."""
    scene = scene_t(3, materialize=False)
    light = torch.tensor([0.0, 3.0, 1.0])
    o = torch.tensor([[-1.4, -0.99, 0.0], [0.0, -0.99, 0.0],
                      [1.4, -0.99, 0.0], [3.5, -0.99, 0.0],
                      [0.0, -0.99, 0.0]])
    d = light - o
    dist = d.norm(dim=1)
    maxt = dist * 0.999
    maxt[4] = 0.3          # ends below the sphere
    hit = scene.ray_test(Ray.make(o, d / dist[:, None], 1e-4, maxt))
    assert hit.tolist() == [True, True, True, False, False]


def test_emitter_in_group_rejected():
    group = {"type": "shapegroup", "id": "grp2",
             "m": {"type": "obj",
                   "filename": _bumpy_sphere_obj_path(40, 20),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb", "value": 1.0}}}}
    d = {"type": "scene", "grp": group,
         "i0": {"type": "instance",
                "shapegroup": {"type": "ref", "id": "grp2"},
                "materialize": False}}
    with pytest.raises(NotImplementedError, match="emitters"):
        mt.load_dict(d)


def test_default_instances_ride_the_path_kernel():
    """Groups of at most 65,536 faces materialize by default and ride the
    path kernel; forced-shared instances take the wavefront, with the JAX
    gate's words, ahead of the shape test; K3's gate refuses them too."""
    from mitsuba2_tpu_torch.ops.volpath_kernel import \
        vol_kernel_ineligibility
    scene = scene_t(4, materialize=None)
    assert scene.n_instances == 0
    assert pk.path_kernel_ineligibility(scene) is None
    shared = scene_t(2, materialize=False)
    assert pk.path_kernel_ineligibility(shared) == SHARED
    # the volpath slab with a shared instance beside its medium
    from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
    d = volpath_slab_dict(8, 8, 4, 4)
    grp = instanced_spheres_dict(1, False)
    d["grp"], d["i0"] = grp["grp"], grp["i0"]
    vol = mt.load_dict(d)
    assert vol.n_instances == 1 and len(vol.media) == 1
    assert vol_kernel_ineligibility(vol) \
        == "analytic shapes/instances (mesh-only kernel)"


# ---- the queries against the JAX package -----------------------------------

def _rays(n, seed=4):
    """Rays from around the scene toward the row of instances, half of
    them aimed at a sphere's center."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 2.0 + np.asarray([0.0, 0.5, 3.0])
    tgt = rng.uniform([-1.8, -0.6, -0.6], [1.8, 0.6, 0.6], size=(n, 3))
    tgt[::2, 1:] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_instance_queries_match_jax_package():
    """The plain instance query (``isect_closest_inst`` on the CPU)
    against JAX ``_instance_closest_hit`` ray by ray: the same hits, t
    within 1e-5 relative, the same prims (instance * g_max + group face)
    except on rays whose two hits lie within 1e-5 (a tie the two face
    tests, Woop here and Moller-Trumbore there, may break apart); and
    ``ray_test`` occluded exactly where the closest query hits."""
    import jax.numpy as jnp
    sj, st = jax_scene(3, False), scene_t(3, False)
    o, d = _rays(4096)
    n = len(o)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    maxt[::5] = 4.0
    tj, pj, uvj = (np.asarray(x) for x in sj._instance_closest_hit(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
        jnp.asarray(maxt)))
    args = [torch.tensor(x) for x in (o, d, mint, maxt)]
    t, uv, prim = ik.isect_closest_inst(st.inst_tables, *args)
    t, uv, prim = t.numpy(), uv.numpy(), prim.numpy()
    assert st.inst_tables.g_max == sj._inst_gmax
    hit = np.isfinite(tj)
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], tj[hit], rtol=1e-5)
    differ = np.flatnonzero(prim != pj)
    # a parting prim: another face of the same instance at the same t
    for k in differ:
        assert prim[k] // 1520 == pj[k] // 1520
        assert abs(t[k] - tj[k]) <= 1e-5 * abs(tj[k])
    assert len(differ) <= 0.002 * n, differ
    same = hit & (prim == pj)
    np.testing.assert_allclose(uv[same], uvj[same], atol=1e-4)
    occluded = ik.isect_any_inst(st.inst_tables, *args).numpy()
    np.testing.assert_array_equal(occluded, np.isfinite(t))


def test_scene_queries_with_instances():
    """``ray_intersect_preliminary`` on the scene with shared instances:
    instance hits encoded F + S + Q + i * g_max + face with the group
    child's shape, the floor and light as faces, the JAX scene's prims
    and shapes (but for the ties above)."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RayJ
    sj, st = jax_scene(3, False), scene_t(3, False)
    o, d = _rays(2048, seed=9)
    pj = sj.ray_intersect_preliminary(RayJ.make(jnp.asarray(o),
                                                jnp.asarray(d)))
    pt = st.ray_intersect_preliminary(Ray.make(torch.tensor(o),
                                               torch.tensor(d)))
    prim_j = np.asarray(pj.prim_idx)
    prim_t = pt.prim_idx.numpy()
    shape_t = pt.shape_idx.numpy()
    base = st.tables.n_faces
    is_inst = prim_t >= base
    assert is_inst.mean() > 0.2 and (prim_t[~is_inst] >= 0).any()
    child = st.shapes.index(st._inst_children[0][0])
    np.testing.assert_array_equal(shape_t[is_inst], child)
    assert (np.asarray(pj.shape_idx)[prim_j >= base] == child).all()
    agree = prim_t == prim_j
    assert agree.mean() >= 0.998
    np.testing.assert_array_equal(shape_t[agree],
                                  np.asarray(pj.shape_idx)[agree])
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), rtol=1e-5)
    hit = st.ray_test(Ray.make(torch.tensor(o), torch.tensor(d)))
    np.testing.assert_array_equal(hit.numpy(), prim_t >= 0)


def test_surface_interaction_on_instance_lanes():
    """``compute_surface_interaction`` of the same preliminary hits in
    both packages (the port's hits handed to the JAX scene): position,
    normals, uv, tangents, shape within 1e-6 on the instance lanes."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RayJ
    from mitsuba2_tpu.render.interaction import \
        PreliminaryIntersection as PIJ
    sj, st = jax_scene(3, False), scene_t(3, False)
    o, d = _rays(2048, seed=12)
    rt = Ray.make(torch.tensor(o), torch.tensor(d))
    pi = st.ray_intersect_preliminary(rt)
    si = st.compute_surface_interaction(rt, pi)
    pij = PIJ(jnp.asarray(pi.t.numpy()), jnp.asarray(pi.prim_uv.numpy()),
              jnp.asarray(pi.shape_idx.numpy()),
              jnp.asarray(pi.prim_idx.numpy()))
    sij = sj.compute_surface_interaction(
        RayJ.make(jnp.asarray(o), jnp.asarray(d)), pij)
    lanes = pi.prim_idx.numpy() >= st.tables.n_faces
    assert lanes.mean() > 0.2
    for name, a, b in (("p", si.p, sij.p), ("n", si.n, sij.n),
                       ("ns", si.sh_frame.n, sij.sh_frame.n),
                       ("uv", si.uv, sij.uv), ("dp_du", si.dp_du, sij.dp_du),
                       ("dp_dv", si.dp_dv, sij.dp_dv),
                       ("s", si.sh_frame.s, sij.sh_frame.s)):
        np.testing.assert_allclose(a.numpy()[lanes], np.asarray(b)[lanes],
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(si.shape_idx.numpy()[lanes],
                                  np.asarray(sij.shape_idx)[lanes])
    assert (si.emitter_idx.numpy()[lanes] == -1).all()


# ---- renders over shared instances against the JAX wavefront ---------------

def test_shared_render_matches_jax_wavefront():
    """3 shared instances of the 1,520-face group at 16^2 x 4 spp, depth
    3: the port's wavefront lane for lane against the JAX wavefront."""
    st, img = render_pair(make(3, False, width=16, height=16, spp=4),
                          "scalar_rgb", 16, 4, force=False)
    assert st.integrator.engine_reason == SHARED
    assert float(img.mean()) > 0


def test_volpath_over_shared_instances_matches_jax_wavefront():
    """``volpath`` over 2 shared instances at 8^2 x 4 spp on the volpath
    wavefront (K3's gate refuses instances), lane for lane against the
    JAX wavefront."""
    def edit(pkg):
        d = make(2, False, width=8, height=8, spp=4)(pkg)
        d["integrator"] = {"type": "volpath", "max_depth": 3}
        return d
    st, img = render_pair(edit, "scalar_rgb", 8, 4, force=False)
    assert type(st.integrator).__name__ == "VolumetricPathIntegrator"


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_instance_entries_match_plain_version():
    """K2's instance entries on the card against their plain version on
    the same rays: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = mt.device()
    mt.set_device("cuda")
    try:
        st = scene_t(5, False, nu=64, nv=33)
    finally:
        mt.set_device(prev)
    inst = st.inst_tables
    o, d = _rays(65536, seed=3)
    n = len(o)
    args = [torch.tensor(x, device="cuda") for x in (
        o, d, np.full(n, 1e-4, np.float32), np.full(n, np.inf, np.float32))]
    args[3][::3] = 3.0
    before = ik.isect_closest_inst.launches
    t, uv, prim = ik.isect_closest_inst(inst, *args)
    hit = ik.isect_any_inst(inst, *args)
    assert ik.isect_closest_inst.launches == before + 1
    woops = ik.group_woops(inst)
    rt, ruv, rprim = intersect.closest_hit_instanced_reference(
        woops, inst.rows, inst.g_max, *args)
    assert torch.equal(prim, rprim)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert torch.equal(uv.view(torch.int32), ruv.view(torch.int32))
    assert torch.equal(hit, intersect.any_hit_instanced_reference(
        woops, inst.rows, *args))
    assert 0.2 < float((prim >= 0).float().mean()) < 0.9
