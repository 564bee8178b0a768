"""The hero path (bench.py's production-shaped config: a smooth-shaded
.serialized mesh in GGX gold under the importance-sampled sky, on a
checker floor) as a whole: ``load_dict`` + ``scene.integrator.render`` of
the port against the JAX integrator on its path kernel (Pallas interpret
mode, the ``_force_megakernel`` test hook), from the same scene dict and
seed, at 16^2 x 4 spp, depth 3, on a 1,218-face hero mesh (32 x 20),
which takes the reference's streamed tier and the port's BVH tier with
the env, GGX and checker flags.

Tolerance: the Cornell bar, at least 99% of pixels within 1e-4 relative
and image means within 1e-5, with the reference's polynomial atan2/acos
(megakernel.py:174-191) patched to exact math as test_torch_matpreview.py
does (the JAX package is not edited); its bf16 Woop products are left as
they are. Measured: every pixel within 1.2e-5, means 1.5e-6 apart;
unpatched, 99.6% of pixels within 1e-4 (the worst 2.4e-4).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from tests.test_torch_mesh_io import jax_bumpy_dict, jax_hero_dict
from tests.test_torch_path_kernel import (assert_images_agree,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, SEED = 16, 4, 3, 5
NU, NV = 32, 20
FLAGS = pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER | pk.HAS_BVH


def jax_dict(width=W, spp=SPP, max_depth=MAX_DEPTH):
    return jax_hero_dict(width, width, spp, max_depth, NU, NV)


@pytest.fixture(scope="module")
def reference():
    """The JAX integrator's image of hero on its path kernel, with exact
    atan2/acos, and its megakernel object."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(jax_dict())
    scene.integrator._force_megakernel = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_atan2", jnp.arctan2)
        mp.setattr(mk_mod, "_acos",
                   lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
        img = np.asarray(scene.integrator.render(scene, seed=SEED, spp=SPP))
    assert scene.integrator.last_engine == "megakernel"
    mk = scene.integrator._mk_cache[1]
    assert mk.streamed and mk.has_env and mk.has_ggx and mk.has_checker
    return img, mk


def port_scene():
    mt.set_variant("scalar_rgb")
    return mt.load_dict(scenes_t.hero_serialized_dict(W, W, SPP, MAX_DEPTH,
                                                      NU, NV))


def test_render_matches_jax_kernel(reference):
    st = port_scene()
    assert st.tables.n_faces == 1218
    assert st.tables.flags & pk.TEMPLATE_FLAGS == FLAGS
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert img.shape == (W, W, 3) and torch.isfinite(img).all()
    assert_images_agree(img.numpy(), reference[0])


def test_face_tables_are_the_references_row_for_row(reference):
    """Every attribute column the reference packs (normals, albedo, GGX
    and checker columns, uvs and to_uv) equals the port's at the same face
    id; the env tables are the matpreview sky's."""
    mk = reference[1]
    st = port_scene()
    F = st.tables.n_faces
    A = np.asarray(mk._fattr())
    packed = pk._attr_from_reference(np.ones((len(A), 1)))[0] == 1
    assert packed[[pk.C_NG, pk.C_ALB, pk.C_KIND, pk.C_ALPHA, pk.C_ETA,
                   pk.C_K, pk.C_C1, pk.C_UV0, pk.C_DUV1, pk.C_DUV2,
                   pk.C_TOUV0, pk.C_TOUV1]].all()
    np.testing.assert_allclose(
        st.tables.fattr.numpy()[:, packed],
        pk._attr_from_reference(A)[:F][:, packed], rtol=1e-6, atol=1e-6)
    kinds = st.tables.fattr[:, pk.C_KIND]
    assert int((kinds == pk.KIND_GGX).sum()) == 1216
    assert int((kinds == pk.KIND_CHECKER).sum()) == 2
    assert st.tables.env.shape == (64, 128, 4) and st.tables.p_env == 1.0


def test_scene_dicts_are_the_reference_dicts():
    """The port's biggeo and hero dicts are the reference's, key for key
    and value for value (transforms compared by matrix); only the files
    differ in name, not in content (test_torch_mesh_io.py)."""
    def same(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                if k != "filename":
                    same(a[k], b[k], f"{path}.{k}")
        elif hasattr(a, "matrix"):
            np.testing.assert_allclose(np.asarray(a.matrix),
                                       np.asarray(b.matrix), rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        else:
            assert a == b, path

    same(jax_bumpy_dict(8, 8, 2, 3, 32, 20),
         scenes_t.bumpy_sphere_dict(8, 8, 2, 3, 32, 20), "biggeo")
    same(jax_dict(8, 2, 3), scenes_t.hero_serialized_dict(8, 8, 2, 3, NU, NV),
         "hero")


def test_big_mesh_renders_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys\n"
        "import mitsuba2_tpu_torch as mi\n"
        "from mitsuba2_tpu_torch.python.test.scenes import (\n"
        "    bumpy_sphere_dict, hero_serialized_dict)\n"
        "from mitsuba2_tpu_torch.core.ray import Ray\n"
        "mi.set_variant('scalar_rgb')\n"
        "mi.set_device('cpu')\n"
        "for d in (bumpy_sphere_dict(4, 4, 2, 3, 32, 20),\n"
        "          hero_serialized_dict(4, 4, 2, 3, 32, 20)):\n"
        "    s = mi.load_dict(d)\n"
        "    img = s.integrator.render(s, seed=0, spp=2)\n"
        "    assert img.shape == (4, 4, 3) and s.integrator.last_engine\n"
        "    r = Ray.make([[0.0, 0.0, 5.0]], [[0.0, 0.0, -1.0]])\n"
        "    s.ray_intersect_preliminary(r), s.ray_test(r)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'mitsuba2_tpu.')) or m == 'mitsuba2_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
