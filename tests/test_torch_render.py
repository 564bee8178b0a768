"""The ported slice as a whole: ``load_dict`` + ``scene.integrator.render``
of the PyTorch port against the JAX package on the same dict and seed.

Per pixel against the JAX path kernel (Pallas interpret mode, which the
JAX integrator takes with its ``_force_megakernel`` test hook), with the
tolerance stated in test_torch_path_kernel.py; by image mean against the
JAX wavefront, whose sampler dimensions are sequential and so draw other
random numbers (the reference's own 5% check, test_megakernel.py:56-63).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cornell_t
from tests.test_torch_path_kernel import (
    assert_images_agree, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

REPO = Path(__file__).resolve().parent.parent


def _dicts(width, spp, max_depth, rr_depth):
    out = []
    for make in (cornell_j, cornell_t):
        d = make(width=width, height=width, spp=spp, max_depth=max_depth)
        d["integrator"]["rr_depth"] = rr_depth
        out.append(d)
    return out


def test_render_matches_jax_kernel_per_pixel():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    dj, dt = _dicts(16, 16, 4, 2)
    sj = mj.load_dict(dj)
    sj.integrator._force_megakernel = True
    ref = np.asarray(sj.integrator.render(sj, seed=5, spp=16))
    assert sj.integrator.last_engine == "megakernel"
    st = mt.load_dict(dt)
    img = st.integrator.render(st, seed=5, spp=16)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert img.shape == (16, 16, 3) and img.dtype == torch.float32
    assert img.device == torch.device("cpu")
    assert torch.isfinite(img).all()
    assert_images_agree(img.numpy(), ref)


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_mono"])
def test_uniform_spectrum_light_renders_on_the_kernel(variant):
    """An area light written as ``{"type": "spectrum", "value": 15}`` (a
    ``UniformSpectrum`` in both packages) passes the JAX gate and the
    port's, and the port's path kernel renders it with 15 in every
    channel, as the reference's wavefront evaluates it. The JAX kernel
    cannot pack such a light (its light table reads a color's
    ``_rgb_np``, so its build fails and it falls back to its wavefront):
    the image is held per pixel against the JAX kernel's image of the same
    light written as the rgb color 15."""
    from mitsuba2_tpu.ops.megakernel import megakernel_ineligibility
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        dj, dt = _dicts(16, 4, 3, 2)
        uniform = {"type": "spectrum", "value": 15.0}
        dj["light"]["emitter"]["radiance"] = {"type": "rgb",
                                              "value": [15.0] * 3}
        sj = mj.load_dict(dj)
        sj.integrator._force_megakernel = True
        ref = np.asarray(sj.integrator.render(sj, seed=5, spp=4))
        assert sj.integrator.last_engine == "megakernel"
        dj["light"]["emitter"]["radiance"] = dict(uniform)
        assert megakernel_ineligibility(mj.load_dict(dj)) is None
        dt["light"]["emitter"]["radiance"] = dict(uniform)
        st = mt.load_dict(dt)
        assert type(st.emitters[0].radiance).__name__ == "UniformSpectrum"
        img = st.integrator.render(st, seed=5, spp=4)
        assert st.integrator.last_engine == "kernel"
        assert st.integrator.engine_reason is None
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        assert_images_agree(img.numpy(), ref)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_render_mean_matches_jax_wavefront():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    dj, dt = _dicts(24, 64, 4, 1000)
    sj = mj.load_dict(dj)
    ref = np.asarray(sj.integrator.render(sj, seed=10, spp=64))
    assert sj.integrator.last_engine == "wavefront"
    st = mt.load_dict(dt)
    img = st.integrator.render(st, seed=3, spp=64).numpy()
    assert abs(img.mean() - ref.mean()) <= 0.05 * ref.mean(), \
        (img.mean(), ref.mean())


def test_pass_splitting_keeps_the_image():
    """Several passes (per-pass sample_base) render the same samples as
    one pass; only the order of the per-pixel sums differs."""
    mt.set_variant("scalar_rgb")
    d = cornell_t(width=8, height=8, spp=8, max_depth=3)
    st = mt.load_dict(d)
    one = st.integrator.render(st, seed=1, spp=8)
    st.integrator.MAX_WAVEFRONT_KERNEL = 8 * 8 * 2      # 4 passes
    four = st.integrator.render(st, seed=1, spp=8)
    torch.testing.assert_close(four, one, rtol=1e-6, atol=1e-7)


def _out_of_scope():
    from mitsuba2_tpu_torch.models.bsdfs import SmoothDiffuse
    from mitsuba2_tpu_torch.models.emitters import EnvironmentMap
    from mitsuba2_tpu_torch.models.textures import BitmapTexture
    from mitsuba2_tpu_torch.render.bsdf import BSDF
    from mitsuba2_tpu_torch.render.shape import Shape

    class Mirror(BSDF):
        pass

    class RoughDielectric(BSDF):        # stands in for the unported plugin
        pass

    class Quadric(Shape):
        def bbox(self):
            return np.zeros(3), np.ones(3)

    def many_faces(d):
        add_tiles(d, 513)                # 36 + 1026 triangles

    def mirror(scene):
        scene.shapes[0].bsdf = Mirror()

    def quadric(scene):
        scene.shapes.append(Quadric())

    def rough_dielectric(scene):
        # test_megakernel.py:237-240
        scene.shapes[1].bsdf = RoughDielectric()

    def beckmann_plastic(d):
        d["shortbox"]["bsdf"] = {"type": "roughplastic", "alpha": 0.2}

    def wide_bitmap(scene):
        bsdf = SmoothDiffuse()
        bsdf.reflectance = BitmapTexture(data=np.ones((2, 1025, 3)))
        scene.shapes[0].bsdf = bsdf

    def many_disks(d):
        for i in range(65):
            d[f"disk{i}"] = {"type": "disk", "to_world": mt.Transform.translate(
                [0, 0, -2 - i])}

    def disk_in_volpath(d):
        d["rug"] = {"type": "disk"}

    def anisotropic(d):
        d["back"]["bsdf"] = {"type": "roughconductor", "distribution": "ggx",
                             "alpha_u": 0.1, "alpha_v": 0.3}

    def sky(width):
        return EnvironmentMap(data=np.ones((8, width, 3), np.float32))

    def two_envmaps(scene):
        scene.environment_emitter = sky(16)
        scene.emitters += [scene.environment_emitter, sky(16)]

    def wide_envmap(scene):
        scene.environment_emitter = sky(512)
        scene.emitters.append(scene.environment_emitter)

    def flipped_sphere(d):
        d["ball"] = {"type": "sphere", "radius": 0.2, "flip_normals": True}

    def plain_emitter(scene):
        from mitsuba2_tpu_torch.models.textures import ConstantTexture
        scene.emitters[0].radiance = ConstantTexture(color=1.0)

    def ior_curve(d):
        # a curve spectrum the user gave as the conductor's eta
        d["tallbox"]["bsdf"] = {"type": "roughconductor", "alpha": 0.2,
                                "distribution": "ggx",
                                "eta": {"type": "d65"}, "k": [3.9, 2.4, 1.6]}

    # (dict edit, scene edit, the kernel gate's reason, and for a scene
    # the wavefront cannot render either, its reason)
    return {
        # the cap lowered to 1024 (the reference's is MAX_FACES_HBM)
        "face count": (many_faces, None, "face count 1062 > 1024", None),
        # the wavefront renders it as the unpolarized variant, as the
        # reference's does
        "polarized variant": (None, None, "polarized variant", None),
        # the wavefront renders it in float32, as the reference's does
        "double-precision variant": (None, None,
                                     "double-precision variant", None),
        "conductor IOR curve spectrum": (
            ior_curve, None, "conductor IOR curve spectra in spectral mode",
            None),
        "emitter without D65 payload": (
            None, plain_emitter,
            "area emitter spectrum without srgb_d65 payload", None),
        "bsdf": (None, mirror, "unsupported BSDF Mirror",
                 "BSDF Mirror has no wavefront sample/eval/pdf"),
        "shape": (None, quadric, "non-triangle shape Quadric",
                  "non-triangle shape Quadric"),
        "roughdielectric": (None, rough_dielectric,
                            "unsupported BSDF RoughDielectric",
                            "BSDF RoughDielectric has no wavefront "
                            "sample/eval/pdf"),
        "beckmann roughplastic": (beckmann_plastic, None,
                                  "unsupported BSDF RoughPlastic", None),
        "bitmap wider than 1024": (None, wide_bitmap,
                                   "bitmap 1025x2 beyond the kernel's 1024",
                                   None),
        "65 disks": (many_disks, None, "disk/cylinder count > 64", None),
        "disk in a volpath scene": (
            disk_in_volpath, None, "analytic shapes/instances", None),
        "anisotropic roughconductor": (anisotropic, None,
                                       "unsupported BSDF RoughConductor",
                                       None),
        "two envmaps": (None, two_envmaps, "multiple envmaps", None),
        "envmap wider than 256": (None, wide_envmap,
                                  "envmap larger than 256", None),
        "flipped sphere": (flipped_sphere, None, "sphere with flip_normals",
                           None),
    }


def add_tiles(d, n):
    """``n`` rectangles (2n triangles) behind the Cornell box."""
    for i in range(n):
        d[f"tile{i}"] = {"type": "rectangle",
                         "to_world": mt.Transform.translate([0, 0, -2 - i])}


_CASE_VARIANT = {"polarized variant": "scalar_rgb_polarized",
                 "double-precision variant": "scalar_rgb_double",
                 "conductor IOR curve spectrum": "scalar_spectral",
                 "emitter without D65 payload": "scalar_spectral"}


@pytest.mark.parametrize("case", sorted(_out_of_scope()))
def test_out_of_scope_scene_raises_with_reason(case, monkeypatch):
    """A scene outside the path kernel's scope renders through the general
    wavefront, with the gate's reason kept in ``engine_reason``; a scene
    outside the wavefront's scope too raises with the missing piece."""
    from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
    edit_dict, edit_scene, reason, wavefront_reason = _out_of_scope()[case]
    if case == "face count":
        monkeypatch.setattr(pk, "MAX_FACES_HBM", 1024)
    mt.set_variant(_CASE_VARIANT.get(case, "scalar_rgb"))
    try:
        d = (volpath_slab_dict if "volpath" in case else cornell_t)(
            width=4, height=4, spp=1)
        if edit_dict:
            edit_dict(d)
        scene = mt.load_dict(d)
        if edit_scene:
            edit_scene(scene)
        if wavefront_reason is None:
            img = scene.integrator.render(scene, seed=0, spp=1)
            assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
            assert scene.integrator.last_engine == "wavefront"
        else:
            with pytest.raises(NotImplementedError,
                               match=wavefront_reason) as err:
                scene.integrator.render(scene, seed=0, spp=1)
            assert reason in str(err.value)
            assert scene.integrator.last_engine is None
        assert scene.integrator.engine_reason.startswith(reason)
    finally:
        mt.set_variant("scalar_rgb")


def _formerly_refused():
    def gaussian(d):
        d["sensor"]["film"]["rfilter"]["type"] = "gaussian"

    def dielectric(d):
        d["tallbox"]["bsdf"] = {"type": "dielectric"}

    return {"gaussian rfilter": (gaussian, 0, 8),
            "dielectric": (dielectric, pk.HAS_LOBES, 4)}


@pytest.mark.parametrize("case", sorted(_formerly_refused()))
def test_formerly_refused_scene_renders(case):
    """The reference's default film filter and the smooth dielectric, which
    the path kernel refused before its splat and its lobes were ported,
    render through the kernel's plain version: the developed image, and
    the (h + 2b, w + 2b) block of the gaussian's border."""
    edit, flags, block_w = _formerly_refused()[case]
    mt.set_variant("scalar_rgb")
    d = cornell_t(width=4, height=4, spp=2, max_depth=3)
    edit(d)
    scene = mt.load_dict(d)
    assert scene.tables.flags & pk.TEMPLATE_FLAGS == flags
    img = scene.integrator.render(scene, seed=0, spp=2)
    assert scene.integrator.last_engine == "kernel"
    assert scene.integrator.engine_reason is None
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
    assert img.mean() > 0
    block = scene.integrator.render(scene, seed=0, spp=2, develop=False)
    assert block.shape == (block_w, block_w, 4)


def test_scene_above_the_shared_tier_takes_the_bvh_tier():
    """1,062 faces are more than the shared-memory tier's 1024: the scene
    is accepted, its tables select the BVH tier, and the render is the
    plain version's image of the same tables without that tier."""
    mt.set_variant("scalar_rgb")
    d = cornell_t(width=8, height=8, spp=2, max_depth=3)
    add_tiles(d, 513)
    scene = mt.load_dict(d)
    assert scene.tables.n_faces == 1062
    assert scene.tables.flags & pk.HAS_BVH
    img = scene.integrator.render(scene, seed=4, spp=2)
    assert scene.integrator.engine_reason is None
    assert scene.integrator.last_engine == "kernel"
    shared = scene.tables._replace(flags=scene.tables.flags & ~pk.HAS_BVH)
    rad = pk.path_radiance_reference(
        shared, pk.camera_row(scene.sensors[0], "cpu"), 4, 0, 2, 8, 8, 3,
        scene.integrator.rr_depth)
    torch.testing.assert_close(
        img, rad.reshape(3, 64, 2).mean(2).T.reshape(8, 8, 3))


def test_face_cap_is_the_references(monkeypatch):
    """The cap is megakernel.py's MAX_FACES_HBM; the wrapper refuses tables
    above it as the gate does (here with the cap lowered)."""
    assert pk.MAX_FACES_HBM == 1 << 20
    mt.set_variant("scalar_rgb")
    d = cornell_t(width=4, height=4, spp=1)
    add_tiles(d, 513)
    scene = mt.load_dict(d)
    cam = pk.camera_row(scene.sensors[0], "cpu")
    pk._check_tables(scene.tables, cam)
    monkeypatch.setattr(pk, "MAX_FACES_HBM", 1024)
    with pytest.raises(ValueError, match="1062 faces > 1024"):
        pk._check_tables(scene.tables, cam)


def test_render_refuses_device_without_kernel():
    prev = mt.device()
    try:
        mt.set_device("meta")
        scene = mt.load_dict(cornell_t(width=4, height=4, spp=1))
    finally:
        mt.set_device(prev)
    with pytest.raises(ValueError, match="no path kernel"):
        scene.integrator.render(scene, seed=0, spp=1)


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "import mitsuba2_tpu_torch as mi\n"
        "from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict\n"
        "from mitsuba2_tpu_torch.ops import bvh, intersect, intersect_kernel\n"
        "from mitsuba2_tpu_torch.utils import io_obj, io_ply, serialized\n"
        "from mitsuba2_tpu_torch import cli\n"
        "from mitsuba2_tpu_torch.python import xml\n"
        "from mitsuba2_tpu_torch.core import xml_impl, xmlio\n"
        "from mitsuba2_tpu_torch.core import fresolver, ray\n"
        "from mitsuba2_tpu_torch.render import records, mueller\n"
        "from mitsuba2_tpu_torch.utils import tensorfile\n"
        "from mitsuba2_tpu_torch.core import spline, quad\n"
        "from mitsuba2_tpu_torch.models import measured, rb\n"
        "from mitsuba2_tpu_torch.python import util, autodiff\n"
        "from mitsuba2_tpu_torch.parallel import checkpoint\n"
        "mi.set_variant('scalar_rgb')\n"
        "mi.set_device('cpu')\n"
        "s = mi.load_dict(cornell_box_dict(width=4, height=4, spp=2))\n"
        "img = s.integrator.render(s, seed=0, spp=2)\n"
        "assert img.shape == (4, 4, 3)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'mitsuba2_tpu.')) or m == 'mitsuba2_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_kernel_launch_count_is_untouched_on_cpu():
    before = pk.path_radiance.launches
    st = mt.load_dict(cornell_t(width=4, height=4, spp=2))
    st.integrator.render(st, seed=0, spp=2)
    assert pk.path_radiance.launches == before


@pytest.mark.cuda
def test_cuda_render_goes_through_kernel_and_matches_cpu():
    """The slice on the card: one kernel launch per pass, and the image of
    the CPU render (plain version) per pixel, at the main path's depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    d = cornell_t(width=32, height=32, spp=8, max_depth=6)
    prev = mt.device()
    try:
        images = {}
        for dev in ("cpu", "cuda"):
            mt.set_device(dev)
            scene = mt.load_dict(d)
            before = pk.path_radiance.launches
            images[dev] = scene.integrator.render(scene, seed=2, spp=8)
            assert scene.integrator.last_engine == "kernel"
            assert pk.path_radiance.launches == before + (dev == "cuda")
    finally:
        mt.set_device(prev)
    assert images["cuda"].device.type == "cuda"
    assert_images_agree(images["cuda"].cpu().numpy(), images["cpu"].numpy())
