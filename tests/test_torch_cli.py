"""The port's command line (``python -m mitsuba2_tpu_torch``, cli.py):
an XML scene with a ``-D`` substitution and a ``.json`` scene rendered on
the CPU (``--cpu``) in a subprocess, the image read back against the
in-process render of the same file at the same seed and spp."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import cornell_xml_path
from mitsuba2_tpu_torch.utils.io_image import read_image
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

REPO = Path(__file__).resolve().parent.parent


def run_cli(*args):
    out = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch",
                          "--cpu", *args], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out


def test_cli_renders_xml_with_defines(tmp_path):
    """The XML Cornell box at 8^2 x 4 spp with its depth a ``$depth``
    parameter set by ``-D``: exit 0, the log names the face count, and
    the EXR (half floats) holds the in-process render at seed 3."""
    text = Path(cornell_xml_path(8, 8, 4, 6)).read_text()
    text = text.replace('<integer name="max_depth" value="6"/>',
                        '<integer name="max_depth" value="$depth"/>', 1)
    text = text.replace('<scene version="2.0.0">',
                        '<scene version="2.0.0">\n'
                        '    <default name="depth" value="6"/>', 1)
    scene_path = tmp_path / "cbox.xml"
    scene_path.write_text(text)
    exr = tmp_path / "out.exr"
    out = run_cli(str(scene_path), "-o", str(exr), "-D", "depth=3", "-s",
                  "4", "--seed", "3", "-t", "4")
    assert "36 faces" in out.stderr
    mt.set_variant("scalar_rgb")
    scene = mt.load_file(str(scene_path), params={"depth": "3"})
    assert scene.integrator.max_depth == 3
    want = scene.integrator.render(scene, seed=3, spp=4).numpy()
    got = read_image(str(exr))
    assert got.shape == (8, 8, 3)
    np.testing.assert_array_equal(got, want.astype(np.float16)
                                  .astype(np.float32))


def test_cli_renders_json_scene(tmp_path):
    """A ``.json`` dict scene (a matrix for the sensor's transform) to a
    PFM file: the in-process render bit for bit."""
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": 2},
         "light": {"type": "constant"},
         "quad": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
         "sensor": {"type": "perspective",
                    "to_world": np.asarray(mt.Transform.look_at(
                        [0, 0, 3], [0, 0, 0], [0, 1, 0]).matrix).tolist(),
                    "film": {"type": "hdrfilm", "width": 8, "height": 6,
                             "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent", "sample_count": 2}}}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(d))
    run_cli(str(path))
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(json.loads(path.read_text()))
    want = scene.integrator.render(scene, seed=0, spp=2).numpy()
    got = read_image(str(tmp_path / "scene.exr"))
    np.testing.assert_array_equal(got, want.astype(np.float16)
                                  .astype(np.float32))
    pfm = tmp_path / "out.pfm"
    run_cli(str(path), "-o", str(pfm))
    np.testing.assert_array_equal(read_image(str(pfm)), want)


def test_cli_rejects_unknown_flags():
    out = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch",
                          "--multichip", "x.xml"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "--multichip" in out.stderr


@pytest.mark.cuda
def test_cuda_cli_matches_in_process_render(tmp_path):
    """Without ``--cpu`` the command renders on the card: the XML Cornell
    box's EXR is the in-process card render's."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = cornell_xml_path(32, 32, 8, 4)
    exr = tmp_path / "card.exr"
    out = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch", path,
                          "-o", str(exr)], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    prev = mt.device()
    mt.set_device("cuda")
    try:
        scene = mt.load_file(path)
        want = scene.integrator.render(scene, seed=0, spp=8).cpu().numpy()
    finally:
        mt.set_device(prev)
    np.testing.assert_array_equal(read_image(str(exr)),
                                  want.astype(np.float16).astype(np.float32))
