"""Checkpoint and resume (parallel/checkpoint.py): an optimizer's state
survives a save and a load, and a render cut after some passes resumes to
the image of an uncut render."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.parallel import checkpoint as ck
from mitsuba2_tpu_torch.python.autodiff import SGD, Adam
from mitsuba2_tpu_torch.python.test import scenes as st
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

KEYS = ["left.bsdf.reflectance.value", "light.emitter.radiance.value"]


def cornell(spp=4):
    mt.set_variant("scalar_rgb")
    s = mt.load_dict(st.cornell_box_dict(8, 8, spp, 3))
    return s, mt.traverse(s).keep(KEYS)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_optimizer_round_trip(tmp_path, kind):
    """Three steps, a save, a fresh optimizer on a fresh scene loaded from
    the file: its state and the scene's values equal the saved ones, and
    the next step of both is the same."""
    def make(p):
        return SGD(p, lr=0.1, momentum=0.5) if kind == "sgd" \
            else Adam(p, lr=0.05)

    rng = np.random.default_rng(1)
    grads = [{k: torch.tensor(rng.normal(size=3), dtype=torch.float32)
              for k in KEYS} for _ in range(4)]
    s, p = cornell()
    opt = make(p)
    for g in grads[:3]:
        opt.step(g)
    path = tmp_path / "opt.pt"
    ck.save_optimizer(str(path), opt)
    s2, p2 = cornell()
    opt2 = ck.load_optimizer(str(path), make(p2))
    for k in KEYS:
        assert torch.equal(p2[k], p[k])
    np.testing.assert_array_equal(s2.shapes[3].bsdf.reflectance.rgb,
                                  s.shapes[3].bsdf.reflectance.rgb)
    if kind == "adam":
        assert opt2.t == opt.t == 3
    opt.step(grads[3])
    opt2.step(grads[3])
    for k in KEYS:
        assert torch.equal(p2[k], p[k])


def test_film_resume_gives_the_same_image(tmp_path, monkeypatch):
    """A render of four passes cut after the second resumes from its
    checkpoint to the uncut render's image, bit for bit; a checkpoint
    written with other settings is refused."""
    s, _ = cornell(spp=4)
    s.integrator._disable_kernel = True          # four wavefront passes
    monkeypatch.setattr(type(s.integrator), "MAX_WAVEFRONT", 64)
    whole = ck.render_with_checkpoints(s, seed=3)
    path = str(tmp_path / "film.pt")
    real = type(s.integrator).render_wavefront
    calls = []

    def cut(self, *args):
        calls.append(args[4])                    # the pass's sample base
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(self, *args)

    monkeypatch.setattr(type(s.integrator), "render_wavefront", cut)
    with pytest.raises(KeyboardInterrupt):
        ck.render_with_checkpoints(s, seed=3, checkpoint_path=path,
                                   checkpoint_every=1)
    monkeypatch.setattr(type(s.integrator), "render_wavefront", real)
    data, done = ck.load_film_state(path)
    assert done == 2 and data.shape == (8, 8, 4)
    resumed = ck.render_with_checkpoints(s, seed=3, checkpoint_path=path,
                                         checkpoint_every=1)
    assert torch.equal(resumed, whole)
    with pytest.raises(ValueError, match="seed"):
        ck.render_with_checkpoints(s, seed=4, checkpoint_path=path)
