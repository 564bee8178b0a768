"""The path-replay adjoint of the port (models/rb.py, python/autodiff.py
``render_loss_rb``) against the JAX package's ``render_loss_rb`` at the
same values and seeds, and against the port's own taped gradient.

The JAX adjoint runs once, in the module fixture ``jax_rb``, on the Cornell
box at 8^2 x 4 spp, depth 3 (its compile costs seconds). Tolerances: the
gradient within 1e-4 of its largest component, the image within 1e-5 per
pixel; ``rb`` against the tape within 0.35 of the scale, the JAX test's
own bar for two independent estimators (tests/test_rb.py:54-57).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.models.rb import RBIntegrator
from mitsuba2_tpu_torch.python.autodiff import (Adam, render, render_loss,
                                                render_loss_rb)
from mitsuba2_tpu_torch.python.test import scenes as st
from tests.test_torch_autodiff import (LEFT, LIGHT, PLANE,
                                       assert_card_matches_cpu,
                                       assert_grads_agree, furnace, l2,
                                       scenes)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


@pytest.fixture(scope="module")
def jax_rb():
    import jax.numpy as jnp
    from mitsuba2_tpu.python.autodiff import render_loss_rb as rb_j
    sj_, pj, _, _ = scenes("cornell")
    lj, gj, ij = rb_j(sj_, pj, l2(jnp), spp=4, seed=5)
    return float(lj), {k: np.asarray(v) for k, v in gj.items()}, \
        np.asarray(ij)


def test_rb_matches_jax(jax_rb):
    """The red wall's albedo (set through the JAX map and carried) and the
    light's radiance: the adjoint's gradient and the primal image equal
    the JAX package's."""
    _, _, s, p = scenes("cornell")
    loss, grads, img = render_loss_rb(s, p, l2(torch), spp=4, seed=5)
    lj, gj, ij = jax_rb
    np.testing.assert_allclose(img.numpy(), ij, rtol=0, atol=1e-5)
    assert abs(float(loss) - lj) <= 1e-5 * max(abs(lj), 1.0)
    assert_grads_agree(grads, gj)


def test_rb_matches_taped_estimator():
    """rb and the tape estimate the same gradient (tests/test_rb.py's
    case: the Cornell box's red wall, L2 against a dark image, 16^2 x
    32 spp, depth 3)."""
    s = mt.load_dict(st.cornell_box_dict(16, 16, 8, 3))
    p = mt.traverse(s).keep([LEFT])
    _, g_tape, _ = render_loss(s, p, l2(torch), spp=32, seed=3)
    _, g_rb, _ = render_loss_rb(s, p, l2(torch), spp=32, seed=3)
    gt, gr = g_tape[LEFT].numpy(), g_rb[LEFT].numpy()
    assert gt.shape == gr.shape == (3,)
    scale = np.abs(gt).max()
    assert scale > 0
    np.testing.assert_allclose(gr, gt, rtol=0, atol=0.35 * scale)


def test_rb_and_prb_are_registered():
    for name in ("rb", "prb"):
        integ = mt.load_dict({"type": name, "max_depth": 4})
        assert isinstance(integ, RBIntegrator)
        assert integ.max_depth == 4


def test_rb_emitter_gradient_is_positive():
    """Gradients reach the emitter's radiance through the replay's
    attached emitter evaluations: a brighter light, a brighter image."""
    s = mt.load_dict(st.cornell_box_dict(12, 12, 8, 3))
    p = mt.traverse(s).keep([LIGHT])
    _, grads, _ = render_loss_rb(s, p, lambda im: im.mean(), spp=16, seed=0)
    assert (grads[LIGHT] > 0).all(), grads[LIGHT]


def test_rb_furnace_analytic_gradient():
    s, p = furnace()
    _, grads, _ = render_loss_rb(s, p, lambda im: im.mean(), spp=16, seed=0)
    np.testing.assert_allclose(grads[PLANE].numpy(), 1.0 / 3.0, atol=0.07)


def test_rb_adam_recovers_the_albedo():
    """Eight rb-driven Adam steps move the furnace's albedo toward the
    target (tests/test_rb.py:62-84's bars)."""
    s, p = furnace(spp=8, width=8)
    target = torch.tensor([0.2, 0.6, 0.4])
    p[PLANE] = target
    p.update()
    with torch.no_grad():
        ref = render(s, spp=64, seed=99)
    start = torch.tensor([0.5, 0.5, 0.5])
    p[PLANE] = start
    p.update()
    opt = Adam(p, lr=0.1)
    losses = []
    for it in range(8):
        loss, grads, _ = render_loss_rb(
            s, p, lambda im: ((im - ref) ** 2).mean(), spp=8, seed=it)
        losses.append(float(loss))
        opt.step(grads)
    assert losses[-1] < losses[0] * 0.5, losses
    assert (p[PLANE] - target).abs().mean() \
        < (start - target).abs().mean() * 0.6


def test_rb_passes_change_no_gradient():
    """The adjoint back-propagates one pass of lanes at a time: one pass
    of four samples and four passes of one give the same gradient to the
    rounding of the sums' order."""
    s = mt.load_dict(st.cornell_box_dict(8, 8, 4, 3))
    p = mt.traverse(s).keep([LEFT, LIGHT])
    g1 = render_loss_rb(s, p, l2(torch), spp=4, seed=1, spp_per_pass=4)[1]
    g4 = render_loss_rb(s, p, l2(torch), spp=4, seed=1, spp_per_pass=1)[1]
    for k in (LEFT, LIGHT):
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-9)


def test_rb_forward_render_is_the_path_wavefront():
    """``rb`` renders as ``path`` on its wavefront (the kernel's gate
    refuses the subclass), bit for bit."""
    d = st.cornell_box_dict(8, 8, 4, 3)
    s_path = mt.load_dict(d)
    s_path.integrator._disable_kernel = True
    d["integrator"]["type"] = "rb"
    s_rb = mt.load_dict(d)
    a = s_path.integrator.render(s_path, seed=2)
    b = s_rb.integrator.render(s_rb, seed=2)
    assert s_rb.integrator.last_engine == "wavefront"
    assert s_rb.integrator.engine_reason == "non-path integrator subclass"
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_rb_gradient_matches_cpu():
    assert_card_matches_cpu(render_loss_rb)
