"""Differentiable rendering and optimizers on torch.autograd.

Parity: src/python/python/autodiff.py and mitsuba2_tpu/python/autodiff.py
(``render``, ``render_loss``, ``render_loss_rb``, ``Optimizer``, ``SGD``,
``Adam``). A differentiable render rides the integrator's wavefront (the
kernels have no autograd; ``_differentiable`` makes their gates refuse the
pass), its ray queries detached (scene.py ``ray_intersect_preliminary``,
K2 on the card). ``render_loss`` binds a copy of each parameter that
requires grad (python/util.py ``ParameterMap.bind``), renders, and takes
the gradient with ``torch.autograd.grad``; ``render_loss_rb`` takes it
through the path-replay adjoint of models/rb.py instead, one pass at a
time, so that its memory does not grow with the sample count.

Typical loop::

    params = mi.traverse(scene).keep([key])
    opt = Adam(params, lr=0.05)
    for it in range(100):
        loss, grads, image = render_loss(
            scene, params, lambda img: ((img - ref) ** 2).mean(), spp=4,
            seed=it)
        opt.step(grads)
"""

from __future__ import annotations

import torch

from .util import traverse, ParameterMap  # noqa: F401 (re-export)


def render(scene, spp=None, seed=0, sensor_index=0, params=None,
           values=None, unbiased=False, seed_grad=None, spp_per_pass=None):
    """Differentiable render -> (h, w, 3 + AOVs) image. With ``params``
    and ``values`` (key -> tensor), the image is a function of
    ``values``. The w * h * spp lanes render in passes of
    ``spp_per_pass`` samples (by default as many as the integrator's
    wavefront cap allows); each lane's stream is keyed by its pixel and
    sample index, so the split changes no lane.

    unbiased=True decorrelates the primal and derivative estimates
    (autodiff.py:153,176-186): the value comes from ``seed``, the
    gradient from ``seed_grad`` (``seed + 0x9E37`` by default), at twice
    the cost."""
    sensor = scene.sensors[sensor_index]
    if spp is None:
        spp = sensor.sampler.sample_count

    def render_once(vals, s):
        if params is not None and vals is not None:
            with params.bind(vals):
                return _render_passes(scene, sensor, s, spp, spp_per_pass)
        return _render_passes(scene, sensor, s, spp, spp_per_pass)

    if not unbiased:
        return render_once(values, seed)
    if seed_grad is None:
        seed_grad = seed + 0x9E37
    with torch.no_grad():
        primal = render_once(values, seed)
    deriv = render_once(values, seed_grad)
    return primal + (deriv - deriv.detach())


def _render_passes(scene, sensor, seed, spp, spp_per_pass):
    from ..render.film import ImageBlock
    integrator = scene.integrator
    w, h = sensor.film.crop_size
    integrator._differentiable = True
    try:
        if spp_per_pass is None:
            spp_per_pass = pass_spp(integrator, scene, sensor, spp)
        block = ImageBlock((w, h), 3 + len(integrator.aov_names()),
                           sensor.film.rfilter, scene.device)
        data = block.create()
        for p in range(spp // spp_per_pass):
            data = data + integrator.render_wavefront(
                scene, sensor, sensor.sampler, seed, p * spp_per_pass,
                spp_per_pass, spp)
    finally:
        integrator._differentiable = False
    return block.develop(data)


def pass_spp(integrator, scene, sensor, spp):
    """The samples a pixel takes in one pass: the most that keep the
    pass within the integrator's wavefront cap and divide ``spp``."""
    w, h = sensor.film.crop_size
    k = max(1, min(spp, integrator.wavefront_cap(scene, sensor) // (w * h)))
    while spp % k:
        k -= 1
    return k


def render_loss(scene, params: ParameterMap, loss_fn, spp=4, seed=0,
                unbiased=False, sensor_index=0, spp_per_pass=None):
    """-> (loss, grads dict, image), the taped inverse-rendering step: a
    copy of each value of ``params`` that requires grad is bound, the
    image rendered and ``loss_fn(image)`` differentiated. A key the loss
    does not reach gets a zero gradient."""
    values = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    img = render(scene, spp=spp, seed=seed, sensor_index=sensor_index,
                 params=params, values=values, unbiased=unbiased,
                 spp_per_pass=spp_per_pass)
    loss = loss_fn(img)
    keys = list(values)
    grads = torch.autograd.grad(loss, [values[k] for k in keys],
                                allow_unused=True) \
        if loss.requires_grad else [None] * len(keys)
    return loss.detach(), {
        k: g if g is not None else torch.zeros_like(values[k])
        for k, g in zip(keys, grads)}, img.detach()


def render_loss_rb(scene, params: ParameterMap, loss_fn, spp=4, seed=0,
                   sensor_index=0, spp_primal=None, spp_per_pass=None):
    """-> (loss, grads dict, image), the gradient through the path-replay
    adjoint (models/rb.py) in place of the tape: the primal image renders
    without a graph, the loss's gradient with respect to the image is the
    adjoint's input, and the adjoint runs at ``seed + 0x51`` (an
    estimate decorrelated from the primal). The scene's integrator is
    ``rb`` or another path integrator, around which an ``rb`` with its
    depths is built."""
    from ..models.rb import RBIntegrator
    integrator = scene.integrator
    if not isinstance(integrator, RBIntegrator):
        rb = RBIntegrator()
        rb.max_depth = integrator.max_depth
        rb.rr_depth = getattr(integrator, "rr_depth", 5)
        integrator = rb
    values = params.to_dict()
    with torch.no_grad():
        img = render(scene, spp=spp_primal or spp, seed=seed,
                     sensor_index=sensor_index, params=params,
                     values=values, spp_per_pass=spp_per_pass)
    img_g = img.detach().requires_grad_(True)
    loss = loss_fn(img_g)
    grad_image, = torch.autograd.grad(loss, img_g)
    grads = integrator.render_backward(
        scene, params, values, grad_image, seed=seed + 0x51, spp=spp,
        sensor_index=sensor_index, spp_per_pass=spp_per_pass)
    return loss.detach(), grads, img


class Optimizer:
    """(autodiff.py:197) base optimizer over a ParameterMap: ``step``
    takes a dict of gradients, writes the new values and calls
    ``params.update()``."""

    def __init__(self, params: ParameterMap, lr: float):
        self.params = params
        self.lr = lr

    def step(self, grads: dict):
        raise NotImplementedError

    def finish(self):
        self.params.update()

    def state_dict(self):
        raise NotImplementedError

    def load_state_dict(self, state):
        raise NotImplementedError

    def _load_params(self, state):
        for k, val in state["params"].items():
            self.params[k] = _on(val, self.params[k])
        self.params.update()


def _on(value, like):
    """``value`` as a tensor on ``like``'s device."""
    return torch.as_tensor(value).to(device=like.device, dtype=like.dtype)


class SGD(Optimizer):
    """(autodiff.py:240) stochastic gradient descent with optional
    momentum."""

    def __init__(self, params, lr, momentum=0.0):
        super().__init__(params, lr)
        self.momentum = momentum
        self.state = {k: torch.zeros_like(v) for k, v in params.items()} \
            if momentum != 0 else {}

    def step(self, grads):
        for k in list(self.params.keys()):
            g = grads.get(k)
            if g is None:
                continue
            if self.momentum != 0:
                self.state[k] = self.momentum * self.state[k] + g
                g = self.state[k]
            self.params[k] = self.params[k] - self.lr * g
        self.params.update()

    def state_dict(self):
        return {"state": dict(self.state), "params": self.params.to_dict()}

    def load_state_dict(self, state):
        self.state = {k: _on(v, self.params[k])
                      for k, v in state["state"].items()}
        self._load_params(state)


class Adam(Optimizer):
    """(autodiff.py:309) Adam with bias correction."""

    def __init__(self, params, lr, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
        super().__init__(params, lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads):
        self.t += 1
        lr_t = self.lr * (1 - self.beta_2 ** self.t) ** 0.5 \
            / (1 - self.beta_1 ** self.t)
        for k in list(self.params.keys()):
            g = grads.get(k)
            if g is None:
                continue
            self.m[k] = self.beta_1 * self.m[k] + (1 - self.beta_1) * g
            self.v[k] = self.beta_2 * self.v[k] + (1 - self.beta_2) * g * g
            self.params[k] = self.params[k] - lr_t * self.m[k] \
                / (torch.sqrt(self.v[k]) + self.epsilon)
        self.params.update()

    # -- checkpointing (parallel/checkpoint.py) ----------------------------
    def state_dict(self):
        return {"t": self.t, "m": dict(self.m), "v": dict(self.v),
                "params": self.params.to_dict()}

    def load_state_dict(self, state):
        self.t = int(state["t"])
        self.m = {k: _on(v, self.params[k]) for k, v in state["m"].items()}
        self.v = {k: _on(v, self.params[k]) for k, v in state["v"].items()}
        self._load_params(state)
