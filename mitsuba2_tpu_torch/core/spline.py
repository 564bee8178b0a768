"""Catmull-Rom splines: evaluation, integration, inversion and sampling
(reference: include/mitsuba/core/spline.h; counterpart of
``mitsuba2_tpu.core.spline``).

Every function is vectorized over its query points; node arrays are
tensors of static shape. The Newton solves take a fixed number of steps,
bracketed by bisection, as the JAX package's do. Prefix sums are
``distr_1d.cumsum16``'s, the order of the JAX package's sums on the CPU.
"""

from __future__ import annotations

import torch

from . import math as m
from .distr_1d import cumsum16


def eval_spline(f0, f1, d0, d1, t):
    """The cubic Hermite segment on [0, 1] (spline.h eval_spline)."""
    t2 = t * t
    t3 = t2 * t
    return ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
            + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)


def eval_spline_d(f0, f1, d0, d1, t):
    """(value, derivative in t) (spline.h eval_spline_d)."""
    t2 = t * t
    v = eval_spline(f0, f1, d0, d1, t)
    d = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
         + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
    return v, d


def eval_spline_i(f0, f1, d0, d1, t):
    """(integral from 0 to t, value at t) (spline.h eval_spline_i)."""
    t2 = t * t
    t3 = t2 * t
    t4 = t2 * t2
    h00 = 0.5 * t4 - t3 + t
    h10 = 0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2
    h01 = -0.5 * t4 + t3
    h11 = 0.25 * t4 - t3 / 3.0
    integ = h00 * f0 + h10 * d0 + h01 * f1 + h11 * d1
    return integ, eval_spline(f0, f1, d0, d1, t)


def _take(values, idx):
    return values[..., idx.long()]


def _segment_uniform(values, idx):
    """The Hermite coefficients of uniform-node segments ``idx``."""
    n = values.shape[-1]
    f0 = _take(values, idx)
    f1 = _take(values, idx + 1)
    fm = _take(values, torch.clamp(idx - 1, min=0))
    fp = _take(values, torch.clamp(idx + 2, max=n - 1))
    d0 = torch.where(idx > 0, 0.5 * (f1 - fm), f1 - f0)
    d1 = torch.where(idx + 2 < n, 0.5 * (fp - f0), f1 - f0)
    return f0, f1, d0, d1


def _floor_index(t, n):
    return torch.clamp(t.to(torch.int32), 0, n - 2)


def eval_1d(min_, max_, values, x):
    """Catmull-Rom on uniform nodes over [min_, max_], 0 outside
    (spline.h eval_1d)."""
    values = torch.as_tensor(values)
    n = values.shape[-1]
    t = (x - min_) * ((n - 1) / (max_ - min_))
    idx = _floor_index(t, n)
    tt = t - idx.to(t.dtype)
    v = eval_spline(*_segment_uniform(values, idx), tt)
    return torch.where((x >= min_) & (x <= max_), v, 0.0)


def _search(nodes, x):
    """searchsorted(side right) of ``x`` in the 1-D ``nodes``."""
    return torch.searchsorted(nodes.contiguous(), x.contiguous(), right=True)


def _segment_nonuniform(nodes, values, idx):
    n = values.shape[-1]
    x0 = _take(nodes, idx)
    x1 = _take(nodes, idx + 1)
    w = x1 - x0
    f0 = _take(values, idx)
    f1 = _take(values, idx + 1)
    fm = _take(values, torch.clamp(idx - 1, min=0))
    fp = _take(values, torch.clamp(idx + 2, max=n - 1))
    xm = _take(nodes, torch.clamp(idx - 1, min=0))
    xp = _take(nodes, torch.clamp(idx + 2, max=n - 1))
    d0 = torch.where(idx > 0, w * m.safe_div(f1 - fm, x1 - xm, 0.0), f1 - f0)
    d1 = torch.where(idx + 2 < n, w * m.safe_div(fp - f0, xp - x0, 0.0),
                     f1 - f0)
    return x0, w, f0, f1, d0, d1


def eval_1d_nonuniform(nodes, values, x):
    """Catmull-Rom on the explicit ``nodes``, 0 outside them (spline.h
    eval_1d)."""
    nodes = torch.as_tensor(nodes)
    values = torch.as_tensor(values)
    n = values.shape[-1]
    idx = torch.clamp(_search(nodes, x) - 1, 0, n - 2)
    x0, w, f0, f1, d0, d1 = _segment_nonuniform(nodes, values, idx)
    v = eval_spline(f0, f1, d0, d1, m.safe_div(x - x0, w, 0.0))
    return torch.where((x >= nodes[..., 0]) & (x <= nodes[..., -1]), v, 0.0)


def eval_spline_weights(min_, max_, size, x):
    """(valid, base index, weights (..., 4)) with f(x) = sum_k w_k f[base
    + k] on uniform nodes (spline.h eval_spline_weights): the derivative
    weights spread onto the neighbouring nodes."""
    t = (x - min_) * ((size - 1) / (max_ - min_))
    idx = _floor_index(t, size)
    tt = t - idx.to(t.dtype)
    t2 = tt * tt
    t3 = t2 * tt
    w_f0 = 2 * t3 - 3 * t2 + 1
    w_f1 = -2 * t3 + 3 * t2
    w_d0 = t3 - 2 * t2 + tt
    w_d1 = t3 - t2
    # d0 = (f[i+1] - f[i-1]) / 2, or one-sided f[i+1] - f[i]; likewise d1
    has_left = idx > 0
    has_right = idx + 2 < size
    zero = torch.zeros_like(tt)
    w0 = torch.where(has_left, -0.5 * w_d0, zero)
    w1 = w_f0 + torch.where(has_left, zero, -w_d0) \
        + torch.where(has_right, -0.5 * w_d1, -w_d1)
    w2 = w_f1 + torch.where(has_left, 0.5 * w_d0, w_d0) \
        + torch.where(has_right, zero, w_d1)
    w3 = torch.where(has_right, 0.5 * w_d1, zero)
    valid = (x >= min_) & (x <= max_)
    return valid, idx - 1, torch.stack([w0, w1, w2, w3], -1)


def integrate_1d(min_, max_, values):
    """The spline's integrals from min_ to each uniform node (spline.h
    integrate_1d)."""
    values = torch.as_tensor(values)
    n = values.shape[-1]
    h = (max_ - min_) / (n - 1)
    idx = torch.arange(n - 1, device=values.device)
    f0, f1, d0, d1 = _segment_uniform(values, idx)
    seg, _ = eval_spline_i(f0, f1, d0, d1, torch.ones_like(f0))
    return torch.cat([torch.zeros_like(values[..., :1]),
                      cumsum16(seg * h)], -1)


def _newton(t, n_iter, value_and_slope, target):
    """A bracketed Newton solve of value_and_slope(t)[0] = target on [0,
    1]."""
    lo = torch.zeros_like(t)
    hi = torch.ones_like(t)
    for _ in range(n_iter):
        v, d = value_and_slope(t)
        err = v - target
        lo = torch.where(err <= 0, t, lo)
        hi = torch.where(err > 0, t, hi)
        t_newton = t - m.safe_div(err, d, 0.0)
        inside = (t_newton > lo) & (t_newton < hi)
        t = torch.where(inside, t_newton, 0.5 * (lo + hi))
    return t


def invert_1d(min_, max_, values, y, n_iter: int = 10):
    """The x where a monotonic spline on uniform nodes reaches ``y``
    (spline.h invert_1d)."""
    values = torch.as_tensor(values)
    n = values.shape[-1]
    idx = torch.clamp(_search(values, y) - 1, 0, n - 2)
    f0, f1, d0, d1 = _segment_uniform(values, idx)
    t = torch.clamp(m.safe_div(y - f0, f1 - f0, 0.5), 0.0, 1.0)
    t = _newton(t, n_iter, lambda t: eval_spline_d(f0, f1, d0, d1, t), y)
    h = (max_ - min_) / (n - 1)
    return min_ + (idx.to(t.dtype) + t) * h


def sample_1d(min_, max_, values, cdf, sample, n_iter: int = 10):
    """A sample of the spline density on uniform nodes (``cdf`` from
    ``integrate_1d``) -> (position, function value, normalized pdf)
    (spline.h sample_1d)."""
    values = torch.as_tensor(values)
    cdf = torch.as_tensor(cdf)
    n = values.shape[-1]
    h = (max_ - min_) / (n - 1)
    total = cdf[..., -1]
    target = sample * total
    idx = torch.clamp(_search(cdf, target) - 1, 0, n - 2)
    f0, f1, d0, d1 = _segment_uniform(values, idx)
    rem = (target - _take(cdf, idx)) / h
    # bracketed Newton on the segment's cdf (monotone for f >= 0)
    t = torch.clamp(m.safe_div(rem, f0, 0.5), 0.0, 1.0)
    t = _newton(t, n_iter, lambda t: eval_spline_i(f0, f1, d0, d1, t), rem)
    _, v = eval_spline_i(f0, f1, d0, d1, t)
    x = min_ + (idx.to(t.dtype) + t) * h
    return x, v, m.safe_div(v, total, 0.0)


def eval_2d(nodes_x, nodes_y, values, x, y):
    """The tensor-product Catmull-Rom spline of ``values`` (ny, nx) on
    the explicit nodes, 0 outside them (spline.h eval_2d)."""
    nodes_x = torch.as_tensor(nodes_x)
    nodes_y = torch.as_tensor(nodes_y)
    values = torch.as_tensor(values)
    ny, nx = values.shape[-2], values.shape[-1]
    okx, bx, wx = _weights_nonuniform(nodes_x, x)
    oky, by, wy = _weights_nonuniform(nodes_y, y)
    out = 0.0
    for iy in range(4):
        row = 0.0
        ry = torch.clamp(by + iy, 0, ny - 1).long()
        for ix in range(4):
            rx = torch.clamp(bx + ix, 0, nx - 1).long()
            row = row + wx[..., ix] * values[ry, rx]
        out = out + wy[..., iy] * row
    return torch.where(okx & oky, out, 0.0)


def _weights_nonuniform(nodes, x):
    n = nodes.shape[-1]
    idx = torch.clamp(_search(nodes, x) - 1, 0, n - 2)
    x0 = _take(nodes, idx)
    x1 = _take(nodes, idx + 1)
    w = x1 - x0
    t = m.safe_div(x - x0, w, 0.0)
    t2 = t * t
    t3 = t2 * t
    w_f0 = 2 * t3 - 3 * t2 + 1
    w_f1 = -2 * t3 + 3 * t2
    w_d0 = t3 - 2 * t2 + t
    w_d1 = t3 - t2
    xm = _take(nodes, torch.clamp(idx - 1, min=0))
    xp = _take(nodes, torch.clamp(idx + 2, max=n - 1))
    has_left = idx > 0
    has_right = idx + 2 < n
    s_l = m.safe_div(w, x1 - xm, 0.0)
    s_r = m.safe_div(w, xp - x0, 0.0)
    zero = torch.zeros_like(t)
    w0 = torch.where(has_left, -w_d0 * s_l, zero)
    w1 = w_f0 + torch.where(has_left, zero, -w_d0) \
        + torch.where(has_right, -w_d1 * s_r, -w_d1)
    w2 = w_f1 + torch.where(has_left, w_d0 * s_l, w_d0) \
        + torch.where(has_right, zero, w_d1)
    w3 = torch.where(has_right, w_d1 * s_r, zero)
    ok = (x >= nodes[..., 0]) & (x <= nodes[..., -1])
    return ok, idx - 1, torch.stack([w0, w1, w2, w3], -1)
