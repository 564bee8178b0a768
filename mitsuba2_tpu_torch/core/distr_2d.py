"""2D sampling warps (reference: include/mitsuba/core/distr_2d.h;
counterpart of ``mitsuba2_tpu.core.distr_2d``): ``Hierarchical2D``, the
envmap's importance sampler (envmap.cpp:67), and ``Marginal2D``.

As in the JAX package, ``Hierarchical2D`` keeps the reference's contract
(sample and evaluate a bilinear density over [0, 1]^2) on a flat
row-marginal / column-conditional cdf instead of a mip descent: the same
distribution. A lane's conditional row is searched in place, a binary
search over the row's cdf (``_lower_bound_rows``), so no lane copies a row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m
from .distr_1d import cumsum16
from .warp import square_to_bilinear


def _lower_bound_rows(table, row, target):
    """Per lane, the number of entries of the non-decreasing row
    ``table[row]`` that are < ``target``: (h, w) table, (n,) rows and
    targets -> (n,) int64, by binary search (searchsorted, side left)."""
    w = table.shape[1]
    flat = table.reshape(-1)
    base = row * w
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    for _ in range(max(1, w.bit_length())):
        mid = (lo + hi) // 2
        open_ = lo < hi
        below = flat[base + mid.clamp(max=w - 1)] < target
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return lo


class DiscreteDistribution2D(NamedTuple):
    """Discrete distribution over texels (distr_2d.h:819)."""

    pmf: torch.Tensor        # (h, w)
    cond_cdf: torch.Tensor   # (h, w) row-wise cumsum
    marg_cdf: torch.Tensor   # (h,) cumsum of the row sums
    sum: torch.Tensor

    @staticmethod
    def create(pmf) -> "DiscreteDistribution2D":
        cond = cumsum16(pmf)
        marg = cumsum16(cond[..., -1])
        return DiscreteDistribution2D(pmf, cond, marg, marg[-1])

    def sample(self, u2):
        """(n, 2) uniforms -> ((n, 2) integer texel (x, y), pmf, the
        uniforms rescaled for reuse)."""
        h, w = self.pmf.shape
        uy = u2[..., 1] * self.sum
        y = torch.searchsorted(self.marg_cdf, uy.contiguous(),
                               right=True).clamp(0, h - 1)
        row_lo = torch.where(y > 0, self.marg_cdf[(y - 1).clamp(min=0)], 0.0)
        row_sum = self.cond_cdf[y, -1]
        uy2 = m.safe_div(uy - row_lo, row_sum, 0.0)
        ux = u2[..., 0] * row_sum
        x = _lower_bound_rows(self.cond_cdf, y, ux).clamp(0, w - 1)
        col_lo = torch.where(x > 0, self.cond_cdf[y, (x - 1).clamp(min=0)],
                             0.0)
        pmf_xy = self.pmf[y, x]
        ux2 = m.safe_div(ux - col_lo, pmf_xy, 0.0)
        pmf_norm = m.safe_div(pmf_xy, self.sum, 0.0)
        u_reuse = torch.stack([torch.clamp(ux2, 0.0, 1.0 - m.Epsilon),
                               torch.clamp(uy2, 0.0, 1.0 - m.Epsilon)], -1)
        return torch.stack([x, y], -1), pmf_norm, u_reuse

    def eval(self, pos):
        """The normalized pmf at integer texels (..., 2) (x, y)."""
        return m.safe_div(self.pmf[pos[..., 1], pos[..., 0]], self.sum, 0.0)

    def pdf(self, pos):
        return self.eval(pos)


def _bilinear(data, pos):
    """Bilinear interpolation of vertex values ``data`` (h, w) at
    positions (..., 2) in [0, 1]^2 (clamped)."""
    h, w = data.shape
    fx = torch.clamp(pos[..., 0], 0.0, 1.0) * (w - 1)
    fy = torch.clamp(pos[..., 1], 0.0, 1.0) * (h - 1)
    cx = fx.to(torch.int32).clamp(0, w - 2).long()
    cy = fy.to(torch.int32).clamp(0, h - 2).long()
    tx = fx - cx.to(fx.dtype)
    ty = fy - cy.to(fy.dtype)
    v00 = data[cy, cx]
    v10 = data[cy, cx + 1]
    v01 = data[cy + 1, cx]
    v11 = data[cy + 1, cx + 1]
    return (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
            + v01 * (1 - tx) * ty + v11 * tx * ty)


class Hierarchical2D(NamedTuple):
    """Continuous bilinear 2D warp over [0, 1]^2 (the contract of
    distr_2d.h:199): ``data`` holds density values at the vertices of an
    (h - 1) x (w - 1) cell grid; ``sample`` picks a cell by its bilinear
    integral and warps inside it with ``square_to_bilinear``."""

    data: torch.Tensor              # (h, w) vertex densities, unnormalized
    cell: DiscreteDistribution2D    # over the (h - 1, w - 1) cells
    normalization: torch.Tensor     # 1 / mean density

    @staticmethod
    def create(data) -> "Hierarchical2D":
        data = torch.as_tensor(data, dtype=torch.float32)
        cell_int = 0.25 * (data[:-1, :-1] + data[:-1, 1:] + data[1:, :-1]
                           + data[1:, 1:])
        cells = DiscreteDistribution2D.create(cell_int)
        h, w = data.shape
        mean = cells.sum / ((h - 1) * (w - 1))
        return Hierarchical2D(data, cells, m.safe_div(torch.ones_like(mean),
                                                      mean, 0.0))

    def to(self, device) -> "Hierarchical2D":
        return Hierarchical2D(
            self.data.to(device),
            DiscreteDistribution2D(*(x.to(device) for x in self.cell)),
            self.normalization.to(device))

    @property
    def res(self):
        return tuple(self.data.shape)

    def sample(self, u2):
        """(n, 2) -> (positions in [0, 1]^2, pdf)."""
        h, w = self.data.shape
        xy, _, u_r = self.cell.sample(u2)
        cx, cy = xy[..., 0], xy[..., 1]
        p_local, _ = square_to_bilinear(
            self.data[cy, cx], self.data[cy, cx + 1], self.data[cy + 1, cx],
            self.data[cy + 1, cx + 1], u_r)
        pos = torch.stack([(cx.to(p_local.dtype) + p_local[..., 0]) / (w - 1),
                           (cy.to(p_local.dtype) + p_local[..., 1]) / (h - 1)],
                          -1)
        return pos, self.eval(pos)

    def eval(self, pos):
        """Normalized density over [0, 1]^2 at positions (..., 2)."""
        return _bilinear(self.data, pos) * self.normalization

    pdf = eval


class Marginal2D(NamedTuple):
    """Row-marginal / column-conditional continuous warp (distr_2d.h:336,
    MarginalContinuous2D0): a piecewise-bilinear density over an (h, w)
    vertex grid, sampled by exact inversion of the marginal and then the
    conditional, both piecewise-quadratic cdfs."""

    data: torch.Tensor       # (h, w)
    marg_cdf: torch.Tensor   # (h - 1,) cumulative row-slab integrals
    cond_cdf: torch.Tensor   # (h, w - 1) per-row cumulative cell integrals
    integral: torch.Tensor

    @staticmethod
    def create(data) -> "Marginal2D":
        data = torch.as_tensor(data, dtype=torch.float32)
        h, w = data.shape
        row_int = (0.5 * (data[:, 1:] + data[:, :-1])).sum(-1) / (w - 1)
        slab = 0.5 * (row_int[1:] + row_int[:-1]) / (h - 1)
        marg_cdf = cumsum16(slab)
        cond_cdf = cumsum16(0.5 * (data[:, 1:] + data[:, :-1]))
        return Marginal2D(data, marg_cdf, cond_cdf, marg_cdf[-1])

    def sample(self, u2):
        h, w = self.data.shape
        ty = u2[..., 1] * self.integral
        iy = torch.searchsorted(self.marg_cdf, ty.contiguous(),
                                right=True).clamp(0, h - 2)
        cdf_lo = torch.where(iy > 0, self.marg_cdf[(iy - 1).clamp(min=0)],
                             0.0)
        row_int = (0.5 * (self.data[:, 1:] + self.data[:, :-1])).sum(-1) \
            / (w - 1)
        wy = _invert_linear_cdf(row_int[iy], row_int[iy + 1],
                                (ty - cdf_lo) * (h - 1))
        y = (iy.to(wy.dtype) + wy) / (h - 1)
        # the conditional over x at the interpolated row
        d0 = self.data[iy]
        row = d0 + (self.data[iy + 1] - d0) * wy[..., None]
        ccdf = cumsum16(0.5 * (row[..., 1:] + row[..., :-1]))
        tx = u2[..., 0] * ccdf[..., -1]
        ix = (ccdf < tx[..., None]).sum(-1).clamp(0, w - 2)
        c_lo = torch.where(ix > 0, torch.gather(
            ccdf, -1, (ix - 1).clamp(min=0)[..., None])[..., 0], 0.0)
        p0 = torch.gather(row, -1, ix[..., None])[..., 0]
        p1 = torch.gather(row, -1, (ix + 1)[..., None])[..., 0]
        wx = _invert_linear_cdf(p0, p1, tx - c_lo)
        x = (ix.to(wx.dtype) + wx) / (w - 1)
        pos = torch.stack([x, y], -1)
        return pos, self.eval(pos)

    def eval(self, pos):
        return m.safe_div(_bilinear(self.data, pos), self.integral, 0.0)

    pdf = eval


def _invert_linear_cdf(p0, p1, rem):
    """Solve p0 t + (p1 - p0) t^2 / 2 = rem for t in [0, 1]."""
    dp = p1 - p0
    disc = m.safe_sqrt(p0 * p0 + 2.0 * dp * rem)
    t_lin = m.safe_div(rem, p0, 0.0)
    t_quad = m.safe_div(disc - p0, dp, t_lin)
    return torch.clamp(torch.where(dp.abs() > 1e-9 * (p0 + p1 + 1e-30),
                                   t_quad, t_lin), 0.0, 1.0)
