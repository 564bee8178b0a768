"""1D sampling distributions (reference: include/mitsuba/core/
distr_1d.h; counterpart of ``mitsuba2_tpu.core.distr_1d``): discrete,
piecewise linear over uniform nodes, and over explicit nodes. Sampling is
a binary search over the inclusive cdf (``searchsorted``, side right), as
the reference's.

Cumulative sums are float32 and taken in a fixed order, ``cumsum16``'s:
the order in which the JAX package's tables are summed on the CPU (XLA
scans blocks of 16, then the blocks' totals the same way). A sample that
lands near a cell boundary, and the rescaled sample of ``sample_reuse``
(a difference of two cdf values), depend on that order, so the same order
keeps the port's samples the JAX wavefront's on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


def cumsum16(x):
    """Inclusive float32 prefix sums along the last axis: sequential sums
    within blocks of 16, the blocks' totals summed by the same rule, and
    each block offset by the totals before it."""
    n = x.shape[-1]
    if n <= 16:
        out, acc = [], torch.zeros_like(x[..., 0])
        for j in range(n):
            acc = acc + x[..., j]
            out.append(acc)
        return torch.stack(out, -1)
    nb = -(-n // 16)
    pad = torch.zeros(x.shape[:-1] + (nb * 16 - n,), dtype=x.dtype,
                      device=x.device)
    blocks = cumsum16(torch.cat([x, pad], -1).reshape(
        x.shape[:-1] + (nb, 16)))
    before = cumsum16(blocks[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]),
                        before[..., :-1]], -1)
    out = (blocks + before[..., None]).reshape(x.shape[:-1] + (nb * 16,))
    return out[..., :n]


class DiscreteDistribution(NamedTuple):
    """Distribution over {0..n-1} from unnormalized weights."""

    pmf: torch.Tensor            # (n,) unnormalized
    cdf: torch.Tensor            # (n,) inclusive cumulative sum
    sum: torch.Tensor            # () total
    normalization: torch.Tensor  # () 1 / sum

    @staticmethod
    def create(pmf) -> "DiscreteDistribution":
        pmf = torch.as_tensor(pmf, dtype=torch.float32)
        cdf = cumsum16(pmf)
        total = cdf[-1]
        return DiscreteDistribution(pmf, cdf, total,
                                    m.safe_div(torch.ones_like(total),
                                               total, 0.0))

    def to(self, device) -> "DiscreteDistribution":
        return DiscreteDistribution(*(x.to(device) for x in self))

    @property
    def size(self) -> int:
        return self.pmf.shape[-1]

    def eval_pmf(self, index):
        return self.pmf[index]

    def eval_pmf_normalized(self, index):
        return self.pmf[index] * self.normalization

    def eval_cdf_normalized(self, index):
        return self.cdf[index] * self.normalization

    def sample(self, u):
        """u in [0, 1) -> index (int64)."""
        idx = torch.searchsorted(self.cdf, (u * self.sum).contiguous(),
                                 right=True)
        return idx.clamp(0, self.size - 1)

    def sample_reuse(self, u):
        """An index and u rescaled into [0, 1) for reuse (distr_1d.h
        sample_reuse)."""
        idx = self.sample(u)
        cdf_lo = torch.where(idx > 0, self.cdf[(idx - 1).clamp(min=0)], 0.0)
        u2 = m.safe_div(u * self.sum - cdf_lo, self.eval_pmf(idx), 0.0)
        return idx, torch.clamp(u2, 0.0, 1.0 - m.Epsilon)

    def sample_pmf(self, u):
        idx = self.sample(u)
        return idx, self.eval_pmf_normalized(idx)

    def sample_reuse_pmf(self, u):
        idx, u2 = self.sample_reuse(u)
        return idx, u2, self.eval_pmf_normalized(idx)


def _invert_cell(p0, p1, rem):
    """The position t in [0, 1] within a cell of linear density p0 -> p1
    where its integral reaches ``rem`` (in units of the cell's width):
    the quadratic's root, the linear one where the cell is flat."""
    dp = p1 - p0
    disc = m.safe_sqrt(p0 * p0 + 2.0 * dp * rem)
    t_lin = m.safe_div(rem, p0, 0.0)
    t_quad = m.safe_div(disc - p0, dp, t_lin)
    return torch.clamp(torch.where(dp.abs() > 1e-9 * (p0 + p1 + 1e-30),
                                   t_quad, t_lin), 0.0, 1.0)


class ContinuousDistribution(NamedTuple):
    """A piecewise-linear density on [a, b] over n uniform nodes
    (distr_1d.h ContinuousDistribution)."""

    pdf: torch.Tensor            # (n,) unnormalized density at the nodes
    cdf: torch.Tensor            # (n - 1,) inclusive sums of the cells
    range: torch.Tensor          # (2,)
    integral: torch.Tensor       # ()
    normalization: torch.Tensor  # () 1 / integral
    interval_size: torch.Tensor  # () the nodes' spacing

    @staticmethod
    def create(range_, pdf) -> "ContinuousDistribution":
        pdf = torch.as_tensor(pdf, dtype=torch.float32)
        range_ = torch.as_tensor(range_, dtype=torch.float32,
                                 device=pdf.device)
        h = (range_[1] - range_[0]) / (pdf.shape[-1] - 1)
        cdf = cumsum16(0.5 * (pdf[1:] + pdf[:-1]) * h)
        integral = cdf[-1]
        return ContinuousDistribution(
            pdf, cdf, range_, integral,
            m.safe_div(torch.ones_like(integral), integral, 0.0), h)

    def to(self, device) -> "ContinuousDistribution":
        return ContinuousDistribution(*(x.to(device) for x in self))

    @property
    def size(self) -> int:
        return self.pdf.shape[-1]

    def _cell(self, x):
        t = (x - self.range[0]) / self.interval_size
        i0 = t.to(torch.int32).clamp(0, self.size - 2).long()
        return i0, t - i0.to(t.dtype)

    def eval_pdf(self, x):
        i0, w = self._cell(x)
        v = m.lerp(self.pdf[i0], self.pdf[i0 + 1], w)
        return torch.where((x >= self.range[0]) & (x <= self.range[1]), v,
                           0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) * self.normalization

    def eval_cdf(self, x):
        i0, w = self._cell(x)
        cdf_lo = torch.where(i0 > 0, self.cdf[(i0 - 1).clamp(min=0)], 0.0)
        p0, p1 = self.pdf[i0], self.pdf[i0 + 1]
        return cdf_lo + (p0 * w + 0.5 * (p1 - p0) * w * w) \
            * self.interval_size

    def sample(self, u):
        """u in [0, 1) -> a position in the range."""
        target = u * self.integral
        idx = torch.searchsorted(self.cdf, target.contiguous(),
                                 right=True).clamp(0, self.size - 2)
        cdf_lo = torch.where(idx > 0, self.cdf[(idx - 1).clamp(min=0)], 0.0)
        t = _invert_cell(self.pdf[idx], self.pdf[idx + 1],
                         (target - cdf_lo) / self.interval_size)
        return self.range[0] + (idx.to(t.dtype) + t) * self.interval_size

    def sample_pdf(self, u):
        x = self.sample(u)
        return x, self.eval_pdf_normalized(x)


class IrregularContinuousDistribution(NamedTuple):
    """Piecewise-linear density over explicit nodes (distr_1d.h
    IrregularContinuousDistribution; counterpart of
    ``mitsuba2_tpu.core.distr_1d.IrregularContinuousDistribution``): the
    curve spectra sample their wavelengths from it."""

    nodes: torch.Tensor          # (n,)
    pdf: torch.Tensor            # (n,) unnormalized density at the nodes
    cdf: torch.Tensor            # (n - 1,) inclusive sums of the cells
    integral: torch.Tensor       # ()
    normalization: torch.Tensor  # () 1 / integral

    @staticmethod
    def create(nodes, pdf) -> "IrregularContinuousDistribution":
        nodes = torch.as_tensor(nodes, dtype=torch.float32)
        pdf = torch.as_tensor(pdf, dtype=torch.float32)
        cell = 0.5 * (pdf[1:] + pdf[:-1]) * (nodes[1:] - nodes[:-1])
        cdf = cumsum16(cell)
        integral = cdf[-1]
        return IrregularContinuousDistribution(
            nodes, pdf, cdf, integral,
            m.safe_div(torch.ones_like(integral), integral, 0.0))

    def to(self, device) -> "IrregularContinuousDistribution":
        return IrregularContinuousDistribution(*(x.to(device) for x in self))

    @property
    def size(self) -> int:
        return self.pdf.shape[-1]

    def eval_pdf(self, x):
        idx = (torch.searchsorted(self.nodes, x.contiguous(), right=True)
               - 1).clamp(0, self.size - 2)
        x0, x1 = self.nodes[idx], self.nodes[idx + 1]
        v = m.lerp(self.pdf[idx], self.pdf[idx + 1],
                   m.safe_div(x - x0, x1 - x0, 0.0))
        return torch.where((x >= self.nodes[0]) & (x <= self.nodes[-1]), v,
                           0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) * self.normalization

    def sample(self, u):
        """u in [0, 1) -> a position, inverting the cell's linear density
        (the quadratic's root, the linear one where the cell is flat)."""
        target = u * self.integral
        idx = torch.searchsorted(self.cdf, target.contiguous(),
                                 right=True).clamp(0, self.size - 2)
        cdf_lo = torch.where(idx > 0, self.cdf[(idx - 1).clamp(min=0)], 0.0)
        x0, x1 = self.nodes[idx], self.nodes[idx + 1]
        h = x1 - x0
        t = _invert_cell(self.pdf[idx], self.pdf[idx + 1],
                         m.safe_div(target - cdf_lo, h, 0.0))
        return x0 + t * h

    def sample_pdf(self, u):
        x = self.sample(u)
        return x, self.eval_pdf_normalized(x)
