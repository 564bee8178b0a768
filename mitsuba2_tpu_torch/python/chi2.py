"""Chi^2 goodness-of-fit test harness (parity: the reference's
src/python/python/chi2.py and ``mitsuba2_tpu.python.chi2``): histogram a
sampling routine over a domain, integrate the claimed pdf over the same
bins, and run Pearson's chi^2 test with low-count cells pooled. The
samples come from the port's counter-based streams (core/rng.py), so a
test draws the JAX harness's points at the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core import rng as _rng


class ChiSquareTest:
    """
    Parameters mirror the reference (chi2.py:6-60):

    domain        : object with ``bounds()`` -> ((xmin, xmax), (ymin,
                    ymax)), ``aspect()``, ``map_forward(p2)`` and
                    ``map_backward(p)`` (SphericalDomain, PlanarDomain and
                    LineDomain below)
    sample_func   : (sample: (N, sample_dim) float32 tensor) -> points
                    (N, 2|3), or (points, weights)
    pdf_func      : (points) -> density w.r.t. the domain measure
    sample_dim    : dimensionality of the random source (2 default)
    sample_count  : number of samples
    res           : vertical histogram resolution
    ires          : per-cell integration subdivisions
    """

    def __init__(self, domain, sample_func, pdf_func, sample_dim=2,
                 sample_count=1000000, res=101, ires=8, seed=0):
        self.domain = domain
        self.sample_func = sample_func
        self.pdf_func = pdf_func
        self.sample_dim = sample_dim
        self.sample_count = int(sample_count)
        if res % 2 == 1:
            res += 1
        self.res = res
        self.ires = max(int(ires), 2)
        self.seed = seed
        self.histogram = None
        self.pdf = None
        self.p_value = None
        self.messages = ""
        self.fail = False

    # -- sampling -------------------------------------------------------------
    def tabulate_histogram(self):
        idx = torch.arange(self.sample_count, dtype=torch.int64)
        key = _rng.lane_key(self.seed, idx)
        sample = torch.stack([_rng.uniform_float(key, d)
                              for d in range(self.sample_dim)], -1)
        out = self.sample_func(sample)
        # sample_func may return (positions, weights) — weighted histograms,
        # used to drop invalid samples (reference chi2.py:100-126)
        if isinstance(out, tuple):
            ps, weights = out
            weights = weights.double().numpy()
        else:
            ps = out
            weights = None
        xy = self.domain.map_backward(ps).double().numpy()
        (xmin, xmax), (ymin, ymax) = self.domain.bounds()
        nx = self.res * self.domain.aspect()
        ny = self.res
        h, _, _ = np.histogram2d(
            xy[:, 1], xy[:, 0], bins=[ny, int(nx)],
            range=[[ymin, ymax], [xmin, xmax]], weights=weights)
        self.histogram = h
        hist_sum = h.sum()
        if hist_sum > self.sample_count * 1.1:
            self.fail = True
            self._log(f"histogram sum {hist_sum} exceeds sample count")
        return h

    # -- integration ----------------------------------------------------------
    def tabulate_pdf(self):
        (xmin, xmax), (ymin, ymax) = self.domain.bounds()
        nx = int(self.res * self.domain.aspect())
        ny = self.res
        k = self.ires
        # midpoint-rule subsamples inside each cell
        ex = (np.arange(nx * k) + 0.5) / (nx * k) * (xmax - xmin) + xmin
        ey = (np.arange(ny * k) + 0.5) / (ny * k) * (ymax - ymin) + ymin
        gx, gy = np.meshgrid(ex, ey)
        pts2 = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], axis=-1),
                               dtype=torch.float32)
        p = self.domain.map_forward(pts2)
        pdf = self.pdf_func(p).double().numpy().reshape(ny * k, nx * k)
        cell_area = ((xmax - xmin) / (nx * k)) * ((ymax - ymin) / (ny * k))
        pdf = pdf * cell_area
        pdf = pdf.reshape(ny, k, nx, k).sum(axis=(1, 3))
        self.pdf = pdf * self.sample_count
        return self.pdf

    # -- the test -------------------------------------------------------------
    def run(self, significance_level=0.01, test_count=1):
        """Returns True if the test passes. ``test_count`` Šidák-corrects for
        running many tests in a suite (chi2.py run())."""
        if self.histogram is None:
            self.tabulate_histogram()
        if self.pdf is None:
            self.tabulate_pdf()
        import scipy.stats as st

        obs = self.histogram.ravel()
        exp = self.pdf.ravel()
        # pool cells with expected count < 5 (standard chi2 validity rule,
        # reference pools in the same way)
        order = np.argsort(exp)
        obs, exp = obs[order], exp[order]
        pooled_obs = []
        pooled_exp = []
        acc_o = acc_e = 0.0
        for o, e in zip(obs, exp):
            acc_o += o
            acc_e += e
            if acc_e >= 5.0:
                pooled_obs.append(acc_o)
                pooled_exp.append(acc_e)
                acc_o = acc_e = 0.0
        if acc_e > 0:
            if pooled_exp:
                pooled_obs[-1] += acc_o
                pooled_exp[-1] += acc_e
            else:
                pooled_obs.append(acc_o)
                pooled_exp.append(acc_e)
        pooled_obs = np.asarray(pooled_obs)
        pooled_exp = np.asarray(pooled_exp)
        # rescale tiny integration drift
        total_mismatch = abs(pooled_exp.sum() - pooled_obs.sum())
        if total_mismatch > 0.01 * self.sample_count:
            self._log(f"expected({pooled_exp.sum():.1f}) and observed "
                      f"({pooled_obs.sum():.1f}) totals differ by "
                      f"{100*total_mismatch/self.sample_count:.2f}%")
        pooled_exp *= pooled_obs.sum() / pooled_exp.sum()
        dof = len(pooled_obs) - 1
        if dof <= 0:
            self._log("not enough degrees of freedom")
            self.fail = True
            return not self.fail
        chi2 = ((pooled_obs - pooled_exp) ** 2 / pooled_exp).sum()
        self.p_value = st.chi2.sf(chi2, dof)
        # Šidák correction
        alpha = 1.0 - (1.0 - significance_level) ** (1.0 / test_count)
        if self.p_value < alpha or not np.isfinite(self.p_value):
            self.fail = True
            self._log(f"rejected: p={self.p_value:.4g} < alpha={alpha:.4g} "
                      f"(chi2={chi2:.2f}, dof={dof})")
        else:
            self._log(f"accepted: p={self.p_value:.4g} (chi2={chi2:.2f}, "
                      f"dof={dof})")
        return not self.fail

    def _log(self, s):
        self.messages += s + "\n"


class PlanarDomain:
    """2D euclidean domain (chi2.py PlanarDomain)."""

    def __init__(self, bounds=None):
        self._bounds = bounds if bounds is not None else \
            ((-1.0, 1.0), (-1.0, 1.0))

    def bounds(self):
        return self._bounds

    def aspect(self):
        (xmin, xmax), (ymin, ymax) = self._bounds
        return max(1, round((xmax - xmin) / (ymax - ymin)))

    def map_forward(self, p2):
        return p2

    def map_backward(self, p):
        return p[..., :2]


class SphericalDomain:
    """Directions on S^2 parameterized by (phi, cos(theta)) — equal-area,
    so the spherical pdf is used directly (chi2.py SphericalDomain)."""

    def bounds(self):
        return ((-m.Pi, m.Pi), (-1.0, 1.0))

    def aspect(self):
        return 2

    def map_forward(self, p2):
        phi, cos_theta = p2[..., 0], p2[..., 1]
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
        return torch.stack([sin_theta * torch.cos(phi),
                            sin_theta * torch.sin(phi), cos_theta], -1)

    def map_backward(self, p):
        return torch.stack([torch.atan2(p[..., 1], p[..., 0]),
                            torch.clamp(p[..., 2], -1.0, 1.0)], -1)


class LineDomain:
    """1D domain embedded as x-axis (chi2.py LineDomain)."""

    def __init__(self, bounds=(-1.0, 1.0)):
        self._bounds = bounds

    def bounds(self):
        return (self._bounds, (-0.5, 0.5))

    def aspect(self):
        return 1

    def map_forward(self, p2):
        return p2[..., 0]

    def map_backward(self, p):
        p = torch.atleast_1d(p)
        if p.ndim == 1 or p.shape[-1] != 2:
            return torch.stack([p, torch.zeros_like(p)], -1)
        return p


def BSDFAdapter(bsdf_type, extra, wi=(0, 0, 1), ctx=None):
    """(sample_func, pdf_func) of a BSDF plugin under test (parity:
    chi2.py BSDFAdapter; render/testutil.py)."""
    from ..render.testutil import make_bsdf_adapter
    return make_bsdf_adapter(bsdf_type, extra, wi=wi, ctx=ctx)


def PhaseFunctionAdapter(phase_type, extra, wi=(0, 0, 1)):
    """(sample_func, pdf_func) of a phase function plugin under test
    (parity: chi2.py PhaseFunctionAdapter; render/testutil.py)."""
    from ..render.testutil import make_phase_adapter
    return make_phase_adapter(phase_type, extra, wi=wi)
