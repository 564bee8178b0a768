"""Measured BSDFs (counterpart of ``mitsuba2_tpu.models.measured``):
``measured`` (src/bsdfs/measured.cpp, the RGL data-driven model of Dupuy &
Jakob 2018) and ``measured_polarized`` (src/bsdfs/measured_polarized.cpp,
the pBRDFs of Baek et al. 2020), both read from tensor files
(``utils/tensorfile.py``).

``measured`` takes isotropic materials (one phi_i slice, as most of the
RGL database). It samples visible normals through the tables' square <->
sphere warps: each lane's warp blends its two bracketing theta_i slices
linearly (the reference's parameterized Marginal2D, measured.cpp:22-24),
and sampling inverts the blended piecewise-bilinear cdf exactly, so
sample and pdf agree between slices. The spectra are pre-integrated to
rgb at load outside spectral variants (numpy on the host); mono variants
are refused (the JAX package returns three channels there).

The tables live on the scene's device (``textures.on_device``); lookups
are plain indexing and ``torch.searchsorted`` (the JAX package's one-hot
gathers are TPU workarounds). Per-lane prefix sums over a table row are
``distr_1d.cumsum16``, the order of the JAX package's sums on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core.distr_1d import cumsum16
from ..core.object import register_plugin
from ..render.bsdf import BSDF, BSDFFlags, TransportMode
from .bsdfs import _sample
from .textures import on_device


def _theta2u(theta):
    return torch.sqrt(theta * (2.0 / m.Pi))


def _u2theta(u):
    return u * u * (m.Pi / 2.0)


def _phi2u(phi):
    return (phi + m.Pi) * m.InvTwoPi


def _u2phi(u):
    return (2.0 * u - 1.0) * m.Pi


def _elevation(d):
    """The numerically stable elevation of unit vectors (measured.cpp
    elevation)."""
    dist = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + (d[..., 2] - 1.0) ** 2)
    return 2.0 * m.safe_asin(0.5 * dist)


def _pick(table, idx):
    """Each lane's entry ``idx`` (n,) of its row of ``table`` (n, k)."""
    return table.gather(1, idx.long()[:, None])[:, 0]


def _div(a, k):
    """a / k over a tensor of k, so that every device divides (a division
    by a number may run as a product with its reciprocal)."""
    return a / torch.full_like(a, k)


class _SlicedMarginal2D:
    """A theta_i-interpolated marginal/conditional warp over [0, 1]^2 of
    densities ``data`` (T, h, w): a lane's warp is the linear blend of its
    two bracketing theta_i slices ``sl`` = (t0, wt), and sampling inverts
    the blended piecewise-bilinear cdf exactly (a blend of bilinear
    densities is bilinear). The row integrals and the marginal cdf are
    summed on the host in numpy, as the JAX package's."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float32)
        self.T, self.h, self.w = data.shape
        self.data = data
        self.row_int = (0.5 * (data[:, :, 1:] + data[:, :, :-1])).sum(-1) \
            / (self.w - 1)                                   # (T, h)
        slab = 0.5 * (self.row_int[:, 1:] + self.row_int[:, :-1]) \
            / (self.h - 1)
        self.marg_cdf = np.cumsum(slab, -1)                  # (T, h - 1)
        self.integral = slab.sum(-1)                         # (T,)

    def _tab(self, name, dev):
        return on_device(self, name, getattr(self, name), dev)

    def _lerp_t(self, X, sl):
        """Rows t0 and t0 + 1 of ``X`` blended by wt."""
        t0, wt = sl
        a = X[t0.long()]
        b = X[torch.clamp(t0 + 1, max=self.T - 1).long()]
        return a + (b - a) * wt[:, None]

    def _integral(self, sl):
        return self._lerp_t(self._tab("integral", sl[1].device)[:, None],
                            sl)[:, 0]

    def _rows(self, sl, iy):
        """The blended data rows (n, w) of row ``iy``."""
        t0, wt = sl
        flat = self._tab("data", wt.device).reshape(self.T * self.h, self.w)
        a = flat[(t0 * self.h + iy).long()]
        b = flat[(torch.clamp(t0 + 1, max=self.T - 1) * self.h + iy).long()]
        return a + (b - a) * wt[:, None]

    def sample(self, sl, u2):
        """-> (position (n, 2), density there)."""
        h, w = self.h, self.w
        dev = u2.device
        integral = self._integral(sl)
        marg = self._lerp_t(self._tab("marg_cdf", dev), sl)   # (n, h - 1)
        ty = u2[..., 1] * integral
        iy = torch.clamp((marg < ty[:, None]).sum(-1), 0, h - 2)
        cdf_lo = torch.where(iy > 0, _pick(marg, torch.clamp(iy - 1,
                                                             min=0)), 0.0)
        row_int = self._lerp_t(self._tab("row_int", dev), sl)  # (n, h)
        r0, r1 = _pick(row_int, iy), _pick(row_int, iy + 1)
        rem = (ty - cdf_lo) * (h - 1)
        wy = _invert_linear(r0, r1, rem)
        y = _div(iy.to(wy.dtype) + wy, h - 1)
        d0 = self._rows(sl, iy)
        d1 = self._rows(sl, iy + 1)
        row = d0 + (d1 - d0) * wy[:, None]
        ccdf = cumsum16(0.5 * (row[:, 1:] + row[:, :-1]))
        tx = u2[..., 0] * ccdf[:, -1]
        ix = torch.clamp((ccdf < tx[:, None]).sum(-1), 0, w - 2)
        c_lo = torch.where(ix > 0, _pick(ccdf, torch.clamp(ix - 1, min=0)),
                           0.0)
        wx = _invert_linear(_pick(row, ix), _pick(row, ix + 1), tx - c_lo)
        x = _div(ix.to(wx.dtype) + wx, w - 1)
        pos = torch.stack([x, y], -1)
        return pos, self.eval(sl, pos)

    def eval(self, sl, pos):
        """The blended density at ``pos`` (n, 2)."""
        h, w = self.h, self.w
        fx = torch.clamp(pos[..., 0], 0.0, 1.0) * (w - 1)
        fy = torch.clamp(pos[..., 1], 0.0, 1.0) * (h - 1)
        cx = torch.clamp(fx.to(torch.int32), 0, w - 2)
        cy = torch.clamp(fy.to(torch.int32), 0, h - 2)
        tx = fx - cx
        ty = fy - cy
        rows0 = self._rows(sl, cy)
        rows1 = self._rows(sl, cy + 1)
        v00, v10 = _pick(rows0, cx), _pick(rows0, cx + 1)
        v01, v11 = _pick(rows1, cx), _pick(rows1, cx + 1)
        f = (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
             + v01 * (1 - tx) * ty + v11 * tx * ty)
        return m.safe_div(f, self._integral(sl), 0.0)


def _invert_linear(p0, p1, rem):
    """The fraction t in [0, 1] of a cell whose linear density runs from
    p0 to p1 at which its integral reaches ``rem``."""
    dp = p1 - p0
    disc = m.safe_sqrt(p0 * p0 + 2.0 * dp * rem)
    t_lin = m.safe_div(rem, p0, 0.0)
    t_quad = m.safe_div(disc - p0, dp, t_lin)
    return torch.clamp(torch.where(dp.abs() > 1e-9 * (p0 + p1 + 1e-30),
                                   t_quad, t_lin), 0.0, 1.0)


def _tensor_file(filename):
    from ..core.fresolver import file_resolver
    from ..utils.tensorfile import TensorFile
    return TensorFile(file_resolver().resolve(filename))


@register_plugin("bsdf", "measured")
class MeasuredBSDF(BSDF):
    """(measured.cpp) an isotropic RGL measured material from the tensor
    file ``filename``."""

    def __init__(self, props=None, filename=None):
        super().__init__(props)
        from ..variants import current
        if props is not None:
            filename = props.string("filename")
        var = current()
        if var.is_monochromatic:
            raise NotImplementedError(
                "measured: mono variants (the tables hold spectra, which "
                "load as rgb outside spectral variants)")
        tf = _tensor_file(filename)
        theta_i = tf.field("theta_i").astype(np.float32)
        phi_i = tf.field("phi_i").astype(np.float32)
        if phi_i.shape[0] > 2:
            raise NotImplementedError(
                "anisotropic measured materials not yet supported")
        spectra = tf.field("spectra").astype(np.float32)  # (P, T, L, h, w)
        wav = tf.field("wavelengths").astype(np.float32)
        self.jacobian = bool(tf.field("jacobian")[0]) \
            if tf.has_field("jacobian") else True
        self.theta_i = theta_i
        self.n_theta = theta_i.shape[0]
        # isotropic: phi slice 0
        self.vndf = _SlicedMarginal2D(tf.field("vndf").astype(
            np.float32)[0])
        self.lum = _SlicedMarginal2D(tf.field("luminance").astype(
            np.float32)[0])
        self.ndf = tf.field("ndf").astype(np.float32)            # (h, w)
        self.sigma = tf.field("sigma").astype(np.float32)
        self.wavelengths = wav
        spectra0 = spectra[0]                                    # (T, L, h, w)
        self.spectra = self.spectra_rgb = None
        if var.is_spectral:
            self.spectra = spectra0
        else:
            self.spectra_rgb = _spectra_to_rgb(spectra0, wav)
        self.m_components = [BSDFFlags.GlossyReflection | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0]

    def to_string(self):
        return f"MeasuredBSDF[{self.n_theta} incident angles]"

    def _tab(self, name, dev):
        return on_device(self, name, getattr(self, name), dev)

    def _slice(self, theta):
        """Each lane's bracketing theta_i slices (t0, wt): tables blend
        slices t0 and t0 + 1 by wt."""
        ti = self._tab("theta_i", theta.device)
        t0 = torch.clamp((ti[None, :] <= theta[:, None]).to(torch.int32)
                         .sum(-1) - 1, 0, self.n_theta - 2).to(torch.int32)
        lo = ti[t0.long()]
        hi = ti[torch.clamp(t0 + 1, max=self.n_theta - 1).long()]
        wt = torch.clamp(m.safe_div(theta - lo, hi - lo, 0.0), 0.0, 1.0)
        return t0, wt

    def _spectrum_at(self, sl, pos, si):
        """The spectra (or rgb) at the nearest texel of the warp position
        ``pos``, blended between slices; in spectral variants at the
        nearest tabulated wavelength of each hero wavelength."""
        h, w = self.vndf.h, self.vndf.w
        dev = pos.device
        fx = torch.clamp(pos[..., 0], 0.0, 1.0) * (w - 1)
        fy = torch.clamp(pos[..., 1], 0.0, 1.0) * (h - 1)
        ix = torch.clamp(torch.round(fx).to(torch.int32), 0, w - 1).long()
        iy = torch.clamp(torch.round(fy).to(torch.int32), 0, h - 1).long()
        t0, wt = sl
        t0 = t0.long()
        if self.spectra is not None:
            T, L, hh, ww = self.spectra.shape
            t1 = torch.clamp(t0 + 1, max=T - 1)
            flat = self._tab("spectra", dev).reshape(-1)
            wav = self._tab("wavelengths", dev)
            out = []
            for k in range(si.wavelengths.shape[-1]):
                wl = si.wavelengths[..., k]
                li = torch.argmin((wav[None, :] - wl[:, None]).abs(), -1)
                a = flat[((t0 * L + li) * hh + iy) * ww + ix]
                b = flat[((t1 * L + li) * hh + iy) * ww + ix]
                out.append(a + (b - a) * wt)
            return torch.stack(out, -1)
        T, hh, ww = self.spectra_rgb.shape[:3]
        t1 = torch.clamp(t0 + 1, max=T - 1)
        flat = self._tab("spectra_rgb", dev).reshape(-1, 3)
        a = flat[(t0 * hh + iy) * ww + ix]
        b = flat[(t1 * hh + iy) * ww + ix]
        return a + (b - a) * wt[:, None]

    def _eval_grid(self, name, uv):
        """Bilinear lookup of the (h, w) table ``name`` at ``uv``."""
        grid = self._tab(name, uv.device)
        h, w = grid.shape
        fx = torch.clamp(uv[..., 0], 0.0, 1.0) * (w - 1)
        fy = torch.clamp(uv[..., 1], 0.0, 1.0) * (h - 1)
        ix = torch.clamp(fx.to(torch.int32), 0, w - 2)
        iy = torch.clamp(fy.to(torch.int32), 0, h - 2)
        tx = fx - ix
        ty = fy - iy
        flat = grid.reshape(-1)

        def g(yy, xx):
            return flat[(yy * w + xx).long()]
        return (g(iy, ix) * (1 - tx) * (1 - ty)
                + g(iy, ix + 1) * tx * (1 - ty)
                + g(iy + 1, ix) * (1 - tx) * ty
                + g(iy + 1, ix + 1) * tx * ty)

    def _jacobian_factor(self, spec, u_m, u_wi):
        if not self.jacobian:
            return spec
        ndf_v = self._eval_grid("ndf", u_m)
        sigma_v = self._eval_grid("sigma", u_wi)
        return spec * m.safe_div(ndf_v, 4.0 * sigma_v, 0.0)[..., None]

    def sample(self, ctx, si, sample1, sample2, active):
        wi = si.wi
        active = active & (wi[..., 2] > 0) \
            & ctx.is_enabled(BSDFFlags.GlossyReflection)
        theta_i = _elevation(wi)
        phi_i = torch.atan2(wi[..., 1], wi[..., 0])
        sl = self._slice(theta_i)
        u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
        sample = torch.stack([sample2[..., 1], sample2[..., 0]], -1)
        sample, lum_pdf = self.lum.sample(sl, sample)
        u_m, ndf_pdf = self.vndf.sample(sl, sample)
        phi_m = _u2phi(u_m[..., 1]) + phi_i   # isotropic
        theta_m = _u2theta(u_m[..., 0])
        sp, cp = torch.sin(phi_m), torch.cos(phi_m)
        st, ct = torch.sin(theta_m), torch.cos(theta_m)
        mvec = m.vec3(cp * st, sp * st, ct)
        jac = torch.clamp(2.0 * m.sqr(m.Pi) * u_m[..., 0] * st, min=1e-6) \
            * 4.0 * m.dot(wi, mvec)
        wo = mvec * (2.0 * m.dot(wi, mvec))[..., None] - wi
        pdf = m.safe_div(ndf_pdf * lum_pdf, jac, 0.0)
        active = active & (wo[..., 2] > 0) & (pdf > 0)
        spec = self._jacobian_factor(self._spectrum_at(sl, sample, si), u_m,
                                     u_wi)
        value = torch.where(active[..., None],
                            spec * m.safe_div(1.0, pdf, 0.0)[..., None], 0.0)
        return _sample(wo, torch.where(active, pdf, 0.0),
                       torch.ones_like(pdf), int(BSDFFlags.GlossyReflection),
                       0), value

    def _invert(self, si, wo):
        """(wi, wo) -> (slices, micro-normal square position u_m, the
        incident direction's u_wi, the warp's jacobian)."""
        wi = si.wi
        theta_i = _elevation(wi)
        phi_i = torch.atan2(wi[..., 1], wi[..., 0])
        sl = self._slice(theta_i)
        mvec = m.normalize(wi + wo)
        theta_m = _elevation(mvec)
        phi_m = torch.atan2(mvec[..., 1], mvec[..., 0])
        u_m0 = _theta2u(theta_m)
        u_m1 = _phi2u(phi_m - phi_i)
        u_m1 = u_m1 - torch.floor(u_m1)
        u_m = torch.stack([u_m0, u_m1], -1)
        u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
        jac = torch.clamp(2.0 * m.sqr(m.Pi) * u_m0 * torch.sin(theta_m),
                          min=1e-6) * 4.0 * m.dot(wi, mvec)
        return sl, u_m, u_wi, jac

    def _active(self, ctx, si, wo, active):
        return active & (si.wi[..., 2] > 0) & (wo[..., 2] > 0) \
            & ctx.is_enabled(BSDFFlags.GlossyReflection)

    def eval(self, ctx, si, wo, active):
        active = self._active(ctx, si, wo, active)
        sl, u_m, u_wi, jac = self._invert(si, wo)
        # the spectra are tabulated over the warp's sample square: the
        # forward cdf of the vndf warp maps u_m back to it
        spec = self._spectrum_at(sl, self._vndf_forward_cdf(sl, u_m), si)
        spec = self._jacobian_factor(spec, u_m, u_wi)
        return torch.where(active[..., None], spec, 0.0)

    def _vndf_forward_cdf(self, sl, u_m):
        """The forward cdf of the vndf warp (micro-normal square -> sample
        square): the blended marginal and conditional cdfs, piecewise
        linear densities integrated in closed form."""
        vndf = self.vndf
        h, w = vndf.h, vndf.w
        dev = u_m.device
        integral = vndf._integral(sl)
        marg = vndf._lerp_t(vndf._tab("marg_cdf", dev), sl)      # (n, h - 1)
        fy = torch.clamp(u_m[..., 1], 0.0, 1.0) * (h - 1)
        iy = torch.clamp(fy.to(torch.int32), 0, h - 2)
        wy = fy - iy
        row_int = vndf._lerp_t(vndf._tab("row_int", dev), sl)
        r0, r1 = _pick(row_int, iy), _pick(row_int, iy + 1)
        cdf_lo = torch.where(iy > 0, _pick(marg, torch.clamp(iy - 1, min=0)),
                             0.0)
        part = _div(r0 * wy + 0.5 * (r1 - r0) * wy * wy, h - 1)
        sy = m.safe_div(cdf_lo + part, integral, 0.0)
        d0 = vndf._rows(sl, iy)
        d1 = vndf._rows(sl, iy + 1)
        row = d0 + (d1 - d0) * wy[:, None]
        ccdf = cumsum16(0.5 * (row[:, 1:] + row[:, :-1]))
        fx = torch.clamp(u_m[..., 0], 0.0, 1.0) * (w - 1)
        ix = torch.clamp(fx.to(torch.int32), 0, w - 2)
        wx = fx - ix
        c_lo = torch.where(ix > 0, _pick(ccdf, torch.clamp(ix - 1, min=0)),
                           0.0)
        p0, p1 = _pick(row, ix), _pick(row, ix + 1)
        part = p0 * wx + 0.5 * (p1 - p0) * wx * wx
        sx = m.safe_div(c_lo + part, ccdf[:, -1], 0.0)
        return torch.stack([sx, sy], -1)

    def pdf(self, ctx, si, wo, active):
        active = self._active(ctx, si, wo, active)
        sl, u_m, u_wi, jac = self._invert(si, wo)
        ndf_pdf = self.vndf.eval(sl, u_m)
        lum_pdf = self.lum.eval(sl, self._vndf_forward_cdf(sl, u_m))
        pdf = m.safe_div(ndf_pdf * lum_pdf, jac, 0.0)
        return torch.where(active, pdf, 0.0)


def _spectra_to_rgb(spectra0, wav):
    """(T, L, h, w) spectra at ``wav`` -> (T, h, w, 3) linear rgb, each
    texel's curve integrated against the CIE matching functions under D65
    (normalized to unit luminance), clamped at 0 (measured.py:190-206)."""
    from ..core import spectrum as spec_mod
    T, L, hh, ww = spectra0.shape
    wl = torch.as_tensor(wav)
    cmf = spec_mod.cie1931_xyz(wl).numpy()                       # (L, 3)
    d65 = spec_mod.cie_d65(wl).numpy()
    wgt = cmf * d65[:, None]
    wgt = wgt / max(wgt[:, 1].sum(), 1e-9)
    rgb = np.zeros((T, hh, ww, 3), np.float32)
    for t in range(T):
        xyz = spectra0[t].reshape(L, hh * ww).T @ wgt             # (hw, 3)
        rgb[t] = spec_mod.xyz_to_srgb(torch.as_tensor(xyz)).numpy() \
            .reshape(hh, ww, 3)
    return np.maximum(rgb, 0.0)


# =============================================================================
# The polarized measured pBRDF (measured_polarized.cpp:100-396)
# =============================================================================

def _rot_z(v, angle):
    """``v`` turned by ``angle`` about +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([c * x - s * y, s * x + c * y, z], -1)


def _axis(like, k):
    out = torch.zeros_like(like)
    out[..., k] = 1.0
    return out


def _rusinkiewicz(i, o):
    """(phi_d, theta_h, theta_d) of the isotropic Rusinkiewicz
    parameterization of unit vectors ``i``, ``o`` above the surface
    (measured_polarized.cpp directions_to_rusinkiewicz)."""
    h = m.normalize(i + o)
    bxn = m.cross(_axis(h, 2), h)
    deg = m.squared_norm(bxn) < 1e-12            # h ~ +z: phi_d undefined
    b = m.normalize(torch.where(deg[..., None], _axis(h, 1), bxn))
    t = m.normalize(m.cross(b, h))
    td = m.safe_acos(torch.clamp(m.dot(h, i), -1.0, 1.0))
    th = m.safe_acos(torch.clamp(h[..., 2], -1.0, 1.0))
    i_prj = m.normalize(i - m.dot(i, h)[..., None] * h)
    pd = torch.atan2(torch.clamp(m.dot(b, i_prj), -1.0, 1.0),
                     torch.clamp(m.dot(t, i_prj), -1.0, 1.0))
    return pd, th, td


_COS_LOBE_WEIGHT = 0.1   # COSINE_HEMISPHERE_PDF_WEIGHT


@register_plugin("bsdf", "measured_polarized")
class MeasuredPolarizedBSDF(BSDF):
    """(measured_polarized.cpp) a pBRDF of the KAIST dataset: 4x4 Mueller
    matrices tabulated over the Rusinkiewicz angles (phi_d, theta_d,
    theta_h) and wavelength bands, interpolated multilinearly over the
    four axes (a NaN corner voids the lane, M00 clamped at 0), then
    rotated from the measurement's reflection-plane Stokes frames into the
    transport bases. Outside spectral variants the bands are read at
    ``wavelength`` (required there). Sampling is the fixed mixture 0.1
    cosine + 0.9 GGX(``alpha_sample``)."""

    def __init__(self, props=None, filename=None):
        super().__init__(props)
        from ..variants import current
        wavelength, alpha = -1.0, 0.1
        if props is not None:
            filename = props.string("filename")
            alpha = props.float_("alpha_sample", 0.1)
            wavelength = props.float_("wavelength", -1.0)
        if not current().is_spectral and wavelength < 0:
            raise RuntimeError(
                "measured_polarized: non-spectral variants require the "
                "`wavelength` parameter (measured_polarized.cpp:110)")
        self.alpha_sample = float(alpha)
        self.wavelength = float(wavelength)
        tf = _tensor_file(filename)
        self.grid_p = tf.field("phi_d").astype(np.float32).reshape(-1)
        self.grid_d = tf.field("theta_d").astype(np.float32).reshape(-1)
        self.grid_h = tf.field("theta_h").astype(np.float32).reshape(-1)
        self.grid_w = tf.field("wvls").astype(np.float32).reshape(-1)
        M = tf.field("M").astype(np.float32)
        shape = tuple(len(g) for g in (self.grid_p, self.grid_d, self.grid_h,
                                       self.grid_w))
        if M.shape != shape + (4, 4):
            raise RuntimeError(
                f"measured_polarized: invalid file structure {M.shape}")
        # NaNs mark invalid configurations: zeroed in the table, their
        # weight in the interpolation voids the lane
        self.nan_mask = np.isnan(M[..., 0, 0]).astype(np.float32)
        self.table = np.nan_to_num(M).reshape(shape + (16,))
        self.m_components = [BSDFFlags.GlossyReflection | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0]

    def _tab(self, name, dev):
        return on_device(self, name, getattr(self, name), dev)

    def _locate(self, name, x):
        """The cell (i, weight) of ``x`` on the grid ``name``."""
        grid = self._tab(name, x.device)
        k = grid.shape[0]
        i = torch.clamp(torch.searchsorted(grid, x.contiguous(), right=True)
                        - 1, 0, k - 2)
        g0, g1 = grid[i], grid[i + 1]
        w = torch.clamp((x - g0) / torch.clamp(g1 - g0, min=1e-9), 0.0, 1.0)
        return i, w

    def _interp(self, pd, td, th, wav):
        """pd, td, th (n,) and wavelengths (n, C) -> Mueller matrices (n,
        C, 4, 4), zero where a NaN corner carries weight."""
        n, C = wav.shape
        ip, wp = self._locate("grid_p", pd)
        id_, wd = self._locate("grid_d", td)
        ih, wh = self._locate("grid_h", th)
        iw, ww = self._locate("grid_w", wav.reshape(-1))
        # each lane's cell over its C channels (jnp.repeat)
        ip, wp, id_, wd, ih, wh = (a[:, None].expand(-1, C).reshape(-1)
                                   for a in (ip, wp, id_, wd, ih, wh))
        _, D, H, W = self.table.shape[:4]
        flat = self._tab("table", pd.device).reshape(-1, 16)
        nan_flat = self._tab("nan_mask", pd.device).reshape(-1)
        out = bad = 0.0
        for ap in (0, 1):
            for ad in (0, 1):
                for ah in (0, 1):
                    for aw in (0, 1):
                        idx = (((ip + ap) * D + (id_ + ad)) * H
                               + (ih + ah)) * W + (iw + aw)
                        w = ((wp if ap else 1 - wp) * (wd if ad else 1 - wd)
                             * (wh if ah else 1 - wh)
                             * (ww if aw else 1 - ww))
                        out = out + w[:, None] * flat[idx]
                        bad = bad + w * nan_flat[idx]
        valid = bad.reshape(n, C) < 1e-6
        return torch.where(valid[..., None, None], out.reshape(n, C, 4, 4),
                           0.0)

    def _mueller(self, ctx, si, wo, active):
        """The interpolated matrices, rotated into the transport bases
        and times cos theta_o -> (n, C, 4, 4)."""
        from ..render import mueller as mu
        from ..variants import current
        cos_o = wo[..., 2]
        act = active & (si.wi[..., 2] > 0) & (cos_o > 0)
        # light arrives along -wo_hat and leaves along +wi_hat
        radiance = ctx.mode == TransportMode.Radiance
        wo_hat = wo if radiance else si.wi
        wi_hat = si.wi if radiance else wo
        phi_std = torch.atan2(wi_hat[..., 1], wi_hat[..., 0])
        wo_std = _rot_z(wo_hat, -phi_std)
        wi_std = _rot_z(wi_hat, -phi_std)
        pd, th, td = _rusinkiewicz(wo_std, wi_std)
        pd = torch.where(pd < 0, pd + 2 * m.Pi, pd)
        var = current()
        wav = si.wavelengths if var.is_spectral else torch.full(
            si.t.shape + (var.n_channels,), self.wavelength,
            device=si.t.device)
        M = self._interp(pd, td, th, wav)
        M[..., 0, 0] = torch.clamp(M[..., 0, 0], min=0.0)
        # the measurement's Stokes frames lie in the reflection plane
        zo = -wo_std
        to = m.normalize(m.cross(wo_std - wi_std, zo))
        yo = m.normalize(m.cross(to, zo))
        xo = m.cross(yo, zo)
        zi = wi_std
        ti = m.normalize(m.cross(wi_std - wo_std, zi))
        yi = m.normalize(m.cross(ti, zi))
        xi = m.cross(yi, zi)
        R_in = mu.rotate_stokes_basis(-wo_hat, mu.stokes_basis(-wo_hat),
                                      _rot_z(xo, phi_std))
        R_out = mu.rotate_stokes_basis(wi_hat, _rot_z(xi, phi_std),
                                       mu.stokes_basis(wi_hat))
        M = R_out[:, None] @ M @ R_in[:, None]
        return M * (cos_o * act)[..., None, None, None]

    def eval_pol(self, ctx, si, wo, active):
        return self._mueller(ctx, si, wo, active)

    def eval(self, ctx, si, wo, active):
        return self._mueller(ctx, si, wo, active)[..., 0, 0]

    def _distr(self, like):
        from ..render.microfacet import MicrofacetDistribution
        a = torch.full((), self.alpha_sample, dtype=like.dtype,
                       device=like.device)
        return MicrofacetDistribution(a, a, "ggx", True)

    def pdf(self, ctx, si, wo, active):
        from ..core import warp
        act = active & (si.wi[..., 2] > 0) & (wo[..., 2] > 0)
        h = m.normalize(si.wi + wo)
        pdf_d = warp.square_to_cosine_hemisphere_pdf(wo)
        pdf_m = m.safe_div(self._distr(si.t).pdf(si.wi, h),
                           4.0 * m.dot(wo, h).abs(), 0.0)
        pdf = (_COS_LOBE_WEIGHT * pdf_d
               + (1.0 - _COS_LOBE_WEIGHT) * pdf_m)
        return torch.where(act, pdf, 0.0)

    def sample(self, ctx, si, sample1, sample2, active):
        bs, M = self.sample_pol(ctx, si, sample1, sample2, active)
        return bs, M[..., 0, 0]

    def sample_pol(self, ctx, si, sample1, sample2, active):
        from ..core import warp
        from ..render.fresnel import reflect
        act = active & (si.wi[..., 2] > 0)
        wo_diff = warp.square_to_cosine_hemisphere(sample2)
        mh, _ = self._distr(si.t).sample(si.wi, sample2[..., 0],
                                         sample2[..., 1])
        wo_spec = reflect(si.wi, mh)
        use_diff = sample1 < _COS_LOBE_WEIGHT
        wo = torch.where(use_diff[..., None], wo_diff, wo_spec)
        pdf = self.pdf(ctx, si, wo, act)
        M = self._mueller(ctx, si, wo, act)
        ok = act & (pdf > 0)
        weight = torch.where(
            ok[..., None, None, None],
            M / torch.clamp(pdf, min=1e-12)[..., None, None, None], 0.0)
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     torch.where(ok, int(self.m_flags), 0),
                     torch.where(ok, 0, -1))
        return bs, weight
