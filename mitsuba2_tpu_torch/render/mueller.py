"""Mueller/Stokes polarization calculus (reference: include/mitsuba/
render/mueller.h:35-278; counterpart of ``mitsuba2_tpu.render.mueller``):
depolarizer, absorber, linear polarizer and retarder, the circular
polarizers, diattenuator, rotator, rotated elements, polarized specular
reflection (Fresnel with a complex IOR) and transmission, and the Stokes
reference bases and their rotations.

Mueller matrices are (..., 4, 4) tensors; a spectrum of them carries its
C channels before the matrix axes, (..., C, 4, 4), and ``to_world_mueller``
broadcasts its rotators over that axis. Stokes vectors are (..., 4).
Stokes bases are defined looking toward the propagation direction, the
basis x axis the horizontal linear polarization, as the reference's.
"""

from __future__ import annotations

import torch

from ..core import math as m


def _t(x, like=None):
    """``x`` as a floating tensor (a number filled on ``like``'s device:
    no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() or x.is_complex() else x.float()
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def _mm(rows):
    """A (..., 4, 4) matrix of 16 broadcastable tensors, row by row."""
    flat = [e for r in rows for e in r]
    flat = torch.broadcast_tensors(*flat)
    return torch.stack(flat, -1).reshape(flat[0].shape + (4, 4))


def depolarizer(value=1.0):
    """The matrix that strips polarization and scales the intensity."""
    v = _t(value)
    out = torch.zeros(v.shape + (4, 4), dtype=v.dtype, device=v.device)
    out[..., 0, 0] = v
    return out


def absorber(value):
    """A neutral absorber: every component scaled."""
    v = _t(value)
    return torch.eye(4, dtype=v.dtype, device=v.device) * v[..., None, None]


def linear_polarizer(value=1.0):
    """The ideal linear polarizer at 0 degrees, transmittance ``value``."""
    a = 0.5 * _t(value)
    z = torch.zeros_like(a)
    return _mm([[a, a, z, z],
                [a, a, z, z],
                [z, z, z, z],
                [z, z, z, z]])


def linear_retarder(phase):
    """A linear retarder, fast axis horizontal; ``phase`` in radians (pi:
    a half-wave plate)."""
    phase = _t(phase)
    s = torch.sin(phase)
    c = torch.cos(phase)
    o = torch.ones_like(c)
    z = torch.zeros_like(c)
    return _mm([[o, z, z, z],
                [z, o, z, z],
                [z, z, c, -s],
                [z, z, s, c]])


def right_circular_polarizer():
    return 0.5 * torch.tensor([[1, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0],
                               [1, 0, 0, 1]], dtype=torch.float32)


def left_circular_polarizer():
    return 0.5 * torch.tensor([[1, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0],
                               [-1, 0, 0, 1]], dtype=torch.float32)


def diattenuator(x, y):
    """A linear diattenuator: transmittance ``x`` horizontally, ``y``
    vertically."""
    x = _t(x)
    y = _t(y, x).to(x.dtype)
    a = 0.5 * (x + y)
    b = 0.5 * (x - y)
    c = torch.sqrt(x * y)
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z],
                [b, a, z, z],
                [z, z, c, z],
                [z, z, z, c]])


def rotator(theta):
    """The rotation of a Stokes basis by ``theta``, counter-clockwise
    looking toward the beam."""
    theta = _t(theta)
    s = torch.sin(2.0 * theta)
    c = torch.cos(2.0 * theta)
    o = torch.ones_like(c)
    z = torch.zeros_like(c)
    return _mm([[o, z, z, z],
                [z, c, s, z],
                [z, -s, c, z],
                [z, z, z, o]])


def rotated_element(theta, M):
    """The optical element ``M`` rotated by ``theta``."""
    return rotator(theta) @ M @ rotator(-_t(theta))


# ---------------------------------------------------------------------------
# Polarized Fresnel (mueller.h specular_reflection / specular_transmission)
# ---------------------------------------------------------------------------

def _fresnel_amplitudes(cos_theta_i, eta_re, eta_im=None):
    """The complex s and p amplitude reflection coefficients (r_s, r_p) of
    an interface of relative IOR ``eta_re`` + i ``eta_im``, in
    complex64."""
    ci = _t(cos_theta_i).abs()
    si2 = 1.0 - ci * ci
    eta_re = _t(eta_re, ci).to(ci.dtype)
    eta_im = torch.zeros_like(eta_re) if eta_im is None \
        else _t(eta_im, ci).to(ci.dtype)
    eta = torch.complex(*torch.broadcast_tensors(eta_re, eta_im)) \
        .to(torch.complex64)
    ct2 = torch.sqrt((1.0 - si2 / (eta * eta)).to(torch.complex64))
    r_s = (ci - eta * ct2) / (ci + eta * ct2)
    r_p = (eta * ci - ct2) / (eta * ci + ct2)
    return r_s, r_p


def specular_reflection(cos_theta_i, eta_re, eta_im=None):
    """The Mueller matrix of polarized specular reflection in the s/p
    basis, at incidence cosine ``cos_theta_i`` on an interface of relative
    IOR ``eta_re`` + i ``eta_im`` (complex for conductors)."""
    r_s, r_p = _fresnel_amplitudes(cos_theta_i, eta_re, eta_im)
    rs2 = r_s.abs() ** 2
    rp2 = r_p.abs() ** 2
    a = 0.5 * (rs2 + rp2)
    b = 0.5 * (rs2 - rp2)
    cross = r_s * torch.conj(r_p)
    c = cross.real
    s = cross.imag
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z],
                [b, a, z, z],
                [z, z, c, s],
                [z, z, -s, c]]).to(torch.float32)


def specular_transmission(cos_theta_i, eta):
    """The Mueller matrix of polarized specular transmission through a
    dielectric interface of relative IOR ``eta``."""
    ci = _t(cos_theta_i).abs()
    eta = _t(eta, ci).to(ci.dtype)
    st2 = (1.0 - ci * ci) / (eta * eta)
    ct = m.safe_sqrt(1.0 - st2)
    t_s = 2.0 * ci / (ci + eta * ct)
    t_p = 2.0 * ci / (eta * ci + ct)
    # the power normalization
    factor = eta * m.safe_div(ct, ci, 0.0)
    ts2 = factor * t_s * t_s
    tp2 = factor * t_p * t_p
    a = 0.5 * (ts2 + tp2)
    b = 0.5 * (ts2 - tp2)
    c = factor * t_s * t_p
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z],
                [b, a, z, z],
                [z, z, c, z],
                [z, z, z, c]])


# ---------------------------------------------------------------------------
# Stokes reference bases (mueller.h stokes_basis / rotate_*)
# ---------------------------------------------------------------------------

def stokes_basis(w):
    """The canonical horizontal axis of the Stokes basis perpendicular to
    the propagation direction ``w``."""
    s, _ = m.coordinate_system(w)
    return s


def unit_angle(a, b):
    """The angle between unit vectors, as 2 asin(|b - a| / 2) (math.h
    unit_angle: no acos cancellation near 0 and pi)."""
    return 2.0 * torch.asin(torch.clamp(0.5 * m.norm(b - a), 0.0, 1.0))


def rotate_stokes_basis(w, basis_current, basis_target):
    """The rotator that carries the Stokes basis ``basis_current`` onto
    ``basis_target`` about the direction ``w``."""
    theta = unit_angle(m.normalize(basis_current), m.normalize(basis_target))
    s = m.sign(m.dot(w, m.cross(basis_current, basis_target)))
    return rotator(theta * s)


def rotate_mueller_basis(M, in_w, in_basis_current, in_basis_target,
                         out_w, out_basis_current, out_basis_target):
    """``M``, defined for the current in and out bases, expressed in the
    target ones."""
    R_in = rotate_stokes_basis(in_w, in_basis_target, in_basis_current)
    R_out = rotate_stokes_basis(out_w, out_basis_current, out_basis_target)
    return R_out @ M @ R_in


def rotate_mueller_basis_collinear(M, w, basis_current, basis_target):
    R = rotate_stokes_basis(w, basis_target, basis_current)
    return rotate_stokes_basis(w, basis_current, basis_target) @ M @ R


def mueller_to_world(M, si, wo_local, wi_local):
    """A Mueller matrix of the BSDF's local s/p frame in the world-aligned
    Stokes bases (the role of the reference's to_world_mueller around a
    BSDF value, path.cpp:165, :179)."""
    wi_world = si.to_world(wi_local)
    wo_world = si.to_world(wo_local)
    return rotate_mueller_basis(
        M,
        -wi_world, stokes_basis(-wi_world), stokes_basis(-wi_world),
        wo_world, stokes_basis(wo_world), stokes_basis(wo_world))


def to_world_mueller(si, M, in_forward_local, out_forward_local):
    """A Mueller matrix given in the implicit local Stokes bases,
    re-expressed in the canonical bases of the world directions
    (interaction.h to_world_mueller). ``in_forward_local``: the arriving
    light's propagation direction in the local frame (usually -wo);
    ``out_forward_local``: the leaving light's (usually wi). ``M`` is
    (..., 4, 4) or (..., C, 4, 4)."""
    in_w = m.normalize(si.to_world(in_forward_local))
    out_w = m.normalize(si.to_world(out_forward_local))
    in_cur = m.normalize(si.to_world(stokes_basis(in_forward_local)))
    in_tgt = stokes_basis(in_w)
    out_cur = m.normalize(si.to_world(stokes_basis(out_forward_local)))
    out_tgt = stokes_basis(out_w)
    R_in = rotate_stokes_basis(in_w, in_tgt, in_cur)
    R_out = rotate_stokes_basis(out_w, out_cur, out_tgt)
    if M.ndim > R_in.ndim:  # (..., C, 4, 4): the rotators over channels
        R_in = R_in[..., None, :, :]
        R_out = R_out[..., None, :, :]
    return R_out @ M @ R_in
