"""Test adapters (parity: the reference's chi2.py BSDFAdapter and
PhaseFunctionAdapter, and ``mitsuba2_tpu.render.testutil``): a surface
record for BSDF queries outside a scene, and (sample, pdf) function pairs
of a BSDF or phase function plugin for the chi^2 harness
(python/chi2.py)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..core import math as m
from ..core.frame import Frame
from ..render.bsdf import BSDFContext
from ..render.interaction import SurfaceInteraction


def dummy_si(n, wi=(0, 0, 1), dtype=torch.float32, n_wav=0, device="cpu"):
    """n surface records at the origin in the standard frame, incident
    direction ``wi`` (normalized) in it, uv (0.5, 0.5), hero wavelengths
    of 550 nm where ``n_wav`` asks for them."""
    wi = m.normalize(torch.as_tensor(wi, dtype=dtype, device=device))
    z = torch.zeros((n, 3), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    frame = Frame(*(eye[i].expand(n, 3) for i in range(3)))
    ids = torch.zeros((n,), dtype=torch.int32, device=device)
    return SurfaceInteraction(
        t=torch.ones((n,), dtype=dtype, device=device), p=z, n=frame.n,
        sh_frame=frame,
        uv=torch.full((n, 2), 0.5, dtype=dtype, device=device),
        wi=wi.expand(n, 3), dp_du=frame.s, dp_dv=frame.t, shape_idx=ids,
        prim_idx=ids,
        wavelengths=torch.full((n, n_wav), 550.0, dtype=dtype,
                               device=device) if n_wav else None,
        bsdf_idx=ids, emitter_idx=ids - 1,
        prim_uv=torch.zeros((n, 2), dtype=dtype, device=device))


def make_bsdf_adapter(bsdf_type, extra: dict | None = None, wi=(0, 0, 1),
                      ctx=None):
    """-> (sample_func(u (n, 2 or 3)) -> (wo, weight), pdf_func(wo)) of
    the BSDF plugin ``{"type": bsdf_type, **extra}`` at incident direction
    ``wi``; a sample whose value is zero has weight 0, so that it drops
    out of the histogram (the reference's chi2.py BSDFAdapter)."""
    from ..core.dictio import load_dict
    bsdf = load_dict({"type": bsdf_type, **(extra or {})})
    ctx = ctx or BSDFContext()

    def sample_func(u):
        n = u.shape[0]
        si = dummy_si(n, wi, u.dtype, device=u.device)
        u1 = u[..., 2] if u.shape[-1] > 2 else torch.zeros_like(u[..., 0])
        active = torch.ones((n,), dtype=torch.bool, device=u.device)
        bs, value = bsdf.sample(ctx, si, u1, u[..., :2], active)
        weight = torch.where((value == 0).all(-1), 0.0, 1.0)
        return bs.wo, weight

    def pdf_func(wo):
        n = wo.shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=wo.device)
        return bsdf.pdf(ctx, dummy_si(n, wi, wo.dtype, device=wo.device), wo,
                        active)

    return sample_func, pdf_func


def make_phase_adapter(phase_type, extra: dict | None = None, wi=(0, 0, 1)):
    """-> (sample_func(u (n, 2)) -> wo, pdf_func(wo)) of the phase
    function plugin ``{"type": phase_type, **extra}`` at ``wi``."""
    from ..core.dictio import load_dict
    phase = load_dict({"type": phase_type, **(extra or {})})

    def record(n, like):
        w = m.normalize(torch.as_tensor(wi, dtype=like.dtype,
                                        device=like.device))
        return SimpleNamespace(wi=w.expand(n, 3))

    def sample_func(u):
        wo, _ = phase.sample(record(u.shape[0], u), u[..., :2])
        return wo

    def pdf_func(wo):
        return phase.eval(record(wo.shape[0], wo), wo)

    return sample_func, pdf_func
