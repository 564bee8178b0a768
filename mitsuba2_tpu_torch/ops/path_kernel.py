"""Path tracing: host side, plain PyTorch version and the CUDA kernel's
wrapper.

Counterpart of ``mitsuba2_tpu/ops/megakernel.py`` for its K1a scope
(triangle meshes of at most ``MAX_FACES`` faces, constant-albedo diffuse
BSDFs, constant area lights, rgb, box filter) and the matpreview scopes:
analytic spheres (K1b), one lat-long envmap with its importance-sampled
NEE arm (K1c), isotropic GGX rough conductors and checkerboard albedo
(K1d), in the rgb, spectral and mono color modes (K1e). One lane is
one camera path, lanes are pixel-major
(``lane = pixel * spp_pass + s``), and the estimator is ``_path_kernel``'s
(path.cpp:92-234): emission with power-2 MIS against area NEE, the
environment on escape with MIS against env NEE, two-armed NEE (env with
probability ``p_env``, else a light face through the light-table cdf)
with a shadow any-hit, cosine sampling of the diffuse lobe or visible-
normal sampling of the GGX lobe, Russian roulette after ``rr_depth``,
and an emission-only last bounce. Random numbers are the reference
kernel's TEA streams: lane key ``_tea(seed, _tea(pixel, sample, 4), 4)``,
film jitter at dim 0, and dims ``2 + 8 * depth + k`` per bounce (k = 0
roulette, 1-2 NEE, 4 BSDF sample, 5 env NEE jitter), so a port render
agrees with the reference per pixel at equal seed.

Color modes (``PathTables.nc``): 3 rgb channels; 4 hero wavelengths in
spectral mode, drawn once per path from the lane key at sampler dim 1,
with reflectances, emission and env radiance evaluated from sigmoid
coefficients (render/srgb.py) and the D65 table, conductor IOR from
clamped quadratics, and the radiance developed at the end of every path
against the CIE CMFs into linear sRGB (megakernel.py:287-324, 436-463,
1378-1393); 1 luminance channel in mono mode. The output is (3, n)
linear sRGB in every mode.

``path_radiance`` runs the hand-written kernel (csrc/path_kernel.cu) for
tables on a CUDA device and ``path_radiance_reference`` -- the same
function in plain PyTorch -- for tables on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec
from ..core.rng import sample_tea_32, u32_to_float01
from ..render.fresnel import fresnel_conductor

# The reference's unrolled face-sweep tier holds at most
# UNROLLED_CHUNKS * FACE_CHUNK faces (megakernel.py:82-85); larger meshes
# wait for the per-ray BVH traversal.
MAX_FACES = 1024
MAX_SPHERES = 64         # megakernel.py MAX_SPHERES
MAX_ENV_W = 256          # megakernel.py MAX_ENV_W
_BIG = 3.0e38
_PI = 3.141592653589793
# lanes x (faces, cdf entries) per chunk of the plain version's sweeps
_CHUNK_ELEMS = 1 << 24

# Per-face (and per-sphere) attribute columns, FA floats a row: ten float4
# the kernel reads as [ng, lpdf_w] [albedo, kind] [Le, alpha]
# [eta, le_scale] [k, x_lo] [color1, x_hi] [uv0, duv1] [duv2, 0, 0]
# [to_uv row 0, 0] [to_uv row 1, 0]. albedo is the diffuse reflectance,
# the checker's color0 or the conductor's specular reflectance; to_uv rows
# are [m00 m01 m03] and [m10 m11 m13] of the checker's affine uv
# transform. Colors hold the color mode's payload: rgb, the sigmoid
# coefficients (spectral) or the luminance repeated (mono). Spectral only:
# le_scale is the emitter's D65 scale, eta and k hold the IOR quadratics'
# (a, b, c) and [x_lo, x_hi] their clamp span in normalized wavelength.
FA = 40
C_NG, C_LPDF, C_ALB, C_KIND, C_LE, C_ALPHA = 0, 3, 4, 7, 8, 11
C_ETA, C_K, C_C1, C_UV0, C_DUV1, C_DUV2 = 12, 16, 20, 24, 26, 28
C_TOUV0, C_TOUV1 = 32, 36
C_LESCALE, C_XLO, C_XHI = C_ETA + 3, C_K + 3, C_C1 + 3
KIND_DIFFUSE, KIND_GGX, KIND_CHECKER = 0, 1, 2

# color channels per color mode: rgb, hero wavelengths, luminance
MODE_NC = {"rgb": 3, "spectral": 4, "mono": 1}
NC_MODE = {nc: mode for mode, nc in MODE_NC.items()}
# rows of the D65 / CMF table: 95 CIE samples, padded
SPD_ROWS = 96
_WL_MIN, _WL_MAX = 360.0, 830.0

# Scene-content flags: the kernel is instantiated per combination of the
# first four (the reference kernel's static has_spheres / has_env /
# has_ggx / has_checker gates); HAS_ENV_ROT is a run-time branch.
HAS_SPHERES, HAS_ENV, HAS_GGX, HAS_CHECKER, HAS_ENV_ROT = 1, 2, 4, 8, 16
TEMPLATE_FLAGS = HAS_SPHERES | HAS_ENV | HAS_GGX | HAS_CHECKER


def flag_names(flags) -> str:
    """'cornell' for no scene-content flag, else e.g. 'spheres+env+ggx'."""
    names = [n for f, n in ((HAS_SPHERES, "spheres"), (HAS_ENV, "env"),
                            (HAS_GGX, "ggx"), (HAS_CHECKER, "checker"))
             if flags & f]
    return "+".join(names) or "cornell"


def kernel_name(flags, nc) -> str:
    """Name of one instantiation, e.g. 'path_kernel[cornell, spectral]'."""
    return f"path_kernel[{flag_names(flags)}, {NC_MODE[nc]}]"


def spd_table() -> np.ndarray:
    """(96, 4) float32: D65 / 100 in column 0 and the CIE 1931 x, y, z
    responses in columns 1-3 at 360..830 nm in 5 nm steps, padded by
    repeating the last row (megakernel.py:2667-2682)."""
    out = np.zeros((SPD_ROWS, 4), np.float32)
    out[:95, 0] = spec.CIE_D65_TABLE
    out[:95, 1:4] = spec.CIE_XYZ_TABLE
    out[95:] = out[94]
    return out


class PathTables(NamedTuple):
    """The scene's flat table set, all float32 on one device.

    woop     (F, 12): per face [Wu | Wv | Wz], each 4 floats, mapping a
             homogeneous world point to the unit triangle:
             u = p . Wu[:3] + Wu[3] (ops/intersect_pallas.py:55 build_woop).
    fattr    (F, FA): per-face attribute columns (C_* above).
    lights   (L, 24): the megakernel's light rows (render/scene.py
             _light_table), with the cdf-2.0 padding rows.
    sph      (S, 4): sphere [center, radius]; sattr (S, FA) their
             attribute rows (normal columns unused, identity uv).
    env      (H, W, 4): lat-long radiance texels, row v: [r, g, b, 0],
             [luminance, 0, 0, 0] (mono) or [c0, c1, c2, scale]
             (spectral, render/scene.py env_texels).
    env_marg (Hs,), env_cond (Hs, Ws), env_pmf (Hs, Ws): the env NEE
             grid's marginal cdf over rows, per-row conditional cdf and
             joint pmf.
    env_rot  (18,): the env's rigid to_world 3x3 row-major, then its
             transpose.
    spd      (96, 4) in spectral mode (``spd_table``), else (0, 4).
    flags    HAS_* bits; p_env the probability of the env NEE arm; nc the
             color channels (``MODE_NC``).
    """
    woop: torch.Tensor
    fattr: torch.Tensor
    lights: torch.Tensor
    sph: torch.Tensor
    sattr: torch.Tensor
    env: torch.Tensor
    env_marg: torch.Tensor
    env_cond: torch.Tensor
    env_pmf: torch.Tensor
    env_rot: torch.Tensor
    spd: torch.Tensor
    flags: int = 0
    p_env: float = 0.0
    nc: int = 3

    @property
    def n_faces(self) -> int:
        return self.woop.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph.shape[0]

    @property
    def device(self) -> torch.device:
        return self.woop.device

    def tensors(self) -> tuple:
        return tuple(v for v in self if isinstance(v, torch.Tensor))

    def to(self, device) -> "PathTables":
        return self._replace(**{k: v.to(device) for k, v in
                                self._asdict().items()
                                if isinstance(v, torch.Tensor)})


def build_woop(v0, e1, e2) -> np.ndarray:
    """Per-triangle world -> unit-triangle affine rows, (F, 12) float32.

    Row f is [Wu | Wv | Wz] with u = [p, 1] . Wu etc., built in float64 and
    rounded once (intersect_pallas.py:55). Degenerate triangles get the
    never-hit row Z = 1, DZ = 0."""
    f = len(v0)
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1).astype(np.float64)   # (F,3,3)
    ok = np.abs(np.linalg.det(A)) > 1e-18 if f else np.zeros(0, bool)
    A_safe = np.where(ok[:, None, None], A, np.eye(3))
    M = np.linalg.inv(A_safe)                                # (F,3,3)
    trans = -np.einsum("fij,fj->fi", M, v0.astype(np.float64))
    # W[f, :, k] is the homogeneous row of local axis k (u, v, w)
    W = np.concatenate([np.swapaxes(M, 1, 2), trans[:, None, :]], axis=1)
    W = np.where(ok[:, None, None], W, 0.0)
    W[~ok, 3, 2] = 1.0
    return np.ascontiguousarray(
        np.swapaxes(W, 1, 2).reshape(f, 12).astype(np.float32))


def _make_tables(woop, fattr, lights, sph, sattr, env, env_rot, p_env,
                 device, nc) -> PathTables:
    """numpy tables -> PathTables on ``device``; flags from the content.
    ``env`` is None or (texels (H, W, 4), marginal cdf, conditional cdf,
    pmf); ``env_rot`` None or the rigid 3x3 to_world."""
    flags = 0
    sph = np.zeros((0, 4), np.float32) if sph is None else sph
    sattr = np.zeros((0, FA), np.float32) if sattr is None else sattr
    if len(sph):
        flags |= HAS_SPHERES
    kinds = np.concatenate([fattr[:, C_KIND], sattr[:, C_KIND]])
    if (kinds == KIND_GGX).any():
        flags |= HAS_GGX
    if (kinds == KIND_CHECKER).any():
        flags |= HAS_CHECKER
    if env is None:
        texels = np.zeros((0, 0, 4), np.float32)
        marg = np.zeros(0, np.float32)
        cond = pmf = np.zeros((0, 0), np.float32)
        p_env = 0.0
    else:
        flags |= HAS_ENV
        texels, marg, cond, pmf = env
    rot = np.eye(3, dtype=np.float32) if env_rot is None \
        else np.asarray(env_rot, np.float32).reshape(3, 3)
    if env is not None and not np.allclose(rot, np.eye(3), atol=1e-6):
        flags |= HAS_ENV_ROT
    spd = spd_table() if nc == MODE_NC["spectral"] \
        else np.zeros((0, 4), np.float32)

    def dev(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return PathTables(dev(woop), dev(fattr), dev(lights), dev(sph),
                      dev(sattr), dev(texels), dev(marg), dev(cond),
                      dev(pmf),
                      dev(np.concatenate([rot.reshape(-1),
                                          rot.T.reshape(-1)])),
                      dev(spd), flags, float(p_env), nc)


def pack_tables(v0, e1, e2, fattr, lights, device, sph=None, sattr=None,
                env=None, env_rot=None, p_env=0.0, nc=3) -> PathTables:
    """Host per-face arrays -> the device table set (see ``_make_tables``
    for ``env`` and ``env_rot``)."""
    return _make_tables(build_woop(v0, e1, e2), fattr, lights, sph, sattr,
                        env, env_rot, p_env, device, nc)


def _attr_from_reference(A):
    """The reference's transposed attribute rows (fa, N) (megakernel.py
    _FA_COLS layout) -> (N, FA) in this module's column layout. Rows the
    reference left out of its packed ``fa`` rows are zero."""
    A = np.asarray(A, np.float32)
    fa, N = A.shape

    def rows(i, j):
        out = np.zeros((N, j - i), np.float32)
        k = max(0, min(j, fa) - i)
        out[:, :k] = A[i:i + k].T
        return out

    out = np.zeros((N, FA), np.float32)
    for dst, (i, j) in ((C_NG, (0, 3)), (C_LPDF, (9, 10)), (C_ALB, (3, 6)),
                        (C_KIND, (10, 11)), (C_LE, (6, 9)),
                        (C_ALPHA, (11, 12)), (C_ETA, (12, 15)),
                        (C_K, (15, 18)), (C_C1, (18, 21)),
                        (C_UV0, (21, 23)), (C_DUV1, (23, 25)),
                        (C_DUV2, (25, 27)), (C_TOUV0, (27, 30)),
                        (C_TOUV1, (30, 33)), (C_LESCALE, (43, 44)),
                        (C_XLO, (44, 45)), (C_XHI, (45, 46))):
        out[:, dst:dst + j - i] = rows(i, j)
    return out


def tables_from_reference(woop, fattr, lights, cam, device=None, sph=None,
                          sattr=None, env=None, envs=None, env_size=None,
                          p_env=0.0, env_rot=None, nc=3):
    """The reference kernel's own tables -> (PathTables, camera row).

    Takes numpy arrays in ``DiffusePathMegakernel``'s layouts: ``woop``
    (n_chunks * 3C, 4) of the unrolled tier (per chunk, C rows each of
    Wu, Wv, Wz), ``fattr`` (fa, F) from ``_fattr()``, ``lights`` (24, L)
    and the (1, 16) camera row; for spheres ``sph`` (8, S) and ``sattr``
    (fa, S) from ``_sattr()``; for an envmap ``env`` (3Wp, Hp), ``envs``
    (2Wsp + 8, Hsp), ``env_size`` = (env_w, env_h, env_ws, env_hs),
    ``p_env`` and ``env_rot`` (its 9-tuple or None); ``nc`` the color mode's
    channel count (the spectral env has a fourth, scale, plane). The
    never-hit padding faces come along unchanged; padding spheres and
    texels are dropped."""
    woop = np.asarray(woop, np.float32)
    F = np.asarray(fattr).shape[1]
    if woop.shape != (3 * F, 4):
        raise ValueError(f"woop {woop.shape} is not the unrolled (3F, 4) "
                         f"layout for F={F}")
    C = F if F <= 128 else 128     # megakernel FACE_CHUNK tiers
    blk = woop.reshape(F // C, 3, C, 4)          # chunk, axis, face, col
    rows = np.transpose(blk, (0, 2, 1, 3)).reshape(F, 12)
    sph_rows = sattr_rows = None
    if sph is not None:
        sph = np.asarray(sph, np.float32)
        alive = sph[4] > 0.5
        sph_rows = sph[0:4, alive].T
        sattr_rows = _attr_from_reference(np.asarray(sattr)[:, alive])
    env_t = None
    if env is not None:
        w, h, ws, hs = env_size
        env = np.asarray(env, np.float32)
        planes = 4 if nc == MODE_NC["spectral"] else 3
        wp = env.shape[0] // planes
        texels = np.zeros((h, w, 4), np.float32)
        for c in range(planes):
            texels[..., c] = env[c * wp:c * wp + w, :h].T
        envs = np.asarray(envs, np.float32)
        wsp = (envs.shape[0] - 8) // 2
        env_t = (texels, envs[2 * wsp, :hs], envs[:ws, :hs].T,
                 envs[wsp:wsp + ws, :hs].T)
    dev = torch.device("cpu") if device is None else torch.device(device)
    tables = _make_tables(rows, _attr_from_reference(fattr),
                          np.asarray(lights, np.float32).T, sph_rows,
                          sattr_rows, env_t, env_rot, p_env, dev, nc)
    cam = torch.as_tensor(np.asarray(cam, np.float32).reshape(16),
                          device=dev)
    return tables, cam


def camera_row(sensor, device) -> torch.Tensor:
    """(16,) float32: the to_world 3x3 basis row-major, the origin,
    tan(x_fov / 2) and padding (megakernel.py render_pass:2832-2838)."""
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    tan_half = np.float32(np.tan(np.deg2rad(sensor.x_fov) * 0.5))
    row = np.concatenate([mat[:3, :3].reshape(-1), mat[:3, 3], [tan_half],
                          np.zeros(3, np.float32)]).astype(np.float32)
    return torch.as_tensor(row, device=device)


# ----------------------------------------------------------------------------
# plain versions of the kernel's device helpers (csrc/rng.cuh,
# csrc/path_kernel.cu; megakernel.py:194-284)
# ----------------------------------------------------------------------------

def _tea(v0, v1, rounds=5):
    return sample_tea_32(v0, v1, rounds)


def _u01(bits):
    return u32_to_float01(bits)


def _rng2(key, dim):
    v0, v1 = _tea(key, torch.full_like(key, dim))
    return _u01(v0), _u01(v1)


def _concentric(u1, u2):
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    zero = (x == 0.0) & (y == 0.0)
    q13 = x.abs() < y.abs()
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    phi = 0.25 * _PI * rp / torch.where(r == 0.0, torch.ones_like(r), r)
    phi = torch.where(q13, 0.5 * _PI - phi, phi)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def _mis(a, b):
    a2 = a * a
    b2 = b * b
    return torch.where(a2 > 0, a2 / torch.clamp(a2 + b2, min=1e-30),
                       torch.zeros_like(a2))


def _ggx_d(hz, a):
    a2 = a * a
    d = hz * hz * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(_PI * d * d, min=1e-20)


def _ggx_g1(cz, a):
    """Smith G1 of isotropic GGX from the cosine alone."""
    cz = torch.clamp(cz, min=1e-6)
    a2 = a * a
    t2 = (1.0 - cz * cz) / (cz * cz)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * t2))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _frame(n):
    """Duff et al.'s branchless orthonormal basis (t1, t2) around unit
    vectors n (3 tensors)."""
    one = torch.ones_like(n[2])
    s = torch.where(n[2] >= 0.0, one, -one)
    oa = -1.0 / (s + n[2])
    ob = n[0] * n[1] * oa
    return ([1.0 + s * n[0] * n[0] * oa, s * ob, -s * n[0]],
            [ob, s + n[1] * n[1] * oa, -n[1]])


def _normalized(v, floor=1e-20):
    inv = torch.rsqrt(torch.clamp(_dot3(v, v), min=floor))
    return [x * inv for x in v]


def _hero_wavelengths(key, nc):
    """The path's nc hero wavelengths (nm) and their sensor weights
    1 / pdf, from the lane key at sampler dim 1 (megakernel.py:306-324:
    sample_rgb_spectrum with atanh through log and cosh through exp)."""
    u, _ = _rng2(key, 1)
    wls, wts = [], []
    for c in range(nc):
        uc = u + c * (1.0 / nc)
        uc = uc - torch.floor(uc)
        arg = 0.8569106254698279 - 1.8275019724092267 * uc
        ath = 0.5 * torch.log((1.0 + arg)
                              / torch.clamp(1.0 - arg, min=1e-12))
        wl = 538.0 - ath * 138.88888888888889
        e = torch.exp(0.0072 * (wl - 538.0))
        ch = 0.5 * (e + 1.0 / e)
        wls.append(wl)
        wts.append(253.82 * ch * ch)
    return wls, wts


def _wl_norm(wl):
    return (wl - _WL_MIN) / (_WL_MAX - _WL_MIN) * 2.0 - 1.0


def _sigmoid(c0, c1, c2, x):
    """Jakob-Hanika sigmoid reflectance at normalized wavelength x."""
    t = (c0 * x + c1) * x + c2
    return 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))


def _spd_lerp(spd, wl, col):
    """Column ``col`` of the SPD table, linearly interpolated at the
    wavelengths (megakernel.py:436-463 d65_flat, cmf_flat)."""
    tpos = (wl - _WL_MIN) * (94.0 / (_WL_MAX - _WL_MIN))
    i0 = torch.clamp(torch.floor(tpos), 0.0, 93.0)
    w1 = torch.clamp(tpos - i0, 0.0, 1.0)
    i = i0.to(torch.int64)
    return spd[i, col] * (1.0 - w1) + spd[i + 1, col] * w1


def _cie_develop(spd, res, wls):
    """Hero-wavelength radiance -> linear sRGB rows: the CMFs at the
    wavelengths (zero outside [360, 830] nm), summed over the channels and
    divided by their count, then XYZ_TO_SRGB (megakernel.py:1378-1393)."""
    xyz = [torch.zeros_like(res[0]) for _ in range(3)]
    for r, wl in zip(res, wls):
        ok = ((wl >= _WL_MIN) & (wl <= _WL_MAX)).to(r.dtype)
        for k in range(3):
            xyz[k] = xyz[k] + _spd_lerp(spd, wl, 1 + k) * ok * r
    xyz = [x * (1.0 / len(res)) for x in xyz]
    M = spec.XYZ_TO_SRGB
    return [float(M[r, 0]) * xyz[0] + float(M[r, 1]) * xyz[1]
            + float(M[r, 2]) * xyz[2] for r in range(3)]


# ----------------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------------

def _woop_t_uv(woop, o, d):
    """Brute-force Woop test of every lane against every face.
    -> t, u, v, each (n, F)."""
    W = woop[None]                                       # (1, F, 12)

    def dot_o(k):
        return (o[0][:, None] * W[..., k] + o[1][:, None] * W[..., k + 1]
                + o[2][:, None] * W[..., k + 2] + W[..., k + 3])

    def dot_d(k):
        return (d[0][:, None] * W[..., k] + d[1][:, None] * W[..., k + 1]
                + d[2][:, None] * W[..., k + 2])

    t = -dot_o(8) / dot_d(8)
    u = dot_o(0) + t * dot_d(0)
    v = dot_o(4) + t * dot_d(4)
    return t, u, v


def _face_ok(t, u, v, maxt):
    m3 = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    return (m3 >= 0.0) & (t >= 0.0) & (t <= maxt[:, None])


def _sphere_t(sph, o, d, maxt):
    """Every lane against every sphere: near root above 0, else the far
    root (megakernel.py:917-929). -> (t, ok), each (n, S)."""
    lx = o[0][:, None] - sph[:, 0]
    ly = o[1][:, None] - sph[:, 1]
    lz = o[2][:, None] - sph[:, 2]
    b = lx * d[0][:, None] + ly * d[1][:, None] + lz * d[2][:, None]
    cc = lx * lx + ly * ly + lz * lz - sph[:, 3] * sph[:, 3]
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    ts = torch.where(t0 > 0.0, t0, t1)
    ok = (disc > 0) & (ts > 0.0) & (ts < maxt[:, None])
    return ts, ok


def _argmin_lowest(t):
    """-> (min over axis 1, lowest index that attains it)."""
    tmin = t.min(dim=1).values
    ids = torch.arange(t.shape[1], device=t.device)
    k = torch.where(t <= tmin[:, None], ids,
                    torch.full_like(ids, t.shape[1])).min(dim=1).values
    return tmin, k.clamp(max=t.shape[1] - 1)


def _closest_hit(tables, o, d, maxt):
    """-> (t (n,), attributes (n, FA), bary u, bary v); t = BIG and zero
    attributes where nothing is hit. Faces tie to the lowest face id and
    win ties against spheres; a sphere hit carries its outward normal in
    the normal columns and its spherical uv as (u, v)."""
    n = o[0].shape[0]
    big = torch.full((n,), _BIG, dtype=torch.float32, device=o[0].device)
    zero = torch.zeros_like(big)
    t, A, bu, bv = big, torch.zeros((n, FA), device=big.device), zero, zero
    if tables.n_faces:
        tf, uf, vf = _woop_t_uv(tables.woop, o, d)
        ok = _face_ok(tf, uf, vf, maxt)
        tmin, k = _argmin_lowest(torch.where(ok, tf, big[:, None]))
        hit = tmin < _BIG * 0.5
        t = tmin
        A = torch.where(hit[:, None], tables.fattr[k], A)
        if tables.flags & HAS_CHECKER:
            bu = torch.where(hit, uf.gather(1, k[:, None])[:, 0], zero)
            bv = torch.where(hit, vf.gather(1, k[:, None])[:, 0], zero)
    if tables.flags & HAS_SPHERES:
        ts, oks = _sphere_t(tables.sph, o, d, maxt)
        tsmin, s = _argmin_lowest(torch.where(oks, ts, big[:, None]))
        closer = tsmin < t
        tsafe = torch.where(closer, tsmin, t)
        C = tables.sph[s]
        inv_r = 1.0 / torch.clamp(C[:, 3], min=1e-20)
        sn = [(o[k] + tsafe * d[k] - C[:, k]) * inv_r for k in range(3)]
        SA = torch.cat([torch.stack(sn, 1), tables.sattr[s][:, 3:]], 1)
        A = torch.where(closer[:, None], SA, A)
        t = torch.where(closer, tsmin, t)
        if tables.flags & HAS_CHECKER:
            su = torch.atan2(sn[1], sn[0]) * (0.5 / _PI) + 0.5
            sv = torch.acos(torch.clamp(sn[2], -1.0, 1.0)) * (1.0 / _PI)
            bu = torch.where(closer, su, bu)
            bv = torch.where(closer, sv, bv)
    return t, A, bu, bv


def _first_or_all(hits):
    """Per lane: tests a loop over the columns of ``hits`` that stops at
    the first hit runs (index of the first hit + 1, else all)."""
    n = hits.shape[1]
    first = torch.where(hits, torch.arange(n, device=hits.device),
                        torch.full_like(hits, n, dtype=torch.int64))
    return (first.min(dim=1).values + 1).clamp(max=n)


def _occluded(tables, o, d, maxt, stats=None, live=None):
    """Shadow any-hit of every lane; ``stats`` (with the ``live`` lanes
    that trace the ray) sums the face and sphere tests the kernel's loops,
    which stop at the first occluder, run ("shadow_faces",
    "shadow_spheres")."""
    occ = torch.zeros(o[0].shape[0], dtype=torch.bool, device=o[0].device)
    if tables.n_faces:
        hits = _face_ok(*_woop_t_uv(tables.woop, o, d), maxt)
        occ = hits.any(1)
        if stats is not None:
            stats["shadow_faces"] = stats.get("shadow_faces", 0) + int(
                _first_or_all(hits)[live].sum())
    if tables.flags & HAS_SPHERES:
        hits = _sphere_t(tables.sph, o, d, maxt)[1]
        if stats is not None:
            stats["shadow_spheres"] = stats.get("shadow_spheres", 0) + int(
                _first_or_all(hits)[live & ~occ].sum())
        occ = occ | hits.any(1)
    return occ


def _rot3(M, v):
    """Constant 3x3 (row-major 9 floats) times v, renormalised."""
    r = [M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2]
         for i in range(3)]
    return _normalized(r)


def _env_uv(tables, d):
    """World direction -> env-local (u, v, sin theta) (envmap.cpp:
    u = atan2(x, -z) / 2 pi + 1/2, v = acos(y) / pi)."""
    if tables.flags & HAS_ENV_ROT:
        d = _rot3(tables.env_rot[9:], d)
    u = torch.atan2(d[0], -d[2]) * (0.5 / _PI) + 0.5
    v = torch.acos(torch.clamp(d[1], -1.0, 1.0)) * (1.0 / _PI)
    st = torch.sqrt(torch.clamp(1.0 - d[1] * d[1], min=1e-12))
    return u, v, st


def _env_fetch(tables, u, v):
    """Bilinear lat-long fetch of all four texel planes, u and v wrapping
    (megakernel.py:1219)."""
    H, W = tables.env.shape[:2]
    fu = u * W - 0.5
    fv = v * H - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    wu = (fu - u0)[:, None]
    wv = (fv - v0)[:, None]
    iu0 = torch.remainder(u0.to(torch.int64), W)
    iv0 = torch.remainder(v0.to(torch.int64), H)
    iu1 = torch.remainder(iu0 + 1, W)
    iv1 = torch.remainder(iv0 + 1, H)
    T = tables.env
    c0 = (1.0 - wv) * T[iv0, iu0] + wv * T[iv1, iu0]
    c1 = (1.0 - wv) * T[iv0, iu1] + wv * T[iv1, iu1]
    out = (1.0 - wu) * c0 + wu * c1
    return [out[:, c] for c in range(4)]


def _env_pdf(tables, d):
    """Solid-angle density of the env NEE arm toward world direction d:
    the grid texel's pmf * Ws Hs / (2 pi^2 sin theta)."""
    u, v, st = _env_uv(tables, d)
    hs, ws = tables.env_pmf.shape
    iu = torch.remainder(torch.floor(u * ws).to(torch.int64), ws)
    iv = torch.floor(v * hs).to(torch.int64).clamp(0, hs - 1)
    return tables.env_pmf[iv, iu] * (ws * hs) / torch.clamp(
        2.0 * _PI * _PI * st, min=1e-8)


def _env_sample(tables, u1, u2, j1, j2):
    """CDF-inverted env sample: the row whose marginal cdf first exceeds
    u1, the column whose conditional cdf first exceeds u2, uniform jitter
    in the texel. -> (world direction, solid-angle pdf, texel planes)."""
    hs, ws = tables.env_pmf.shape
    iv = (tables.env_marg[None, :] <= u1[:, None]).sum(1).clamp(0, hs - 1)
    iu = (tables.env_cond[iv] <= u2[:, None]).sum(1).clamp(0, ws - 1)
    pmf = tables.env_pmf[iv, iu]
    uu = (iu.to(torch.float32) + j1) / ws
    vv = (iv.to(torch.float32) + j2) / hs
    theta = vv * _PI
    phi = (uu - 0.5) * (2.0 * _PI)
    st = torch.sin(theta)
    ld = [st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)]
    pdf = pmf * (ws * hs) / torch.clamp(2.0 * _PI * _PI * st, min=1e-8)
    rad = _env_fetch(tables, uu, vv)
    if tables.flags & HAS_ENV_ROT:
        ld = _rot3(tables.env_rot[:9], ld)
    return ld, pdf, rad


def _trace_lanes(tables, cam, key, pixel, width, height, max_depth,
                 rr_depth, stats=None):
    """Radiance (3, n) linear sRGB of the lanes with TEA keys ``key`` at
    ``pixel``. ``stats``, if given, sums the lanes that trace a ray
    ("rays"), escape to the envmap ("escaped"), shade a bounce ("shaded",
    of them "ggx" on a conductor), sample the env NEE arm ("env_nee") and
    trace a shadow ray ("shadow"), and the shadow rays' tests
    (``_occluded``)."""
    dev = key.device
    f32 = torch.float32
    nc = tables.nc
    spectral = nc == MODE_NC["spectral"]
    n = key.shape[0]
    zero = torch.zeros(n, dtype=f32, device=dev)
    one = torch.ones_like(zero)
    big = torch.full_like(zero, _BIG)
    px = (pixel % width).to(f32)
    py = (pixel // width).to(f32)
    jx, jy = _rng2(key, 0)
    sx = (px + jx) / width
    sy = (py + jy) / height
    tan_half = cam[12]
    cxs = -(2.0 * sx - 1.0) * tan_half
    cys = (1.0 - 2.0 * sy) * tan_half / (width / height)
    inv_len = torch.rsqrt(cxs * cxs + cys * cys + 1.0)
    lx, ly, lz = cxs * inv_len, cys * inv_len, inv_len
    d = [cam[3 * r] * lx + cam[3 * r + 1] * ly + cam[3 * r + 2] * lz
         for r in range(3)]
    o = [zero + cam[9 + r] for r in range(3)]
    if spectral:
        # hero wavelengths, constant along the path; the sensor weight
        # 1 / pdf is the initial throughput (megakernel.py:1347-1351)
        wls, thr = _hero_wavelengths(key, nc)
        xw = [_wl_norm(w) for w in wls]
        d65 = [_spd_lerp(tables.spd, w, 0) for w in wls]
    else:
        thr = [one.clone() for _ in range(nc)]
    res = [zero.clone() for _ in range(nc)]
    prev_pdf = zero
    active = torch.ones(n, dtype=torch.bool, device=dev)
    lights = tables.lights
    L = lights.shape[0]
    has_env = bool(tables.flags & HAS_ENV)
    has_ggx = bool(tables.flags & HAS_GGX)
    p_env = tables.p_env
    env_arm = has_env and p_env > 0.0

    def count(name, mask):
        if stats is not None:
            stats[name] = stats.get(name, 0) + int(mask.sum())

    for depth in range(max_depth):
        dim0 = 2 + 8 * depth
        count("rays", active)
        t, A, bu, bv = _closest_hit(tables, o, d,
                                    torch.where(active, big, -big))
        ng = [A[:, C_NG + k] for k in range(3)]
        lpdf_w = A[:, C_LPDF]
        kind = A[:, C_KIND]
        hit = t < _BIG * 0.5
        if spectral:
            le = [_sigmoid(A[:, C_LE], A[:, C_LE + 1], A[:, C_LE + 2], xw[c])
                  * d65[c] * A[:, C_LESCALE] for c in range(nc)]
        else:
            le = [A[:, C_LE + c] for c in range(nc)]

        # environment on escape, MIS-weighted against the env NEE arm
        if has_env:
            ep = _env_fetch(tables, *_env_uv(tables, d)[:2])
            if spectral:
                env_ch = [_sigmoid(ep[0], ep[1], ep[2], xw[c]) * ep[3]
                          * d65[c] for c in range(nc)]
            else:
                env_ch = ep[:nc]
            if p_env > 0.0 and depth > 0:
                epdf = _env_pdf(tables, d) * p_env
                w_esc = torch.where(prev_pdf > 0.0, _mis(prev_pdf, epdf), one)
            else:
                w_esc = one
            esc = active & ~hit
            count("escaped", esc)
            for c in range(nc):
                res[c] = res[c] + torch.where(esc, w_esc * thr[c]
                                              * env_ch[c], zero)

        # emission, MIS-weighted against NEE after the camera vertex
        cos_hit = -(d[0] * ng[0] + d[1] * ng[1] + d[2] * ng[2])
        if depth == 0:
            em_w = one
        else:
            pdf_l_hit = torch.where(
                cos_hit > 1e-6,
                t * t * lpdf_w / torch.clamp(cos_hit, min=1e-6), zero)
            em_w = torch.where(prev_pdf > 0.0, _mis(prev_pdf, pdf_l_hit),
                               one)
        wgt = torch.where(active & hit & (cos_hit > 0), em_w, zero)
        for c in range(nc):
            res[c] = res[c] + wgt * thr[c] * le[c]
        if depth == max_depth - 1:
            break

        # albedo payload; checkerboard: uv from the barycentrics, affine
        # to_uv, parity of floor(u') + floor(v')
        pay = [A[:, C_ALB + c] for c in range(3)]
        if tables.flags & HAS_CHECKER:
            uu = A[:, C_UV0] + bu * A[:, C_DUV1] + bv * A[:, C_DUV2]
            vv = A[:, C_UV0 + 1] + bu * A[:, C_DUV1 + 1] \
                + bv * A[:, C_DUV2 + 1]
            u2 = A[:, C_TOUV0] * uu + A[:, C_TOUV0 + 1] * vv \
                + A[:, C_TOUV0 + 2]
            v2 = A[:, C_TOUV1] * uu + A[:, C_TOUV1 + 1] * vv \
                + A[:, C_TOUV1 + 2]
            par = torch.remainder(torch.floor(u2) + torch.floor(v2), 2.0)
            use_c1 = (kind > 1.5) & (kind < 2.5) & (par > 0.5)
            pay = [torch.where(use_c1, A[:, C_C1 + c], pay[c])
                   for c in range(3)]
        if spectral:
            alb = [_sigmoid(pay[0], pay[1], pay[2], xw[c]) for c in range(nc)]
        else:
            alb = pay[:nc]
        is_ggx = (kind > 0.5) & (kind < 1.5)
        if has_ggx:
            if spectral:
                # eta(x), k(x): the IOR quadratics at the clamped x
                xc = [torch.clamp(xw[c], A[:, C_XLO], A[:, C_XHI])
                      for c in range(nc)]
                eta = [(A[:, C_ETA] * xc[c] + A[:, C_ETA + 1]) * xc[c]
                       + A[:, C_ETA + 2] for c in range(nc)]
                kap = [(A[:, C_K] * xc[c] + A[:, C_K + 1]) * xc[c]
                       + A[:, C_K + 2] for c in range(nc)]
            else:
                eta = [A[:, C_ETA + c] for c in range(nc)]
                kap = [A[:, C_K + c] for c in range(nc)]

        # FrontSide lobes only: back-face hits end the path
        act = active & hit & (cos_hit > 0)
        count("shaded", act)
        count("ggx", act & is_ggx)
        n_ = ng
        p = [o[k] + t * d[k] for k in range(3)]
        eps = (1.0 + torch.maximum(p[0].abs(), torch.maximum(
            p[1].abs(), p[2].abs()))) * 1.8e-4
        tx, ty = _frame(n_)

        def to_local(v):
            return [_dot3(v, tx), _dot3(v, ty), _dot3(v, n_)]

        def to_world(v):
            return [v[0] * tx[k] + v[1] * ty[k] + v[2] * n_[k]
                    for k in range(3)]

        wi = to_local([-d[0], -d[1], -d[2]])
        wiz = torch.clamp(wi[2], min=1e-6)
        alpha = torch.clamp(A[:, C_ALPHA], min=1e-3)

        # Russian roulette (path.cpp:133-141)
        if depth + 1 > rr_depth:
            rr_u, _ = _rng2(key, dim0 + 0)
            mx = thr[0]
            for c in range(1, nc):
                mx = torch.maximum(mx, thr[c])
            q = torch.clamp(mx, max=0.95)
            act = act & (rr_u < q)
            inv_q = 1.0 / torch.clamp(q, min=1e-8)
            thr_ = [thr[c] * inv_q for c in range(nc)]
        else:
            thr_ = list(thr)

        # NEE: the env arm with probability p_env, else an area-weighted
        # light face through the cdf and a uniform point on it
        u_sel, u_b1 = _rng2(key, dim0 + 1)
        u_b2, _ = _rng2(key, dim0 + 2)
        if env_arm:
            use_env = u_sel < p_env
            u_area = (u_sel - p_env) / max(1.0 - p_env, 1e-8)
        else:
            u_area = u_sel
        li = (lights[:, 12][None, :] <= u_area[:, None]).sum(dim=1)
        LT = lights[li.clamp(max=L - 1)]
        s_t = torch.sqrt(torch.clamp(1.0 - u_b1, min=0.0))
        bu_l = 1.0 - s_t
        bv_l = u_b2 * s_t
        dl = [LT[:, k] + LT[:, 3 + k] * bu_l + LT[:, 6 + k] * bv_l - p[k]
              for k in range(3)]
        dist2 = _dot3(dl, dl)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        inv_dist = 1.0 / dist
        dl = [x * inv_dist for x in dl]
        cos_l = -(dl[0] * LT[:, 9] + dl[1] * LT[:, 10] + dl[2] * LT[:, 11])
        pdf_l = torch.where(cos_l > 1e-6,
                            dist2 * LT[:, 13] / torch.clamp(cos_l, min=1e-6),
                            zero)
        if spectral:
            lrad = [_sigmoid(LT[:, 14], LT[:, 15], LT[:, 16], xw[c])
                    * d65[c] * LT[:, 17] for c in range(nc)]
        else:
            lrad = [LT[:, 14 + c] for c in range(nc)]
        if env_arm:
            ej1, ej2 = _rng2(key, dim0 + 5)
            edl, epdf, ep = _env_sample(tables, u_b1, u_b2, ej1, ej2)
            if spectral:
                erad = [_sigmoid(ep[0], ep[1], ep[2], xw[c]) * ep[3] * d65[c]
                        for c in range(nc)]
            else:
                erad = ep[:nc]
            dl = [torch.where(use_env, edl[k], dl[k]) for k in range(3)]
            pdf_l = torch.where(use_env, epdf * p_env, pdf_l)
            lrad = [torch.where(use_env, erad[c], lrad[c])
                    for c in range(nc)]
            # env shadow rays test the whole open segment
            dist = torch.where(use_env, torch.full_like(dist, 1e7), dist)
        cos_s = _dot3(dl, n_)
        nee_ok = act & (pdf_l > 0) & (cos_s > 0)
        count("shadow", nee_ok)
        if env_arm:
            count("env_nee", act & use_env)
        occluded = _occluded(
            tables, [p[k] + n_[k] * eps for k in range(3)], dl,
            torch.where(nee_ok, dist * (1.0 - 1e-3), -big), stats, nee_ok)
        # BSDF toward the light: f * cos and the BSDF's own pdf
        pdf_bsdf_l = torch.clamp(cos_s, min=0.0) / _PI
        fcos = [alb[c] * (cos_s / _PI) for c in range(nc)]
        if has_ggx:
            wo = to_local(dl)
            h = _normalized([wi[0] + wo[0], wi[1] + wo[1], wiz + wo[2]])
            ci_h = torch.clamp(wi[0] * h[0] + wi[1] * h[1] + wiz * h[2],
                               min=0.0)
            D = _ggx_d(h[2], alpha)
            g1i = _ggx_g1(wiz, alpha)
            spec_ = D * (g1i * _ggx_g1(torch.clamp(wo[2], min=1e-6), alpha)) \
                / torch.clamp(4.0 * wiz, min=1e-20)
            pdf_ggx_l = g1i * D / torch.clamp(4.0 * wiz, min=1e-20)
            ggx_ok = (wo[2] > 0).to(f32)
            pdf_bsdf_l = torch.where(is_ggx, pdf_ggx_l, pdf_bsdf_l)
            fcos = [torch.where(
                is_ggx, alb[c] * spec_ * fresnel_conductor(
                    ci_h, eta[c], kap[c]) * ggx_ok,
                fcos[c]) for c in range(nc)]
        base = _mis(pdf_l, pdf_bsdf_l) / torch.clamp(pdf_l, min=1e-20)
        gate = nee_ok & ~occluded
        for c in range(nc):
            res[c] = res[c] + torch.where(
                gate, thr_[c] * base * fcos[c] * lrad[c], zero)

        # BSDF sample: cosine-weighted diffuse, or GGX visible normals
        # (Heitz 2018) with throughput albedo * F * G1(wo)
        u_c1, u_c2 = _rng2(key, dim0 + 4)
        cx, cy = _concentric(u_c1, u_c2)
        cz = torch.sqrt(torch.clamp(1.0 - cx * cx - cy * cy, min=0.0))
        wsel = [cx, cy, cz]
        bsdf_pdf = cz / _PI
        ok_lobe = cz > 0
        mm = list(alb)
        if has_ggx:
            vh = _normalized([alpha * wi[0], alpha * wi[1], wiz])
            lensq = vh[0] * vh[0] + vh[1] * vh[1]
            linv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
            t1x = torch.where(lensq > 1e-12, -vh[1] * linv, one)
            t1y = torch.where(lensq > 1e-12, vh[0] * linv, zero)
            t2 = [-vh[2] * t1y, vh[2] * t1x, vh[0] * t1y - vh[1] * t1x]
            rr = torch.sqrt(torch.clamp(u_c1, min=0.0))
            phi = 2.0 * _PI * u_c2
            p1 = rr * torch.cos(phi)
            p2 = rr * torch.sin(phi)
            s_ = 0.5 * (1.0 + vh[2])
            p2 = (1.0 - s_) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
                + s_ * p2
            pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
            nh = [p1 * t1x + p2 * t2[0] + pz * vh[0],
                  p1 * t1y + p2 * t2[1] + pz * vh[1],
                  p2 * t2[2] + pz * vh[2]]
            mh = [alpha * nh[0], alpha * nh[1], torch.clamp(nh[2], min=1e-6)]
            minv = torch.rsqrt(_dot3(mh, mh))
            mh = [x * minv for x in mh]
            wm = wi[0] * mh[0] + wi[1] * mh[1] + wiz * mh[2]
            go = [2.0 * wm * mh[0] - wi[0], 2.0 * wm * mh[1] - wi[1],
                  2.0 * wm * mh[2] - wiz]
            pdf_ggx = _ggx_g1(wiz, alpha) * _ggx_d(mh[2], alpha) \
                / torch.clamp(4.0 * wiz, min=1e-20)
            g1o = _ggx_g1(torch.clamp(go[2], min=1e-6), alpha)
            wsel = [torch.where(is_ggx, go[k], wsel[k]) for k in range(3)]
            bsdf_pdf = torch.where(is_ggx, pdf_ggx, bsdf_pdf)
            ok_lobe = torch.where(is_ggx, (go[2] > 1e-6) & (wm > 0), ok_lobe)
            mm = [torch.where(is_ggx, alb[c] * fresnel_conductor(
                torch.clamp(wm, min=0.0), eta[c], kap[c])
                * g1o, alb[c]) for c in range(nc)]
        nd = to_world(wsel)
        thr = [thr_[c] * torch.where(act, mm[c], one) for c in range(nc)]
        thr_sum = thr[0]
        for c in range(1, nc):
            thr_sum = thr_sum + thr[c]
        active = act & ok_lobe & (bsdf_pdf > 0) & (thr_sum > 0)
        # leave on the side the new ray goes (always the normal's side
        # for the lobes of this scope)
        off = torch.where(wsel[2] >= 0.0, eps, -eps)
        o = [p[k] + n_[k] * off for k in range(3)]
        d = nd
        prev_pdf = bsdf_pdf
    if spectral:
        return torch.stack(_cie_develop(tables.spd, res, wls))
    if nc == 1:
        return torch.stack(res * 3)
    return torch.stack(res)


def lane_keys(seed, sample_base, spp_pass, lanes):
    """-> (TEA lane keys, pixel ids) of int64 lane indices
    (megakernel.py:1316-1329)."""
    pixel = lanes // spp_pass
    samp = lanes % spp_pass + sample_base
    mixed, _ = _tea(pixel, samp, 4)
    key, _ = _tea(torch.full_like(mixed, seed & 0xFFFFFFFF), mixed, 4)
    return key, pixel


def path_radiance_reference(tables, cam, seed, sample_base, spp_pass,
                            width, height, max_depth, rr_depth, stats=None):
    """Plain PyTorch version of the path kernel -> (3, n) float32 per-lane
    linear sRGB radiance, n = width * height * spp_pass, on the tables'
    device.

    Vectorised over lanes with a Python loop over depth and brute-force
    (lanes x faces), (lanes x spheres) and (lanes x cdf entries) tests, in
    lane chunks that keep each such temporary within ``_CHUNK_ELEMS``
    elements. ``stats``: see ``_trace_lanes``."""
    dev = tables.device
    n = width * height * spp_pass
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    widest = max(tables.n_faces + tables.n_spheres, tables.lights.shape[0],
                 *tables.env_cond.shape, 1)
    step = max(1, _CHUNK_ELEMS // widest)
    for start in range(0, n, step):
        lanes = torch.arange(start, min(n, start + step), device=dev)
        key, pixel = lane_keys(seed, sample_base, spp_pass, lanes)
        out[:, start:start + len(lanes)] = _trace_lanes(
            tables, cam, key, pixel, width, height, max_depth, rr_depth,
            stats)
    return out


# ----------------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------------

class _PathArgs(ctypes.Structure):
    """csrc/path_kernel.cu's PathArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "woop", "fattr", "lights", "sph", "sattr", "env", "env_marg",
        "env_cond", "env_pmf", "env_rot", "spd", "cam", "out")]
        + [(name, ctypes.c_int) for name in (
            "n_faces", "n_lights", "n_spheres", "env_w", "env_h", "env_ws",
            "env_hs", "env_has_rot")]
        + [("p_env", ctypes.c_float), ("seed", ctypes.c_uint32),
           ("sample_base", ctypes.c_uint32)]
        + [(name, ctypes.c_int) for name in (
            "spp_pass", "width", "height", "max_depth", "rr_depth",
            "n_lanes", "flags", "nc")])


def _check_tables(tables, cam):
    shapes = (("woop", tables.woop, (tables.n_faces, 12)),
              ("fattr", tables.fattr, (tables.n_faces, FA)),
              ("lights", tables.lights, (tables.lights.shape[0], 24)),
              ("sph", tables.sph, (tables.n_spheres, 4)),
              ("sattr", tables.sattr, (tables.n_spheres, FA)),
              ("env", tables.env, tables.env.shape[:2] + (4,)),
              ("env_marg", tables.env_marg, tables.env_pmf.shape[:1]),
              ("env_cond", tables.env_cond, tables.env_pmf.shape),
              ("env_pmf", tables.env_pmf, tables.env_pmf.shape),
              ("env_rot", tables.env_rot, (18,)),
              ("spd", tables.spd, (SPD_ROWS if tables.nc == 4 else 0, 4)),
              ("cam", cam, (16,)))
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != tables.device:
            raise ValueError(f"{name} is on {t.device}, not {tables.device}")
    if tables.lights.shape[0] < 1:
        raise ValueError("the light table needs at least its dummy row")
    if tables.n_faces > MAX_FACES:
        raise ValueError(f"{tables.n_faces} faces > {MAX_FACES}")
    if tables.n_spheres > MAX_SPHERES:
        raise ValueError(f"{tables.n_spheres} spheres > {MAX_SPHERES}")
    if tables.nc not in NC_MODE:
        raise ValueError(f"no path kernel for {tables.nc} color channels")
    if tables.flags & HAS_ENV and (min(tables.env.shape[:2]) < 1
                                   or min(tables.env_pmf.shape) < 1):
        raise ValueError("an envmap needs non-empty radiance and grid "
                         "tables")


def path_radiance(tables, cam, seed, sample_base, spp_pass, width, height,
                  max_depth, rr_depth):
    """Per-lane radiance (3, n): the CUDA kernel for tables on a CUDA
    device, the plain version for tables on the CPU. A build or launch
    failure raises."""
    dev = tables.device
    if dev.type == "cpu":
        return path_radiance_reference(tables, cam, seed, sample_base,
                                       spp_pass, width, height, max_depth,
                                       rr_depth)
    if dev.type != "cuda":
        raise ValueError(f"no path kernel for device {dev}")
    _check_tables(tables, cam)
    n = width * height * spp_pass
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes overflow the kernel's int32 lane ids")
    render = _path_render(tables.nc)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    H, W = tables.env.shape[:2]
    Hs, Ws = tables.env_pmf.shape
    args = _PathArgs(
        *(t.data_ptr() for t in (
            tables.woop, tables.fattr, tables.lights, tables.sph,
            tables.sattr, tables.env, tables.env_marg, tables.env_cond,
            tables.env_pmf, tables.env_rot, tables.spd, cam, out)),
        tables.n_faces, tables.lights.shape[0], tables.n_spheres, W, H, Ws,
        Hs, int(bool(tables.flags & HAS_ENV_ROT)), tables.p_env,
        seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF, spp_pass, width,
        height, max_depth, rr_depth, n, tables.flags & TEMPLATE_FLAGS,
        tables.nc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = render(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"path_kernel launch failed: CUDA error {err}")
    path_radiance.launches += 1
    path_radiance.launches_by_kernel[
        (tables.flags & TEMPLATE_FLAGS, tables.nc)] += 1
    return out


# kernel launches in total and by instantiation ((TEMPLATE_FLAGS bits, nc))
path_radiance.launches = 0
path_radiance.launches_by_kernel = collections.Counter()


def reset_launch_counts():
    path_radiance.launches = 0
    path_radiance.launches_by_kernel.clear()


def library_defines(nc):
    """nvcc defines of the path kernel's library for ``nc`` channels: one
    library per color mode, each with its 16 flag instantiations."""
    return {"PK_NC": nc}


def libraries():
    """(name, defines) of the three color modes' libraries, for
    ``build.build_all``."""
    return [("path_kernel", library_defines(nc)) for nc in (3, 4, 1)]


def _path_render(nc):
    """csrc/path_kernel.cu's C entry point for ``nc`` color channels,
    built on first use."""
    from .build import load
    fn = load("path_kernel", library_defines(nc)).path_render
    fn.argtypes = [ctypes.POINTER(_PathArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------------
# host side: one scene's kernel and its gate
# ----------------------------------------------------------------------------

class PathKernel:
    """Renders passes of one scene's tables through one sensor
    (DiffusePathMegakernel's role, megakernel.py:2779)."""

    def __init__(self, scene, sensor, max_depth, rr_depth):
        self.tables = scene.tables
        self.size = sensor.film.crop_size
        # uploaded once: a pageable host-to-device copy per pass would
        # make the host wait for the previous pass's kernel
        self.cam = camera_row(sensor, self.tables.device)
        self.max_depth = max_depth
        self.rr_depth = rr_depth

    def render_pass(self, seed, sample_base, spp_pass):
        """-> (h, w, 4) box-filtered block: per-pixel radiance sums over
        the pass's samples and the sample count as weight."""
        w, h = self.size
        rgb = path_radiance(self.tables, self.cam, seed, sample_base,
                            spp_pass, w, h, self.max_depth, self.rr_depth)
        rgb = rgb.reshape(3, w * h, spp_pass).sum(dim=2)
        img = torch.cat([rgb, torch.full((1, w * h), float(spp_pass),
                                         device=rgb.device)])
        return img.T.reshape(h, w, 4)


def bsdf_ineligibility(bsdf, mode):
    """-> None if the kernel shades ``bsdf`` in color mode ``mode``, else
    the reason (megakernel.py:2004 _bsdf_columns, narrowed to this
    slice)."""
    from ..models.bsdfs import SmoothDiffuse, RoughConductor
    from ..models.spectra import ConductorIORSpectrum
    from ..models.textures import ConstantTexture, CheckerboardTexture
    name = f"unsupported BSDF {type(bsdf).__name__}"
    if type(bsdf) is SmoothDiffuse:
        tex = bsdf.reflectance
        if type(tex) is ConstantTexture:
            return None
        if type(tex) is CheckerboardTexture \
                and type(tex.color0) is ConstantTexture \
                and type(tex.color1) is ConstantTexture:
            return None
        return name
    if type(bsdf) is RoughConductor:
        if mode == "spectral" and not all(
                type(t) is ConductorIORSpectrum
                for t in (bsdf.eta_tex, bsdf.k_tex)):
            # curve spectra the user supplied (megakernel.py:3094-3103)
            return "conductor IOR curve spectra in spectral mode"
        if bsdf.dist_type != "ggx" or bsdf.alpha_u != bsdf.alpha_v \
                or bsdf.alpha_u < 0.01:
            return name
        ior = () if mode == "spectral" else (bsdf.eta_tex, bsdf.k_tex)
        if not all(type(t) is ConstantTexture
                   for t in (*ior, bsdf.specular_reflectance)):
            return name
        return None
    return name


def path_kernel_ineligibility(scene):
    """-> None if the scene is inside the kernel's scope, else a short
    reason (megakernel.py:3076 megakernel_ineligibility, narrowed to this
    slice)."""
    from ..variants import current
    from ..models.emitters import AreaEmitter, EnvironmentMap
    from ..models.shapes import SphereShape
    from ..models.textures import ConstantTexture
    var = current()
    if var.polarized:
        return "polarized variant"
    if var.double_precision:
        return "double-precision variant"
    mode = var.color_mode
    if mode == "spectral":
        for sh in scene.shapes:
            reason = bsdf_ineligibility(sh.bsdf, mode)
            if reason == "conductor IOR curve spectra in spectral mode":
                return reason
        for e in scene.emitters:
            if type(e) is AreaEmitter and not hasattr(e.radiance,
                                                      "_d65_scale"):
                return ("area emitter spectrum without srgb_d65 payload "
                        "in spectral mode")
    if scene.has_media:
        return "participating media"
    if not scene.shapes:
        return "no shapes"
    for sh in scene.shapes:
        if not sh.is_mesh() and type(sh) is not SphereShape:
            return f"non-triangle shape {type(sh).__name__}"
    if scene.tables.n_faces > MAX_FACES:
        return f"face count {scene.tables.n_faces} > {MAX_FACES}"
    if scene.tables.n_spheres > MAX_SPHERES:
        return f"sphere count > {MAX_SPHERES}"
    for sh in scene.shapes:
        if type(sh) is SphereShape and sh.flip_normals:
            # the kernel shades the outward normal (megakernel.py:944)
            return "sphere with flip_normals"
    for sh in scene.shapes:
        reason = bsdf_ineligibility(sh.bsdf, mode)
        if reason is not None:
            return reason
    for e in scene.emitters:
        if type(e) is EnvironmentMap:
            if e is not scene.environment_emitter:
                return "multiple envmaps"
            if max(e.res) > MAX_ENV_W:
                return f"envmap larger than {MAX_ENV_W}"
            M = np.asarray(e.to_world.matrix)[:3, :3]
            if not np.allclose(M @ M.T, np.eye(3), atol=1e-5):
                return "non-rigid envmap to_world"
            continue
        if type(e) is not AreaEmitter:
            return f"unsupported emitter {type(e).__name__}"
        if mode != "spectral" and type(e.radiance) is not ConstantTexture:
            return "textured area emitter"
    return None
