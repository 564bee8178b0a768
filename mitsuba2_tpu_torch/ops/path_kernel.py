"""Path tracing for the Cornell-box slice: host side, plain PyTorch version
and the CUDA kernel's wrapper.

Counterpart of ``mitsuba2_tpu/ops/megakernel.py``, for its K1a scope:
triangle meshes of at most ``MAX_FACES`` faces, constant-albedo diffuse
BSDFs, constant area lights, rgb, box filter. One lane is one camera path,
lanes are pixel-major (``lane = pixel * spp_pass + s``), and the estimator
is ``_path_kernel``'s (path.cpp:92-234): emission with power-2 MIS against
area NEE, NEE through the light-table cdf with a shadow any-hit, cosine
sampling of the diffuse lobe, Russian roulette after ``rr_depth``, and an
emission-only last bounce. Random numbers are the reference kernel's TEA
streams: lane key ``_tea(seed, _tea(pixel, sample, 4), 4)``, film jitter
at dim 0, and dims ``2 + 8 * depth + k`` per bounce (k = 0 roulette, 1-2
NEE, 4 BSDF sample), so a port render agrees with the reference per pixel
at equal seed.

``path_radiance`` runs the hand-written kernel (csrc/path_kernel.cu) for
tables on a CUDA device and ``path_radiance_reference`` -- the same
function in plain PyTorch -- for tables on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.rng import sample_tea_32, u32_to_float01

# The reference's unrolled face-sweep tier holds at most
# UNROLLED_CHUNKS * FACE_CHUNK faces (megakernel.py:82-85); larger meshes
# wait for the per-ray BVH traversal.
MAX_FACES = 1024
_BIG = 3.0e38
_PI = 3.141592653589793
# lanes x faces per chunk of the plain version's brute-force sweep
_CHUNK_ELEMS = 1 << 24


class PathTables(NamedTuple):
    """The scene's flat table set, all float32 on one device.

    woop   (F, 12): per face [Wu | Wv | Wz], each 4 floats, mapping a
           homogeneous world point to the unit triangle:
           u = p . Wu[:3] + Wu[3] (ops/intersect_pallas.py:55 build_woop).
    fattr  (F, 12): per face [ng(3), lpdf_w | albedo(3), 0 | Le(3), 0].
    lights (L, 24): the megakernel's light rows (render/scene.py
           _light_table), with the cdf-2.0 padding rows.
    """
    woop: torch.Tensor
    fattr: torch.Tensor
    lights: torch.Tensor

    @property
    def n_faces(self) -> int:
        return self.woop.shape[0]

    @property
    def device(self) -> torch.device:
        return self.woop.device


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


def pack_tables(v0, e1, e2, ng, albedo, le, lpdf_w, lights,
                device) -> PathTables:
    """Host per-face arrays -> the device table set."""
    F = len(v0)
    fattr = np.zeros((F, 12), np.float32)
    fattr[:, 0:3] = ng
    fattr[:, 3] = lpdf_w
    fattr[:, 4:7] = albedo
    fattr[:, 8:11] = le
    return PathTables(
        torch.as_tensor(build_woop(v0, e1, e2), device=device),
        torch.as_tensor(fattr, device=device),
        torch.as_tensor(np.ascontiguousarray(lights, np.float32),
                        device=device))


def tables_from_reference(woop, fattr, lights, cam, device=None):
    """The reference kernel's own tables -> (PathTables, camera row).

    Takes numpy arrays in ``DiffusePathMegakernel``'s layouts: ``woop``
    (n_chunks * 3C, 4) of the unrolled tier (per chunk, C rows each of
    Wu, Wv, Wz), ``fattr`` (fa, F) from ``_fattr()``, ``lights`` (24, L)
    and the (1, 16) camera row. Its never-hit padding faces come along
    unchanged."""
    woop = np.asarray(woop, np.float32)
    fattr = np.asarray(fattr, np.float32)
    F = fattr.shape[1]
    if woop.shape != (3 * F, 4):
        raise ValueError(f"woop {woop.shape} is not the unrolled (3F, 4) "
                         f"layout for F={F}")
    C = F if F <= 128 else 128     # megakernel FACE_CHUNK tiers
    blk = woop.reshape(F // C, 3, C, 4)          # chunk, axis, face, col
    rows = np.transpose(blk, (0, 2, 1, 3)).reshape(F, 12)
    fa = np.zeros((F, 12), np.float32)
    fa[:, 0:3] = fattr[0:3].T
    fa[:, 3] = fattr[9]
    fa[:, 4:7] = fattr[3:6].T
    fa[:, 8:11] = fattr[6:9].T
    dev = torch.device("cpu") if device is None else torch.device(device)
    tables = PathTables(
        torch.as_tensor(np.ascontiguousarray(rows), device=dev),
        torch.as_tensor(fa, device=dev),
        torch.as_tensor(np.ascontiguousarray(np.asarray(lights,
                                                        np.float32).T),
                        device=dev))
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
# plain versions of the kernel's RNG and sampling helpers (csrc/rng.cuh,
# megakernel.py:194-252)
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


def _closest_hit(tables, o, d, maxt):
    """-> (t (n,), face attributes (n, 12)); t = BIG and zero attributes
    where nothing is hit. Ties go to the lowest face id."""
    t, u, v = _woop_t_uv(tables.woop, o, d)
    t = torch.where(_face_ok(t, u, v, maxt), t, torch.full_like(t, _BIG))
    tmin = t.min(dim=1).values
    ids = torch.arange(t.shape[1], device=t.device)
    kmin = torch.where(t <= tmin[:, None], ids,
                       torch.full_like(ids, t.shape[1])).min(dim=1).values
    hit = tmin < _BIG * 0.5
    A = tables.fattr[kmin]
    return tmin, torch.where(hit[:, None], A, torch.zeros_like(A))


def _occluded(tables, o, d, maxt):
    t, u, v = _woop_t_uv(tables.woop, o, d)
    return _face_ok(t, u, v, maxt).any(dim=1)


def _trace_lanes(tables, cam, key, pixel, width, height, max_depth,
                 rr_depth):
    """Radiance (3, n) of the lanes with TEA keys ``key`` at ``pixel``."""
    dev = key.device
    f32 = torch.float32
    n = key.shape[0]
    zero = torch.zeros(n, dtype=f32, device=dev)
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
    thr = [torch.ones_like(zero) for _ in range(3)]
    res = [zero.clone() for _ in range(3)]
    prev_pdf = zero
    active = torch.ones(n, dtype=torch.bool, device=dev)
    lights = tables.lights
    L = lights.shape[0]

    for depth in range(max_depth):
        dim0 = 2 + 8 * depth
        t, A = _closest_hit(tables, o, d, torch.where(active, big, -big))
        ng = [A[:, 0], A[:, 1], A[:, 2]]
        lpdf_w = A[:, 3]
        alb = [A[:, 4], A[:, 5], A[:, 6]]
        le = [A[:, 8], A[:, 9], A[:, 10]]
        hit = t < _BIG * 0.5

        # emission, MIS-weighted against NEE after the camera vertex
        cos_hit = -(d[0] * ng[0] + d[1] * ng[1] + d[2] * ng[2])
        if depth == 0:
            em_w = torch.ones_like(zero)
        else:
            pdf_l_hit = torch.where(
                cos_hit > 1e-6,
                t * t * lpdf_w / torch.clamp(cos_hit, min=1e-6), zero)
            em_w = torch.where(prev_pdf > 0.0, _mis(prev_pdf, pdf_l_hit),
                               torch.ones_like(zero))
        wgt = torch.where(active & hit & (cos_hit > 0), em_w, zero)
        for c in range(3):
            res[c] = res[c] + wgt * thr[c] * le[c]
        if depth == max_depth - 1:
            break

        act = active & hit & (cos_hit > 0)
        n_ = ng
        p = [o[k] + t * d[k] for k in range(3)]
        eps = (1.0 + torch.maximum(p[0].abs(), torch.maximum(
            p[1].abs(), p[2].abs()))) * 1.8e-4
        # branchless orthonormal basis around n (Duff et al.)
        s = torch.where(n_[2] >= 0, torch.ones_like(zero),
                        -torch.ones_like(zero))
        oa = -1.0 / (s + n_[2])
        ob = n_[0] * n_[1] * oa
        tx = [1.0 + s * n_[0] * n_[0] * oa, s * ob, -s * n_[0]]
        ty = [ob, s + n_[1] * n_[1] * oa, -n_[1]]

        # Russian roulette (path.cpp:133-141)
        if depth + 1 > rr_depth:
            rr_u, _ = _rng2(key, dim0 + 0)
            q = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]),
                                          thr[2]), max=0.95)
            act = act & (rr_u < q)
            inv_q = 1.0 / torch.clamp(q, min=1e-8)
            thr_ = [thr[c] * inv_q for c in range(3)]
        else:
            thr_ = list(thr)

        # NEE: area-weighted light face through the cdf, uniform point
        u_sel, u_b1 = _rng2(key, dim0 + 1)
        u_b2, _ = _rng2(key, dim0 + 2)
        li = (lights[:, 12][None, :] <= u_sel[:, None]).sum(dim=1)
        LT = lights[li.clamp(max=L - 1)]
        s_t = torch.sqrt(torch.clamp(1.0 - u_b1, min=0.0))
        bu = 1.0 - s_t
        bv = u_b2 * s_t
        dl = [LT[:, k] + LT[:, 3 + k] * bu + LT[:, 6 + k] * bv - p[k]
              for k in range(3)]
        dist2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        inv_dist = 1.0 / dist
        dl = [x * inv_dist for x in dl]
        cos_l = -(dl[0] * LT[:, 9] + dl[1] * LT[:, 10] + dl[2] * LT[:, 11])
        pdf_l = torch.where(cos_l > 1e-6,
                            dist2 * LT[:, 13] / torch.clamp(cos_l, min=1e-6),
                            zero)
        cos_s = dl[0] * n_[0] + dl[1] * n_[1] + dl[2] * n_[2]
        nee_ok = act & (pdf_l > 0) & (cos_s > 0)
        occluded = _occluded(
            tables, [p[k] + n_[k] * eps for k in range(3)], dl,
            torch.where(nee_ok, dist * (1.0 - 1e-3), -big))
        pdf_bsdf_l = torch.clamp(cos_s, min=0.0) / _PI
        fcos = cos_s / _PI
        base = _mis(pdf_l, pdf_bsdf_l) / torch.clamp(pdf_l, min=1e-20)
        gate = nee_ok & ~occluded
        for c in range(3):
            res[c] = res[c] + torch.where(
                gate, thr_[c] * base * (alb[c] * fcos) * LT[:, 14 + c], zero)

        # cosine-weighted diffuse sample
        u_c1, u_c2 = _rng2(key, dim0 + 4)
        cx, cy = _concentric(u_c1, u_c2)
        cz = torch.sqrt(torch.clamp(1.0 - cx * cx - cy * cy, min=0.0))
        bsdf_pdf = cz / _PI
        nd = [cx * tx[k] + cy * ty[k] + cz * n_[k] for k in range(3)]
        thr = [thr_[c] * torch.where(act, alb[c], torch.ones_like(zero))
               for c in range(3)]
        active = (act & (cz > 0) & (bsdf_pdf > 0)
                  & (thr[0] + thr[1] + thr[2] > 0))
        # cz >= 0: the new ray leaves on the normal's side
        o = [p[k] + n_[k] * eps for k in range(3)]
        d = nd
        prev_pdf = bsdf_pdf
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
                            width, height, max_depth, rr_depth):
    """Plain PyTorch version of the path kernel -> (3, n) float32 per-lane
    radiance, n = width * height * spp_pass, on the tables' device.

    Vectorised over lanes with a Python loop over depth and a brute-force
    (lanes x faces) Woop test, in lane chunks that keep each (n, F)
    temporary within ``_CHUNK_ELEMS`` elements."""
    dev = tables.device
    n = width * height * spp_pass
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(tables.n_faces, 1))
    for start in range(0, n, step):
        lanes = torch.arange(start, min(n, start + step), device=dev)
        key, pixel = lane_keys(seed, sample_base, spp_pass, lanes)
        out[:, start:start + len(lanes)] = _trace_lanes(
            tables, cam, key, pixel, width, height, max_depth, rr_depth)
    return out


# ----------------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------------

def _check_tables(tables, cam):
    for name, t, cols in (("woop", tables.woop, 12),
                          ("fattr", tables.fattr, 12),
                          ("lights", tables.lights, 24)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"(rows, {cols}) tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != tables.device:
            raise ValueError(f"{name} is on {t.device}, not {tables.device}")
    if tables.fattr.shape[0] != tables.n_faces:
        raise ValueError("woop and fattr disagree on the face count")
    if cam.dtype != torch.float32 or cam.shape != (16,) \
            or cam.device != tables.device:
        raise ValueError("cam must be a float32 (16,) tensor on the "
                         "tables' device")
    if tables.n_faces > MAX_FACES:
        raise ValueError(f"{tables.n_faces} faces > {MAX_FACES}")


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
    render = _path_render()
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = render(
            tables.woop.data_ptr(), tables.fattr.data_ptr(),
            tables.lights.data_ptr(), cam.data_ptr(), out.data_ptr(),
            tables.n_faces, tables.lights.shape[0], seed & 0xFFFFFFFF,
            sample_base & 0xFFFFFFFF, spp_pass, width, height, max_depth,
            rr_depth, n, stream)
    if err != 0:
        raise RuntimeError(f"path_kernel launch failed: CUDA error {err}")
    path_radiance.launches += 1
    return out


path_radiance.launches = 0


def _path_render():
    """csrc/path_kernel.cu's C entry point, built on first use."""
    from .build import load
    fn = load("path_kernel").path_render
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_uint32] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
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


def path_kernel_ineligibility(scene):
    """-> None if the scene is inside the kernel's scope, else a short
    reason (megakernel.py:3076 megakernel_ineligibility, narrowed to this
    slice)."""
    from ..variants import current, variant
    from ..models.bsdfs import SmoothDiffuse
    from ..models.emitters import AreaEmitter
    from ..models.textures import ConstantTexture
    var = current()
    if not var.is_rgb or var.polarized or var.double_precision:
        return f"variant {variant()} (only scalar_rgb renders)"
    if not scene.shapes:
        return "no shapes"
    for sh in scene.shapes:
        if not sh.is_mesh():
            return f"non-triangle shape {type(sh).__name__}"
    if scene.tables.n_faces > MAX_FACES:
        return f"face count {scene.tables.n_faces} > {MAX_FACES}"
    for sh in scene.shapes:
        b = sh.bsdf
        if type(b) is not SmoothDiffuse:
            return f"unsupported BSDF {type(b).__name__}"
        if type(b.reflectance) is not ConstantTexture:
            return "textured diffuse reflectance"
    for e in scene.emitters:
        if type(e) is not AreaEmitter:
            return f"unsupported emitter {type(e).__name__}"
        if type(e.radiance) is not ConstantTexture:
            return "textured area emitter"
    return None
