"""Texture plugins: the constant color the scene loaders create for rgb
values (xml.cpp:774-850, src/spectra/srgb.cpp), the uv checkerboard
(checkerboard.cpp), the bilinear image texture (bitmap.cpp) and the mesh
attribute (mesh_attribute.cpp).

A constant color carries the payload of the variant it was loaded under
(mitsuba2_tpu.models.textures._SpectrumData): linear rgb, the sigmoid
model's coefficients in spectral variants (render/srgb.py), the luminance
in mono variants. ``eval(si)`` gives the wavefront each lane's value in
that variant: (n, 3) rgb, (n, 4) at the lane's hero wavelengths, or
(n, 1); the payload moves to the lanes' device once and stays there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum as spec
from ..core.object import register_plugin
from ..core.properties import Properties
from ..render.texture import Texture

_LUMINANCE = np.asarray([0.212671, 0.715160, 0.072169], np.float64)


def on_device(obj, name, array, device):
    """``array`` as a float32 tensor on ``device``, cached on ``obj`` under
    ``name`` so that each device receives it once. A tensor (a value a
    differentiable render bound, python/util.py ``ParameterMap.bind``)
    passes through uncached, its autograd graph kept."""
    if isinstance(array, torch.Tensor):
        return array.to(device=device, dtype=torch.float32)
    cache = obj.__dict__.setdefault("_device_cache", {})
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(array, np.float32),
                                     device=device)
    return cache[key]


def is_traced(value):
    """Whether ``value`` is a tensor a differentiable render traces (it
    requires grad): such a value is installed as it is, and the payloads
    derived from a value on the host keep their old contents, as the JAX
    package keeps them for a tracer (mitsuba2_tpu/models/
    textures.py:104-110, :228-238)."""
    return isinstance(value, torch.Tensor) and value.requires_grad


def host_value(value):
    """``value`` as a host numpy array (a tensor detached and copied)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def bilinear_taps(uv, w, h):
    """The four texels around each lane's uv on a (w, h) texture, repeat
    wrap, texel centers at half-integers (bitmap.cpp): [(weight, flat
    texel index)] in the order (u0, v0), (u1, v0), (u0, v1), (u1, v1)."""
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    iu0 = torch.remainder(u0.to(torch.int32), w).long()
    iv0 = torch.remainder(v0.to(torch.int32), h).long()
    iu1 = torch.remainder(iu0 + 1, w)
    iv1 = torch.remainder(iv0 + 1, h)
    return [((1 - fu) * (1 - fv), iv0 * w + iu0),
            (fu * (1 - fv), iv0 * w + iu1),
            ((1 - fu) * fv, iv1 * w + iu0),
            (fu * fv, iv1 * w + iu1)]


def mono_luminance(rgb):
    """float32 luminance of linear rgb values (..., 3), the mono
    variants' value of a color."""
    w = spec.LUMINANCE
    rgb = np.asarray(rgb, np.float32)
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]


@register_plugin("texture", "srgb")
class ConstantTexture(Texture):
    """Uniform linear-rgb color, held on the host as float32, with its
    variant payload: ``coeff`` in spectral variants, ``mono`` in mono
    variants."""

    def __init__(self, props=None, color=None):
        super().__init__(props)
        if color is None:
            color = props.get("color", props.get("value", 0.5))
        self._set_color(color)

    def _set_color(self, color):
        from ..variants import current
        color = np.asarray(host_value(color), np.float32)
        if color.ndim == 0:
            color = np.broadcast_to(color, (3,)).copy()
        self.rgb = color
        var = current()
        self.coeff = self.mono = None
        if var.is_spectral:
            from ..render.srgb import srgb_model_fetch
            self.coeff = np.asarray(srgb_model_fetch(color), np.float32)
        elif var.is_monochromatic:
            self.mono = mono_luminance(color)

    def traverse(self, cb):
        cb.put_parameter("value", self.rgb)

    # the differentiable leaf is the rgb value: a traced value reaches
    # eval in rgb variants only, the spectral and mono payloads keep the
    # last concrete value's (mitsuba2_tpu/models/textures.py:97-110)
    PARAM_ATTRS = {"value": "rgb"}

    def set_parameter(self, name, value):
        super().set_parameter(name, value)
        if name == "value" and not is_traced(value):
            self._set_color(value)

    def payload(self) -> np.ndarray:
        """(3,) float32 the path kernel reads: rgb, the spectral
        coefficients, or the luminance repeated."""
        if self.coeff is not None:
            return self.coeff
        if self.mono is not None:
            return np.full(3, self.mono, np.float32)
        return self.rgb

    def mean(self):
        return float(np.asarray(host_value(self.rgb), np.float64)
                     @ _LUMINANCE)

    def eval(self, si, active=True):
        """The color at every lane of ``si``, in the variant's channels."""
        n, dev = si.t.shape[0], si.t.device
        if self.coeff is not None:
            from ..render.srgb import srgb_model_eval
            return srgb_model_eval(on_device(self, "coeff", self.coeff, dev),
                                   si.wavelengths)
        if self.mono is not None:
            return on_device(self, "mono", [self.mono], dev).expand(n, 1)
        return on_device(self, "rgb", self.rgb, dev).expand(n, 3)

    def eval_1(self, si, active=True):
        """The color's luminance at every lane (n,), taken on the host."""
        return torch.full_like(si.t, self.mean())

    def eval_3(self, si, active=True):
        """The linear rgb color at every lane (n, 3)."""
        return on_device(self, "rgb", self.rgb, si.t.device).expand(
            si.t.shape[0], 3)


@register_plugin("texture", "checkerboard")
class CheckerboardTexture(Texture):
    """(checkerboard.cpp) ``color0`` where floor(u) + floor(v) is even,
    ``color1`` where it is odd, after the optional affine ``to_uv``."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props or Properties("checkerboard")
        self.color0 = as_texture(p.get("color0", 0.4))
        self.color1 = as_texture(p.get("color1", 0.2))
        self.to_uv = p.transform("to_uv") if p.has_property("to_uv") \
            else None

    def eval(self, si, active=True):
        """The color at the lanes of ``si`` in the variant's channels; or,
        given a (..., 2) uv tensor, (..., 3) linear rgb (constant colors,
        the ones the path kernel takes)."""
        if isinstance(si, torch.Tensor):
            even = self._even(si)
            c0 = on_device(self, "color0", self.color0.rgb, si.device)
            c1 = on_device(self, "color1", self.color1.rgb, si.device)
            return torch.where(even[..., None], c0, c1)
        return torch.where(self._even(si.uv)[..., None],
                           self.color0.eval(si, active),
                           self.color1.eval(si, active))

    def eval_1(self, si, active=True):
        return torch.where(self._even(si.uv), self.color0.eval_1(si, active),
                           self.color1.eval_1(si, active))

    def eval_3(self, si, active=True):
        return torch.where(self._even(si.uv)[..., None],
                           self.color0.eval_3(si, active),
                           self.color1.eval_3(si, active))

    def _even(self, uv):
        """Where floor(u) + floor(v) is even, after ``to_uv``."""
        if self.to_uv is not None:
            mat = on_device(self, "to_uv", self.to_uv.matrix, uv.device)
            uvw = torch.cat([uv, torch.zeros_like(uv[..., :1])], -1)
            out = uvw @ mat[:3, :3].T + mat[:3, 3]
            w = uvw @ mat[3, :3] + mat[3, 3]
            uv = (out / w[..., None])[..., :2]
        par = (torch.floor(uv[..., 0]).to(torch.int64)
               + torch.floor(uv[..., 1]).to(torch.int64)) % 2
        return par == 0

    def mean(self):
        return 0.5 * (self.color0.mean() + self.color1.mean())

    def is_spatially_varying(self):
        return True


@register_plugin("texture", "bitmap")
class BitmapTexture(Texture):
    """(bitmap.cpp) an image texture, bilinearly filtered with repeat
    wrap: ``filename`` (read through utils/io_image.py) or ``data`` (h, w,
    c), and ``raw``, kept as the reference keeps it (it selects no other
    decoding). One channel is repeated to three, alpha dropped. ``rgb`` is
    the (h, w, 3) float32 image, ``resolution`` (w, h); ``payload`` holds
    what the path kernel reads per texel in the variant the texture was
    loaded under (mitsuba2_tpu.models.textures.BitmapTexture and
    megakernel.py:2386-2395): rgb, the sigmoid model's coefficients in
    spectral variants (upsampled per texel at load, as bitmap.cpp does), or
    the luminance in mono variants."""

    def __init__(self, props=None, data=None, raw=False):
        super().__init__(props)
        from ..variants import current
        if data is None:
            from ..utils.io_image import read_image
            data = read_image(props.string("filename"))
            raw = props.bool_("raw", False)
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        self.resolution = (data.shape[1], data.shape[0])
        self.raw = bool(raw)
        self._set_texels(data)

    def _set_texels(self, data):
        from ..variants import current
        self.rgb = np.ascontiguousarray(data[..., :3])
        var = current()
        if var.is_spectral:
            from ..render.srgb import srgb_model_fetch
            self.payload = np.asarray(srgb_model_fetch(self.rgb), np.float32)
        elif var.is_monochromatic:
            self.payload = np.repeat(mono_luminance(self.rgb)[..., None], 3,
                                     -1)
        else:
            self.payload = self.rgb

    def traverse(self, cb):
        cb.put_parameter("data", self.rgb.reshape(-1, 3))

    def get_parameter(self, name):
        if name == "data":
            return self.rgb.reshape(-1, 3)
        return super().get_parameter(name)

    def set_parameter(self, name, value):
        """``data`` is the (h * w, 3) texels, row-major (the JAX bitmap's
        ``_rgb_flat``): a concrete value re-derives the variant payload,
        a traced one replaces rgb and, in rgb variants, the payload
        (mitsuba2_tpu/models/textures.py:223-238)."""
        if name != "data":
            return super().set_parameter(name, value)
        from ..variants import current
        w, h = self.resolution
        if is_traced(value):
            super().set_parameter("rgb", value.reshape(h, w, 3))
            if current().is_rgb:
                self.payload = self.rgb
        else:
            super().set_parameter("rgb", np.asarray(
                host_value(value), np.float32).reshape(h, w, 3))
            self._set_texels(self.rgb)
        self._version = getattr(self, "_version", 0) + 1

    def mean(self):
        return float(np.mean(mono_luminance(host_value(self.rgb))))

    def is_spatially_varying(self):
        return True

    def eval(self, si, active=True):
        """Bilinear lookup at the lanes' uv (``bilinear_taps``;
        mitsuba2_tpu.models.textures.BitmapTexture._bilinear): rgb, mono
        luminance, or in spectral variants the four texels' sigmoid
        spectra at the hero wavelengths, blended."""
        from ..variants import current
        var = current()
        flat = self.payload.reshape(-1, 3)
        if var.is_monochromatic:
            flat = flat[:, :1]
        table = on_device(self, "payload", flat, si.t.device)
        out = 0.0
        for wt, idx in bilinear_taps(si.uv, *self.resolution):
            val = table[idx]
            if var.is_spectral:
                from ..render.srgb import srgb_model_eval
                val = srgb_model_eval(val, si.wavelengths)
            out = out + wt[..., None] * val
        return out

    def eval_3(self, si, active=True):
        """Bilinear lookup of the linear rgb texels (n, 3), whatever the
        variant (a ``raw`` normal map's channels)."""
        table = on_device(self, "rgb", self.rgb.reshape(-1, 3), si.t.device)
        taps = bilinear_taps(si.uv, *self.resolution)
        out = taps[0][0][..., None] * table[taps[0][1]]
        for wt, idx in taps[1:]:
            out = out + wt[..., None] * table[idx]
        return out

    def eval_1(self, si, active=True):
        """The luminance of ``eval_3`` (a height or opacity map)."""
        return spec.luminance(self.eval_3(si, active))


@register_plugin("texture", "mesh_attribute")
class MeshAttributeTexture(Texture):
    """(mesh_attribute.cpp; mitsuba2_tpu/models/textures.py:240-327) a
    named per-vertex or per-face mesh attribute (``vertex_*``/``face_*``,
    ``Mesh.add_attribute``), times ``scale``. The scene wires in its
    (F, 3k) corner table; ``eval`` gathers each lane's face row and
    interpolates the corners with the hit's barycentrics. A 3-channel
    attribute is a linear rgb color: in spectral variants each corner is
    upsampled through the sRGB model, then the spectra are interpolated;
    in mono variants its luminance. A 1-channel attribute repeats over
    the variant's channels."""

    def __init__(self, props=None, name=None, scale=1.0):
        super().__init__(props)
        if props is not None:
            name = props.string("name")
            scale = props.float_("scale", 1.0)
        self.name = name or "vertex_color"
        self.scale = scale
        self._k = None
        self._table = None     # (F, 3k) float32 on the host
        self._coeff = None     # (F, 9) sigmoid coefficients a corner

    def wire(self, scene):
        if self.name not in scene.mesh_attr_tables:
            raise RuntimeError(
                f"mesh_attribute '{self.name}': no mesh in the scene "
                f"carries this attribute")
        self._k, self._table = scene.mesh_attr_tables[self.name]
        self.__dict__.pop("_device_cache", None)
        self._coeff = None
        from ..variants import current
        if self._k == 3 and current().is_spectral:
            from ..render.srgb import srgb_model_fetch
            self._coeff = np.asarray(srgb_model_fetch(
                self._table.reshape(-1, 3)), np.float32).reshape(-1, 9)

    def _interp_raw(self, si):
        """The attribute at each lane (n, k)."""
        from ..render.scene import corner_lerp
        if self._k is None:
            raise RuntimeError("mesh_attribute texture was never wired "
                               "into a scene")
        table = on_device(self, "table", self._table, si.t.device)
        return corner_lerp(table, si, self._k)

    def eval(self, si, active=True):
        from ..variants import current
        var = current()
        if self._coeff is not None:
            from ..render.scene import corner_lerp
            from ..render.srgb import srgb_model_eval
            coeff = on_device(self, "coeff", self._coeff, si.t.device)
            return corner_lerp(coeff, si, 3, lambda c: srgb_model_eval(
                c, si.wavelengths)) * self.scale
        v = self._interp_raw(si)
        if self._k == 3 and var.is_monochromatic:
            v = spec.luminance(v)[..., None]
        elif self._k == 1:
            v = v.expand(-1, var.n_channels)
        return v * self.scale

    def eval_1(self, si, active=True):
        v = self._interp_raw(si)
        if self._k == 3:
            return spec.luminance(v) * self.scale
        return v[..., 0] * self.scale

    def eval_3(self, si, active=True):
        v = self._interp_raw(si)
        if self._k == 1:
            v = v.expand(-1, 3)
        return v * self.scale

    def mean(self):
        if self._k == 3:
            rgb = self._table.reshape(-1, 3).mean(0)
            return float(rgb @ _LUMINANCE) * self.scale
        return float(np.mean(self._table)) * self.scale

    def is_spatially_varying(self):
        return True


def as_texture(v, within_emitter: bool = False) -> Texture:
    """Auto-wrap scalars, colors and spectra into textures
    (properties.h:281-343, xml.cpp:774-850;
    mitsuba2_tpu.models.textures.as_texture). With ``within_emitter`` in
    spectral variants an rgb value becomes an ``SRGBD65Spectrum``, a
    uniform spectrum a ``D65Spectrum`` of that scale (xml.cpp:1100-1104)
    and a curve's values are scaled to unit luminance (xml.cpp:
    1113-1125). A uniform spectrum is otherwise a ``UniformSpectrum``, a
    curve an ``IrregularSpectrum``."""
    from ..core.dictio import ColorValue
    from ..variants import current
    emitter_spectrum = within_emitter and current().is_spectral
    if isinstance(v, Texture):
        return v
    if isinstance(v, ColorValue):
        if v.kind == "spectrum-uniform":
            if emitter_spectrum:
                from .spectra import D65Spectrum
                return D65Spectrum(scale=v.payload)
            from .spectra import UniformSpectrum
            return UniformSpectrum(value=v.payload)
        if v.kind == "spectrum-curve":
            from .spectra import IrregularSpectrum
            wl = [a for a, _ in v.payload]
            vals = [b for _, b in v.payload]
            if emitter_spectrum:
                vals = [x * spec.MTS_CIE_Y_NORMALIZATION for x in vals]
            return IrregularSpectrum(wavelengths=wl, values=vals)
        v = v.payload
    if isinstance(v, (int, float, list, tuple, np.ndarray)):
        if emitter_spectrum:
            from .spectra import SRGBD65Spectrum
            return SRGBD65Spectrum(color=v)
        return ConstantTexture(color=v)
    raise TypeError(f"cannot interpret {type(v)} as a texture")
