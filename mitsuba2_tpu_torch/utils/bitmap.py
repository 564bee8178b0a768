"""Bitmap: an image container with pixel-format conversions (parity:
include/mitsuba/core/bitmap.h:21-60, src/libcore/bitmap.cpp and
``mitsuba2_tpu.utils.bitmap``): the pixel formats Y, YA, RGB, RGBA, XYZ
and XYZA, sRGB gamma, premultiplied alpha, ordered-dither LDR
quantization and an asynchronous write. Files go through the port's
utils/io_image.py (EXR and PFM in numpy, the 8-bit formats through PIL);
numpy takes the role of the reference's StructConverter.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from . import io_image

PIXEL_FORMATS = ("y", "ya", "rgb", "rgba", "xyz", "xyza")

# sRGB <-> XYZ (D65) matrices (bitmap.cpp conversion path)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_LUM = np.array([0.212671, 0.715160, 0.072169], np.float32)


_DITHER = None


def dither_matrix():
    """256x256 threshold matrix in [0, 1), each value once: the blue-noise
    rank table ``data/bluenoise256.npy`` (the JAX package's, the role of
    the reference's dither-matrix256.cpp)."""
    global _DITHER
    if _DITHER is None:
        rank = np.load(os.path.join(os.path.dirname(__file__), "..", "data",
                                    "bluenoise256.npy"))
        _DITHER = (rank.astype(np.float32) + 0.5) / rank.size
    return _DITHER


class Bitmap:
    """(bitmap.h:21) float32 image + pixel-format tag with conversions."""

    def __init__(self, data, pixel_format: str | None = None,
                 srgb_gamma: bool = False, channel_names=None):
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        self.data = data
        if pixel_format is None:
            pixel_format = {1: "y", 2: "ya", 3: "rgb", 4: "rgba"}.get(
                data.shape[-1], "multichannel")
        self.pixel_format = pixel_format
        self.srgb_gamma = srgb_gamma
        self.channel_names = channel_names

    # ---- metadata ---------------------------------------------------------
    @property
    def width(self):
        return self.data.shape[1]

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def channel_count(self):
        return self.data.shape[-1]

    def size(self):
        return (self.width, self.height)

    # ---- conversions (bitmap.cpp convert) ---------------------------------
    def _linear(self):
        d = self.data
        if self.srgb_gamma:
            rgb_ch = {"y": 1, "ya": 1, "rgb": 3, "rgba": 3}.get(
                self.pixel_format, d.shape[-1])
            d = d.copy()
            d[..., :rgb_ch] = io_image.srgb_to_linear(d[..., :rgb_ch])
        return d

    def convert(self, pixel_format: str, srgb_gamma: bool = False,
                premultiply_alpha: bool | None = None) -> "Bitmap":
        if pixel_format not in PIXEL_FORMATS:
            raise ValueError(f"unknown pixel format '{pixel_format}' "
                             f"(expected one of {PIXEL_FORMATS})")
        d = self._linear()
        src = self.pixel_format
        # decompose: color part + alpha
        alpha = None
        if src in ("ya", "rgba", "xyza"):
            alpha = d[..., -1:]
            d = d[..., :-1]
        # to linear rgb working space
        if src.startswith("y"):
            rgb = np.repeat(d[..., :1], 3, -1)
        elif src.startswith("xyz"):
            rgb = d @ _XYZ2RGB.T
        else:
            rgb = d[..., :3]
        # to destination color space
        if pixel_format.startswith("y"):
            out = (rgb @ _LUM)[..., None]
        elif pixel_format.startswith("xyz"):
            out = rgb @ _RGB2XYZ.T
        else:
            out = rgb
        if pixel_format in ("ya", "rgba", "xyza"):
            if alpha is None:
                alpha = np.ones(out.shape[:-1] + (1,), np.float32)
            if premultiply_alpha:
                out = out * alpha
            out = np.concatenate([out, alpha], -1)
        if srgb_gamma:
            ch = {"y": 1, "ya": 1}.get(pixel_format, 3)
            out = out.copy()
            out[..., :ch] = io_image.linear_to_srgb(
                np.clip(out[..., :ch], 0.0, 1.0))
        return Bitmap(out, pixel_format, srgb_gamma=srgb_gamma)

    def quantize(self, dither: bool = True) -> np.ndarray:
        """float [0,1] -> uint8 with ordered dithering (bitmap.cpp LDR
        quantization against the dither matrix)."""
        d = np.clip(self.data, 0.0, 1.0) * 255.0
        if dither:
            t = dither_matrix()
            h, w = d.shape[:2]
            ty = np.arange(h) % t.shape[0]
            tx = np.arange(w) % t.shape[1]
            d = d + (t[np.ix_(ty, tx)] - 0.5)[..., None]
        return np.clip(d + 0.5, 0, 255).astype(np.uint8)

    # ---- IO ---------------------------------------------------------------
    @staticmethod
    def read(filename: str) -> "Bitmap":
        return Bitmap(io_image.read_image(filename))

    def write(self, filename: str):
        ext = os.path.splitext(filename)[1].lower()
        if ext in (".exr", ".pfm"):
            io_image.write_image(filename, self._linear(),
                                 self.channel_names)
        elif ext in (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".ppm"):
            from PIL import Image
            bm = self if self.pixel_format in ("y", "rgb", "rgba") \
                else self.convert("rgb")
            d = bm._linear()
            d = io_image.linear_to_srgb(np.clip(d, 0.0, 1.0))
            arr = Bitmap(d, bm.pixel_format).quantize()
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            if ext in (".jpg", ".jpeg") and arr.ndim == 3 \
                    and arr.shape[-1] == 4:
                arr = arr[..., :3]
            kwargs = {"quality": 95} if ext in (".jpg", ".jpeg") else {}
            Image.fromarray(arr).save(filename, **kwargs)
        else:
            raise ValueError(f"unsupported image format {ext}")

    def write_async(self, filename: str) -> threading.Thread:
        """(bitmap.h write_async — used between optimizer iterations so
        disk IO overlaps the next render)."""
        t = threading.Thread(target=self.write, args=(filename,),
                             daemon=True)
        t.start()
        return t

    def __repr__(self):
        return (f"Bitmap[{self.width}x{self.height}, "
                f"{self.pixel_format}, srgb_gamma={self.srgb_gamma}]")
