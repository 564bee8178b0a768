"""Image reading by file extension (role of Bitmap's format zoo,
bitmap.cpp:21-60). The port reads OpenEXR so far; every other format
raises ``NotImplementedError`` naming it."""

from __future__ import annotations

import os

import numpy as np


def read_image(filename: str) -> np.ndarray:
    """-> (h, w, c) float32 image (``mitsuba2_tpu.utils.io_image.read_image``
    for ``.exr``)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".exr":
        from .io_exr import read_exr
        img, _ = read_exr(filename)
        return img
    raise NotImplementedError(
        f"image format {ext or '(none)'!r} of {filename!r} is not ported "
        "(only .exr reads)")
