"""Image reading by file extension (role of Bitmap's format zoo,
bitmap.cpp:21-60; counterpart of ``mitsuba2_tpu.utils.io_image``): OpenEXR
through utils/io_exr.py, PFM and Radiance RGBE in numpy, and the 8-bit
formats (PNG, JPEG, ...) through PIL where it imports, decoded from sRGB to
linear; and writing by extension (``write_image``): EXR, PFM, and the
8-bit formats through PIL, encoded to sRGB. Without PIL an 8-bit image
raises an error that names it."""

from __future__ import annotations

import os

import numpy as np


def write_pfm(filename: str, image) -> None:
    """(h, w, 3) or (h, w) float image -> a little-endian PFM file (rows
    stored bottom-up)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    with open(filename, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(img[..., :3] if c >= 3 else img[..., 0])
                .astype("<f4").tobytes())


def read_pfm(filename: str) -> np.ndarray:
    """A PFM file -> (h, w, c) float32, top row first; the scale's sign
    gives the byte order."""
    with open(filename, "rb") as f:
        c = 3 if f.readline().strip() == b"PF" else 1
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
        return np.flipud(data.reshape(h, w, c)).astype(np.float32)


def _read_rgbe(filename: str) -> np.ndarray:
    """A Radiance RGBE (.hdr) file, flat or run-length encoded scanlines
    -> (h, w, 3) float32 (mantissa * 2^(exponent - 136))."""
    with open(filename, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError(f"{filename!r} is not an RGBE file")
        while f.readline().strip():
            pass
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            lead = f.read(4)
            if lead[0] == 2 and lead[1] == 2 and (lead[2] << 8 | lead[3]) == w:
                for c in range(4):
                    x = 0
                    while x < w:
                        n = f.read(1)[0]
                        if n > 128:
                            data[y, x:x + n - 128, c] = f.read(1)[0]
                            x += n - 128
                        else:
                            data[y, x:x + n, c] = np.frombuffer(f.read(n),
                                                                np.uint8)
                            x += n
            else:
                row = lead + f.read(4 * w - 4)
                data[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
    scale = np.ldexp(1.0, data[..., 3].astype(np.int32) - 136)
    return data[..., :3].astype(np.float32) * scale.astype(np.float32)[
        ..., None]


def srgb_to_linear(x):
    """The sRGB transfer curve inverted, on values clamped below at 0."""
    x = np.maximum(x, 0.0)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4)).astype(np.float32)


def linear_to_srgb(x):
    """The sRGB transfer curve, on values clamped below at 0."""
    x = np.maximum(x, 0.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.power(np.maximum(x, 1e-12), 1.0 / 2.4)
                    - 0.055).astype(np.float32)


def write_png(filename: str, image) -> None:
    """An LDR image through PIL: values clamped to [0, 1], encoded by the
    sRGB curve, rounded to 8 bits."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"writing {filename!r} needs the PIL package (Pillow), which is "
            "not installed; EXR and PFM write without it") from e
    img = linear_to_srgb(np.clip(np.asarray(image, np.float32), 0.0, 1.0))
    arr = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(filename)


def write_image(filename: str, image, channel_names=None) -> None:
    """An image (numpy or a torch tensor on any device) to a file by its
    extension (Bitmap::write; ``mitsuba2_tpu.utils.io_image.write_image``):
    OpenEXR, PFM, or an 8-bit format through PIL."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".exr":
        from .io_exr import write_exr
        write_exr(filename, image, channel_names)
    elif ext == ".pfm":
        write_pfm(filename, image)
    elif ext in (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".ppm"):
        write_png(filename, image)
    else:
        raise ValueError(f"unsupported image format {ext}")


def read_image(filename: str) -> np.ndarray:
    """-> (h, w, c) float32 image: EXR and PFM as stored, RGBE decoded,
    8-bit formats scaled to [0, 1] and decoded from sRGB."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".exr":
        from .io_exr import read_exr
        img, _ = read_exr(filename)
        return img
    if ext == ".pfm":
        return read_pfm(filename)
    if ext in (".hdr", ".rgbe"):
        return _read_rgbe(filename)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {filename!r} ({ext or 'no extension'}) needs the PIL "
            "package (Pillow), which is not installed; EXR, PFM and RGBE "
            "read without it") from e
    img = np.asarray(Image.open(filename), np.float32) / 255.0
    return srgb_to_linear(img)
