"""Binary .vol grids (reference: grid3d.cpp's VOL3 format; counterpart of
``mitsuba2_tpu.utils.vol``): 'VOL', version 3, encoding 1 (float32), the
resolution x, y, z, the channel count, the bounding box (6 float32) and
the values, x fastest."""

from __future__ import annotations

import struct

import numpy as np


def read_vol(filename: str):
    """-> (data (D, H, W, C) float32, bbox (6 floats)); the caller bakes
    the box into its to_world transform (grid3d semantics)."""
    with open(filename, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError(f"{filename}: not a .vol file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"unsupported .vol version {version}")
        encoding, = struct.unpack("<i", f.read(4))
        if encoding != 1:
            raise ValueError("only float32 .vol encoding supported")
        xres, yres, zres = struct.unpack("<iii", f.read(12))
        channels, = struct.unpack("<i", f.read(4))
        bbox = struct.unpack("<6f", f.read(24))
        data = np.frombuffer(f.read(xres * yres * zres * channels * 4),
                             "<f4")
        return data.reshape(zres, yres, xres, channels).copy(), bbox


def write_vol(filename: str, data, bbox=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)):
    """Writes a (D, H, W) or (D, H, W, C) grid."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    d, h, w, c = data.shape
    with open(filename, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<iii", w, h, d))
        f.write(struct.pack("<i", c))
        f.write(struct.pack("<6f", *bbox))
        f.write(data.astype("<f4").tobytes())
