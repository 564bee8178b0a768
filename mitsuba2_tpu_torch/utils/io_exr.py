"""Minimal OpenEXR reader/writer (role of the reference's OpenEXR dependency
in Bitmap, bitmap.cpp — scanline images, half/float, ZIP or no compression).

Implements only what the framework needs: RGB(A) / arbitrary-channel float16/
float32 scanline images. Format per the public OpenEXR file layout spec.
Numpy only, byte for byte the codec of ``mitsuba2_tpu.utils.io_exr``: a file
either package writes, the other reads to the same float32 values.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2

_COMP_NONE = 0
_COMP_ZIP = 3  # 16-scanline zip blocks
_COMP_ZIPS = 2  # 1-scanline zip


def _write_attr(f, name: bytes, type_: bytes, payload: bytes):
    f.write(name + b"\x00" + type_ + b"\x00")
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)


def write_exr(filename: str, image: np.ndarray, channel_names=None,
              half: bool = True):
    """Write (h, w, c) or (h, w) float array as a zip-compressed scanline
    EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 2: ["Y", "A"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}.get(c) or \
            [f"channel.{i}" for i in range(c)]
    pixel_type = _HALF if half else _FLOAT
    np_dtype = np.float16 if half else np.float32

    # channels are stored alphabetically within each scanline
    order = np.argsort(np.asarray(channel_names))
    with open(filename, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))  # magic, version 2
        # channel list
        chl = b""
        for i in order:
            chl += channel_names[i].encode() + b"\x00"
            chl += struct.pack("<iiii", pixel_type, 0, 1, 1)
        chl += b"\x00"
        _write_attr(f, b"channels", b"chlist", chl)
        _write_attr(f, b"compression", b"compression",
                    struct.pack("<b", _COMP_ZIP))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, b"dataWindow", b"box2i", box)
        _write_attr(f, b"displayWindow", b"box2i", box)
        _write_attr(f, b"lineOrder", b"lineOrder", struct.pack("<b", 0))
        _write_attr(f, b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        _write_attr(f, b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        n_blocks = (h + 15) // 16
        blocks = []
        for bi in range(n_blocks):
            y0 = bi * 16
            rows = img[y0:y0 + 16]
            raw = b""
            for y in range(rows.shape[0]):
                for i in order:
                    raw += rows[y, :, i].astype("<" + np.dtype(np_dtype).str[1:]).tobytes()
            comp = _exr_zip_compress(raw)
            if len(comp) >= len(raw):
                comp = raw
            blocks.append((y0, comp))
        # offset table
        offset_pos = f.tell()
        table_size = 8 * n_blocks
        pos = offset_pos + table_size
        for y0, comp in blocks:
            f.write(struct.pack("<Q", pos))
            pos += 4 + 4 + len(comp)
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)


def _exr_zip_compress(raw: bytes) -> bytes:
    # EXR zip: delta-predict after byte-interleave split
    arr = np.frombuffer(raw, np.uint8)
    half_ = (len(arr) + 1) // 2
    inter = np.empty_like(arr)
    inter[:half_] = arr[0::2]
    inter[half_:] = arr[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + (-128 + 256)
    out = (d & 0xFF).astype(np.uint8)
    return zlib.compress(out.tobytes(), 6)


def _exr_zip_decompress(data: bytes, expected: int) -> bytes:
    # inverse of the predictor: t[i] = (t[i-1] + s[i] + 128) mod 256,
    # then undo the half-split byte interleave (OpenEXR ImfZip semantics)
    s = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    t = np.cumsum(np.concatenate([[s[0]], s[1:] + 128]), dtype=np.int64) % 256
    inter = t.astype(np.uint8)
    half_ = (len(inter) + 1) // 2
    out = np.empty(len(inter), np.uint8)
    out[0::2] = inter[:half_]
    out[1::2] = inter[half_:]
    return out.tobytes()


def read_exr(filename: str):
    """-> (image (h, w, c) float32, channel names list)."""
    with open(filename, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{filename}: not an EXR file")
        if version & 0x200:
            raise ValueError("tiled EXR not supported")
        attrs = {}
        while True:
            name = _read_cstr(f)
            if name == b"":
                break
            type_ = _read_cstr(f)
            size = struct.unpack("<i", f.read(4))[0]
            attrs[name.decode()] = (type_.decode(), f.read(size))
        # channels
        chdata = attrs["channels"][1]
        channels = []
        off = 0
        while chdata[off] != 0:
            end = chdata.index(b"\x00", off)
            nm = chdata[off:end].decode()
            pt, _, xs, ys = struct.unpack("<iiii", chdata[end + 1:end + 17])
            channels.append((nm, pt))
            off = end + 17
        comp = struct.unpack("<b", attrs["compression"][1][:1])[0]
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        lines_per_block = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}.get(comp)
        if lines_per_block is None:
            raise ValueError(f"unsupported EXR compression {comp}")
        n_blocks = (h + lines_per_block - 1) // lines_per_block
        offsets = struct.unpack(f"<{n_blocks}Q", f.read(8 * n_blocks))
        img = np.zeros((h, w, len(channels)), np.float32)
        dtypes = {_HALF: np.float16, _FLOAT: np.float32}
        for bi in range(n_blocks):
            f.seek(offsets[bi])
            yy, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            ny = min(lines_per_block, y1 - yy + 1)
            raw_size = sum(ny * w * np.dtype(dtypes[pt]).itemsize
                           for _, pt in channels)
            if comp in (_COMP_ZIP, _COMP_ZIPS) and size != raw_size:
                data = _exr_zip_decompress(data, raw_size)
            off = 0
            for y in range(ny):
                for ci, (nm, pt) in enumerate(channels):
                    dt = dtypes[pt]
                    nbytes = w * np.dtype(dt).itemsize
                    row = np.frombuffer(data[off:off + nbytes], dt)
                    img[yy - y0 + y, :, ci] = row.astype(np.float32)
                    off += nbytes
        names = [nm for nm, _ in channels]
        # reorder alphabetical storage to RGB(A) if applicable
        want = [n for n in ["R", "G", "B", "A"] if n in names]
        if want and len(want) == len(names):
            idx = [names.index(n) for n in want]
            img = img[..., idx]
            names = want
        return img, names


def _read_cstr(f) -> bytes:
    out = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return out
        out += c
