"""Mitsuba 0.x .serialized mesh container (parity: src/shapes/serialized.cpp
and ``mitsuba2_tpu.utils.serialized``: 0x041C magic, zlib-deflated
per-mesh streams, end-of-file offset table). Needs only struct and zlib."""

from __future__ import annotations

import struct
import zlib

import numpy as np

MF_PER_VERTEX_NORMALS = 0x0001
MF_TEXCOORDS = 0x0002
MF_VERTEX_COLORS = 0x0008
MF_FACE_NORMALS = 0x0010
MF_SINGLE_PRECISION = 0x1000
MF_DOUBLE_PRECISION = 0x2000


def load_serialized(filename: str, shape_index: int = 0):
    """Mesh ``shape_index`` of a .serialized file -> (vertices (V,3),
    faces (F,3) int32, normals (V,3)|None, uvs (V,2)|None), float32."""
    with open(filename, "rb") as f:
        magic, version = struct.unpack("<HH", f.read(4))
        if magic != 0x041C:
            raise ValueError(f"{filename}: bad .serialized magic")
        f.seek(0, 2)
        end = f.tell()
        # trailer: uint32 mesh count + per-mesh uint64 offsets (v>=4)
        f.seek(end - 4)
        (count,) = struct.unpack("<I", f.read(4))
        if shape_index >= count:
            raise ValueError(f"shape_index {shape_index} >= {count}")
        f.seek(end - 4 - 8 * count + 8 * shape_index)
        (offset,) = struct.unpack("<Q", f.read(8))
        f.seek(offset)
        magic2, version = struct.unpack("<HH", f.read(4))
        comp = f.read(end - 4 - 8 * count - offset - 4)
    data = zlib.decompress(comp)
    pos = 0

    def take(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        out = struct.unpack_from("<" + fmt, data, pos)
        pos += size
        return out

    (flags,) = take("I")
    if version >= 4:
        # null-terminated utf-8 name
        endn = data.index(b"\x00", pos)
        name = data[pos:endn].decode("utf-8", "replace")
        pos = endn + 1
    (n_vert,) = take("Q")
    (n_tri,) = take("Q")
    dt = np.float32 if flags & MF_SINGLE_PRECISION else np.float64

    def arr(n, dtype):
        nonlocal pos
        nonlocal data
        nbytes = n * np.dtype(dtype).itemsize
        out = np.frombuffer(data[pos:pos + nbytes], dtype)
        pos += nbytes
        return out

    v = arr(n_vert * 3, dt).reshape(-1, 3).astype(np.float32)
    n = None
    uv = None
    if flags & MF_PER_VERTEX_NORMALS:
        n = arr(n_vert * 3, dt).reshape(-1, 3).astype(np.float32)
    if flags & MF_TEXCOORDS:
        uv = arr(n_vert * 2, dt).reshape(-1, 2).astype(np.float32)
    if flags & MF_VERTEX_COLORS:
        arr(n_vert * 3, dt)  # parsed but unused (parity: loaded as attr)
    faces = arr(n_tri * 3, np.uint32).reshape(-1, 3).astype(np.int32)
    return v, faces, n, uv


def write_serialized(filename: str, meshes):
    """Write meshes = [(v, f, n, uv), ...] (n and uv may be None) as a
    version-4 .serialized file, single precision."""
    offsets = []
    with open(filename, "wb") as fp:
        for (v, f, n, uv) in meshes:
            offsets.append(fp.tell())
            flags = MF_SINGLE_PRECISION
            if n is not None:
                flags |= MF_PER_VERTEX_NORMALS
            if uv is not None:
                flags |= MF_TEXCOORDS
            payload = struct.pack("<I", flags)
            payload += b"mesh\x00"
            payload += struct.pack("<QQ", len(v), len(f))
            payload += np.asarray(v, np.float32).tobytes()
            if n is not None:
                payload += np.asarray(n, np.float32).tobytes()
            if uv is not None:
                payload += np.asarray(uv, np.float32).tobytes()
            payload += np.asarray(f, np.uint32).tobytes()
            fp.write(struct.pack("<HH", 0x041C, 4))
            fp.write(zlib.compress(payload))
        for off in offsets:
            fp.write(struct.pack("<Q", off))
        fp.write(struct.pack("<I", len(meshes)))
