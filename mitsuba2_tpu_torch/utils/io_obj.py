"""Wavefront OBJ loader (parity: src/shapes/obj.cpp:1-354 and
``mitsuba2_tpu.utils.io_obj``: positions, normals, uvs, negative indices,
fan triangulation of polygons)."""

from __future__ import annotations

import numpy as np


def load_obj(filename: str):
    """-> (vertices (V,3), faces (F,3), normals (V,3)|None, uvs (V,2)|None).

    Vertices are unified per unique (v, vt, vn) triple like the reference."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    uvs: list[list[float]] = []
    vertex_map: dict[tuple, int] = {}
    out_v: list[list[float]] = []
    out_n: list[list[float]] = []
    out_uv: list[list[float]] = []
    faces: list[list[int]] = []
    has_n = False
    has_uv = False

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def vertex_id(token: str) -> int:
        nonlocal has_n, has_uv
        parts = token.split("/")
        vi = resolve(int(parts[0]), len(positions))
        ti = ni = -1
        if len(parts) > 1 and parts[1]:
            ti = resolve(int(parts[1]), len(uvs))
            has_uv = True
        if len(parts) > 2 and parts[2]:
            ni = resolve(int(parts[2]), len(normals))
            has_n = True
        key = (vi, ti, ni)
        vid = vertex_map.get(key)
        if vid is None:
            vid = len(out_v)
            vertex_map[key] = vid
            out_v.append(positions[vi])
            out_uv.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
            out_n.append(normals[ni] if ni >= 0 else [0.0, 0.0, 0.0])
        return vid

    with open(filename, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(tok[1]), float(tok[2]) if len(tok) > 2
                            else 0.0])
            elif tok[0] == "f":
                ids = [vertex_id(t) for t in tok[1:]]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append([ids[0], ids[k], ids[k + 1]])

    v = np.asarray(out_v, np.float32)
    f = np.asarray(faces, np.int32)
    n = np.asarray(out_n, np.float32) if has_n else None
    if n is not None:
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), n)
    uv = np.asarray(out_uv, np.float32) if has_uv else None
    return v, f, n, uv
