"""Stanford PLY loader (parity: ``mitsuba2_tpu.utils.io_ply`` and
src/shapes/ply.cpp:1-786 — ascii +
binary little/big endian, vertex properties x/y/z, nx/ny/nz, u/v (or s/t),
polygon triangulation, and custom vertex attributes: consecutive
properties named {prefix}_{x|y|z|w} / _{r|g|b|a} / _{0..3} / _{1..4}
group into a multidimensional "vertex_{prefix}" attribute; bare
r/g/b/a or red/green/blue/alpha group into "vertex_color"
(ply.cpp:50-58). Integer-typed attributes normalize to [0, 1]."""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(filename: str):
    with open(filename, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{filename}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)| (list, cdt, dt, name)])
        cur = None
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("comment") or not line:
                continue
            tok = line.split()
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append(("list", _TYPES[tok[2]], _TYPES[tok[3]],
                                   tok[4]))
                else:
                    cur[2].append((tok[2], _TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        endian = {"binary_little_endian": "<", "binary_big_endian": ">",
                  "ascii": None}[fmt]
        data = {}
        if endian is None:
            # ascii
            for name, count, props in elements:
                rows = []
                for _ in range(count):
                    rows.append(f.readline().decode("ascii").split())
                data[name] = (rows, props)
        else:
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    # variable length — parse sequentially
                    entries = []
                    for _ in range(count):
                        row = []
                        for p in props:
                            if p[0] == "list":
                                cnt = np.frombuffer(
                                    f.read(np.dtype(p[1]).itemsize),
                                    endian + p[1])[0]
                                vals = np.frombuffer(
                                    f.read(int(cnt) * np.dtype(p[2]).itemsize),
                                    endian + p[2])
                                row.append(vals)
                            else:
                                row.append(np.frombuffer(
                                    f.read(np.dtype(p[1]).itemsize),
                                    endian + p[1])[0])
                        entries.append(row)
                    data[name] = (entries, props)
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(count * dt.itemsize), dt)
                    data[name] = (arr, props)

    # vertices
    rows, props = data["vertex"]
    names = [p[0] for p in props]
    if endian is None:
        arr = np.asarray(rows, np.float64)
        cols = {nm: arr[:, i] for i, nm in enumerate(names)}
    else:
        cols = {nm: np.asarray(rows[nm]) for nm in names}
    v = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    n = None
    if "nx" in cols:
        n = np.stack([cols["nx"], cols["ny"], cols["nz"]], -1).astype(np.float32)
    uv = None
    for ux, vx in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ux in cols:
            uv = np.stack([cols[ux], cols[vx]], -1).astype(np.float32)
            break

    # custom vertex attributes (ply.cpp:50-58 grouping rules)
    reserved = {"x", "y", "z", "nx", "ny", "nz", "u", "v", "s", "t",
                "texture_u", "texture_v"}
    prop_types = {q[0]: q[1] for q in props if q[0] != "list"}

    def _norm(nm):
        col = cols[nm].astype(np.float64)
        ty = prop_types.get(nm, "f4")
        if ty[0] in "iu":  # integer attribute: normalize to [0, 1]
            col = col / np.iinfo(np.dtype(ty)).max
        return col.astype(np.float32)

    _SUFFIX_SETS = (("x", "y", "z", "w"), ("r", "g", "b", "a"),
                    ("0", "1", "2", "3"), ("1", "2", "3", "4"))
    attrs = {}
    remaining = [nm for nm in names if nm not in reserved]
    # bare color names
    for group in (("r", "g", "b", "a"), ("red", "green", "blue", "alpha")):
        comps = [nm for nm in group if nm in remaining]
        if len(comps) >= 3:
            attrs["vertex_color"] = np.stack(
                [_norm(nm) for nm in comps], -1)
            remaining = [nm for nm in remaining if nm not in comps]
    consumed = set()
    for nm in list(remaining):
        if nm in consumed or "_" not in nm:
            continue
        prefix, suffix = nm.rsplit("_", 1)
        for suffixes in _SUFFIX_SETS:
            if suffix != suffixes[0]:
                continue
            comps = []
            for sfx in suffixes:
                cand = f"{prefix}_{sfx}"
                if cand in remaining and cand not in consumed:
                    comps.append(cand)
                else:
                    break
            if comps:
                attrs[f"vertex_{prefix}"] = np.stack(
                    [_norm(c) for c in comps], -1)
                consumed.update(comps)
                break
    for nm in remaining:
        if nm not in consumed:   # scalar custom attribute
            attrs[f"vertex_{nm}"] = _norm(nm)[:, None]

    # faces
    faces = []
    fkey = "face" if "face" in data else None
    if fkey:
        rows, props = data[fkey]
        if endian is None:
            for r in rows:
                cnt = int(r[0])
                ids = [int(x) for x in r[1:1 + cnt]]
                for k in range(1, cnt - 1):
                    faces.append([ids[0], ids[k], ids[k + 1]])
        else:
            li = [i for i, p in enumerate(props) if p[0] == "list"][0]
            for row in rows:
                ids = row[li]
                for k in range(1, len(ids) - 1):
                    faces.append([int(ids[0]), int(ids[k]), int(ids[k + 1])])
    f_arr = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    return v, f_arr, n, uv, attrs
