"""Shape plugins (reference: src/shapes/ — rectangle, sphere, disk,
cylinder, obj and serialized; the cube is composed of rectangles in the
reference's scene assets and is a plugin here).

Rectangle and cube are flat triangle meshes with the same vertices, faces,
winding and normals as ``mitsuba2_tpu.models.shapes``. The sphere is an
analytic quadric that the scene packs into its sphere table; disk and
cylinder are analytic quadrics intersected in their canonical object frame,
packed into the scene's quad table (``prim_row``). Each becomes a triangle
mesh only where the reference tessellates it too. ``obj``, ``ply`` and
``serialized`` load triangle meshes from files (utils/io_obj.py,
utils/io_ply.py, utils/serialized.py), with ``face_normals`` and
``to_world``, and ``serialized`` with ``shape_index``; a PLY file's extra
vertex properties become mesh attributes. ``blender`` reads a mesh from
Blender's memory through raw pointers. ``shapegroup`` holds shapes to be
instanced and renders nothing itself; an ``instance`` places a group
under a transform, as transformed copies of its meshes (small groups) or
as one row of the scene's instance table over the group's one packed copy
(render/scene.py).
"""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
from ..core.properties import Properties
from ..core.transform import Transform
from ..render.shape import Mesh, Shape


def _get_to_world(props) -> Transform:
    if props is not None and props.has_property("to_world"):
        return props.transform("to_world")
    return Transform.identity()


@register_plugin("shape", "rectangle")
class RectangleShape(Mesh):
    """(rectangle.cpp) unit rectangle in the xy-plane spanning [-1,1]^2,
    normal +z. Exact as a 2-triangle mesh."""

    def __init__(self, props=None):
        v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        flip = props.bool_("flip_normals", False) if props else False
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name="rectangle")
        self.apply_transform(_get_to_world(props))
        if flip:
            self.faces = self.faces[:, ::-1].copy()
            self.normals = -self.normals


@register_plugin("shape", "cube")
class CubeShape(Mesh):
    """Axis-aligned [-1,1]^3 cube, flat shaded."""

    def __init__(self, props=None):
        vs, fs, ns, uvs = [], [], [], []
        idx = 0
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                n = np.zeros(3, np.float32)
                n[axis] = sgn
                u = np.zeros(3, np.float32)
                u[(axis + 1) % 3] = 1.0
                v = np.cross(n, u)
                c = n  # face center
                quad = [c - u - v, c + u - v, c + u + v, c - u + v]
                vs.extend(quad)
                ns.extend([n] * 4)
                uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
                if sgn > 0:
                    fs.extend([[idx, idx + 1, idx + 2],
                               [idx, idx + 2, idx + 3]])
                else:
                    fs.extend([[idx, idx + 2, idx + 1],
                               [idx, idx + 3, idx + 2]])
                idx += 4
        ns = np.asarray(ns, np.float32)
        fs = np.asarray(fs, np.int32)
        super().__init__(props, vertices=np.asarray(vs, np.float32),
                         faces=fs, normals=None,
                         uvs=np.asarray(uvs, np.float32), name="cube")
        # fix winding so geometric normals match stored normals
        p = self.vertices[self.faces]
        gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        face_n = ns[self.faces[:, 0]]
        flip = (gn * face_n).sum(-1) < 0
        self.faces[flip] = self.faces[flip][:, ::-1]
        self.normals = ns
        self.face_normals_only = True  # flat shading
        self.apply_transform(_get_to_world(props))


def _sphere_mesh(radius=1.0, center=(0, 0, 0), n_theta=32, n_phi=64):
    """UV-sphere triangle mesh -> (vertices, faces, normals, uvs), the
    tessellation of mitsuba2_tpu.models.shapes._sphere_mesh."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                    np.cos(T)], -1).reshape(-1, 3)
    uv = np.stack([P / (2 * np.pi), 1.0 - T / np.pi], -1).reshape(-1, 2)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([b, c, d])
    v = pts * radius + np.asarray(center, np.float32)
    return (v.astype(np.float32), np.asarray(faces, np.int32),
            pts.astype(np.float32), uv.astype(np.float32))


def _attach(shape, mesh):
    """``mesh``, the tessellation of ``shape``, with its BSDF, emitter,
    sensor and media, the emitter and sensor re-pointed at it."""
    mesh.bsdf = shape.bsdf
    mesh.emitter = shape.emitter
    mesh.sensor = shape.sensor
    mesh.interior_medium = shape.interior_medium
    mesh.exterior_medium = shape.exterior_medium
    if shape.emitter is not None:
        shape.emitter.set_shape(mesh)
    if shape.sensor is not None and hasattr(shape.sensor, "set_shape"):
        shape.sensor.set_shape(mesh)
    return mesh


@register_plugin("shape", "sphere")
class SphereShape(Shape):
    """(sphere.cpp) analytic sphere: ``center``, ``radius``, ``to_world``
    (a uniform scale folds into the radius) and ``flip_normals``. The scene
    intersects it exactly through its sphere table. ``expand`` turns it
    into a triangle mesh where it carries an emitter (area sampling runs on
    triangle tables) or where ``to_world`` scales it non-uniformly."""

    def __init__(self, props=None, center=(0, 0, 0), radius=1.0):
        p = props or Properties("sphere")
        super().__init__(p)
        radius = p.float_("radius", radius)
        center = np.asarray(p.get("center", center), np.float32).reshape(3)
        self._res = int(p.int_("resolution_hint", 64))
        self.flip_normals = p.bool_("flip_normals", False)
        tw = _get_to_world(props)
        lin = np.asarray(tw.matrix)[:3, :3]
        scales = np.linalg.norm(lin, axis=0)
        self._uniform = bool(np.allclose(scales, scales[0], rtol=1e-4))
        self.center = (lin @ center + np.asarray(tw.matrix)[:3, 3]).astype(
            np.float32)
        self.radius = float(radius * scales[0])
        self._to_world = tw
        self._orig = (center, radius)

    def is_analytic(self):
        return True

    def expand(self):
        if self.emitter is not None or self.sensor is not None \
                or not self._uniform:
            return [self._tessellate()]
        return [self]

    def _tessellate(self) -> Mesh:
        c0, r0 = self._orig
        v, f, n, uv = _sphere_mesh(r0, c0, self._res // 2, self._res)
        mesh = Mesh(None, vertices=v, faces=f, normals=n, uvs=uv,
                    name="sphere")
        mesh.apply_transform(self._to_world)
        if self.flip_normals:
            mesh.faces = mesh.faces[:, ::-1].copy()
            mesh.normals = -mesh.normals
        return _attach(self, mesh)

    def surface_area(self) -> float:
        return 4.0 * np.pi * self.radius ** 2

    def bbox(self):
        return self.center - self.radius, self.center + self.radius


class _AnalyticQuadric(Shape):
    """Base of the quadrics other than the sphere (disk, cylinder): a world
    ray transforms into the canonical object frame through the packed
    to_object matrix (disk.cpp:146-166, cylinder.cpp:243-291;
    mitsuba2_tpu.models.shapes._AnalyticQuadric). ``expand`` tessellates a
    quadric that carries an emitter (area sampling runs on triangle
    tables)."""

    QUAD_KIND = 0.0

    def __init__(self, props):
        super().__init__(props)
        self._res = int(props.int_("resolution_hint", 64))
        self.flip_normals = props.bool_("flip_normals", False)

    def is_analytic(self):
        return True

    def expand(self):
        # an emitter or a sensor samples the shape's triangle tables
        if self.emitter is not None or self.sensor is not None:
            return [self._tessellate()]
        return [self]

    def prim_row(self) -> np.ndarray:
        """24 float32: [A rows 0:9 | b 9:12 | B rows 12:21 | kind 21 |
        radius 22 | length 23]; A is the to_object linear part, b its
        translation, B the to_world linear part; kind 1 disk, 2 cylinder."""
        return np.concatenate([
            self._A.reshape(9), self._b.reshape(3), self._B.reshape(9),
            np.asarray([self.QUAD_KIND, getattr(self, "radius", 1.0),
                        getattr(self, "length", 1.0)], np.float32)]
        ).astype(np.float32)


@register_plugin("shape", "disk")
class DiskShape(_AnalyticQuadric):
    """(disk.cpp:85-225) the unit disk z = 0 in object space under an
    arbitrary affine ``to_world`` (ellipses included), ``flip_normals``."""

    QUAD_KIND = 1.0

    def __init__(self, props=None):
        p = props or Properties("disk")
        super().__init__(p)
        tw = _get_to_world(props)
        M = np.asarray(tw.matrix, np.float64)
        A = np.linalg.inv(M[:3, :3])
        self._B = M[:3, :3].astype(np.float32)
        self._A = A.astype(np.float32)
        self._b = (-A @ M[:3, 3]).astype(np.float32)
        self._to_world = tw

    def surface_area(self) -> float:
        """The ellipse's area pi |dp_du| h, h the height of dp_dv over
        dp_du's axis (disk.cpp:85-110)."""
        M = np.asarray(self._to_world.matrix, np.float64)
        du = float(np.linalg.norm(M[:3, 0]))
        dv = float(np.linalg.norm(M[:3, 1]))
        s_axis = self._B[:, 0] / max(du, 1e-20)
        h = np.sqrt(max(dv ** 2 - float(np.dot(self._B[:, 1], s_axis)) ** 2,
                        0.0))
        return float(np.pi * du * h)

    def bbox(self):
        M = np.asarray(self._to_world.matrix, np.float64)
        pts = np.asarray([[x, y, 0.0, 1.0] for x in (-1, 1)
                          for y in (-1, 1)]) @ M.T
        return (pts[:, :3].min(0).astype(np.float32),
                pts[:, :3].max(0).astype(np.float32))

    def _tessellate(self) -> Mesh:
        res = self._res
        ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
        rim = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], -1)
        v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
        f = np.asarray([[0, 1 + i, 1 + (i + 1) % res] for i in range(res)],
                       np.int32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
        mesh = Mesh(None, vertices=v, faces=f, normals=n,
                    uvs=0.5 * (v[:, :2] + 1.0), name="disk")
        mesh.apply_transform(self._to_world)
        return _attach(self, mesh)


@register_plugin("shape", "cylinder")
class CylinderShape(_AnalyticQuadric):
    """(cylinder.cpp:83-390) the open cylinder of ``radius`` from ``p0``
    to ``p1``: to_world composed with translate(p0), the axis frame
    (Duff et al.'s basis, so uv phases follow the reference) and
    scale(radius, radius, length); radius and length are then taken back
    out and the rigid rest packs into the quad table."""

    QUAD_KIND = 2.0

    def __init__(self, props=None):
        p = props or Properties("cylinder")
        super().__init__(p)
        radius = p.float_("radius", 1.0)
        p0 = np.asarray(p.get("p0", [0, 0, 0]), np.float64).reshape(3)
        p1 = np.asarray(p.get("p1", [0, 0, 1]), np.float64).reshape(3)
        M = np.asarray(_get_to_world(props).matrix, np.float64).copy()
        axis = p1 - p0
        ln = np.linalg.norm(axis)
        az = axis / max(ln, 1e-12)
        sgn = 1.0 if az[2] >= 0 else -1.0
        a_ = -1.0 / (sgn + az[2])
        b_ = az[0] * az[1] * a_
        L = np.eye(4)
        L[:3, 0] = np.asarray([1.0 + sgn * az[0] * az[0] * a_, sgn * b_,
                               -sgn * az[0]]) * radius
        L[:3, 1] = np.asarray([b_, sgn + az[1] * az[1] * a_,
                               -az[1]]) * radius
        L[:3, 2] = az * ln
        L[:3, 3] = p0
        M = M @ L
        sx, sy, sz = np.linalg.norm(M[:3, :3], axis=0)
        self.radius = float(0.5 * (sx + sy))
        self.length = float(sz)
        R = np.stack([M[:3, 0] / max(sx, 1e-20), M[:3, 1] / max(sy, 1e-20),
                      M[:3, 2] / max(sz, 1e-20)], axis=1)
        self._B = R.astype(np.float32)
        self._A = R.T.astype(np.float32)
        self._b = (-R.T @ M[:3, 3]).astype(np.float32)
        Mw = np.eye(4)
        Mw[:3, :3] = R
        Mw[:3, 3] = M[:3, 3]
        self._to_world_rigid = Transform.from_matrix(Mw.astype(np.float32))

    def surface_area(self) -> float:
        return float(2.0 * np.pi * self.radius * self.length)

    def bbox(self):
        B = self._B.astype(np.float64)
        x = np.sqrt((B[:, 0] * self.radius) ** 2
                    + (B[:, 1] * self.radius) ** 2)
        q0 = -self._A.T.astype(np.float64) @ self._b
        q1 = q0 + B[:, 2] * self.length
        return (np.minimum(q0 - x, q1 - x).astype(np.float32),
                np.maximum(q0 + x, q1 + x).astype(np.float32))

    def _tessellate(self) -> Mesh:
        res = self._res
        ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
        ring = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)],
                        -1) * self.radius
        v = np.concatenate([ring, ring + np.asarray(
            [0, 0, self.length])]).astype(np.float32)
        n = np.concatenate([ring, ring]).astype(np.float32)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        uv = np.concatenate([
            np.stack([ph / (2 * np.pi), np.zeros_like(ph)], -1),
            np.stack([ph / (2 * np.pi), np.ones_like(ph)], -1)]
        ).astype(np.float32)
        faces = []
        for i in range(res):
            a, b = i, (i + 1) % res
            faces += [[a, b, res + a], [b, res + b, res + a]]
        if self.flip_normals:
            faces = [f[::-1] for f in faces]
            n = -n
        mesh = Mesh(None, vertices=v, faces=np.asarray(faces, np.int32),
                    normals=n, uvs=uv, name="cylinder")
        mesh.apply_transform(self._to_world_rigid)
        return _attach(self, mesh)


@register_plugin("shape", "obj")
class OBJShape(Mesh):
    """(obj.cpp:1-354) Wavefront OBJ mesh: ``filename`` (through the file
    resolver, as the reference's), ``face_normals`` (drop the file's
    vertex normals), ``to_world``."""

    def __init__(self, props=None):
        from ..core.fresolver import file_resolver
        from ..utils.io_obj import load_obj
        filename = file_resolver().resolve(props.string("filename"))
        v, f, n, uv = load_obj(filename)
        if props.bool_("face_normals", False):
            n = None
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name=filename)
        self.apply_transform(_get_to_world(props))


@register_plugin("shape", "serialized")
class SerializedShape(Mesh):
    """(serialized.cpp:1-374) Mitsuba 0.x .serialized mesh: ``filename``
    (through the file resolver), ``shape_index``, ``face_normals``,
    ``to_world``."""

    def __init__(self, props=None):
        from ..core.fresolver import file_resolver
        from ..utils.serialized import load_serialized
        filename = file_resolver().resolve(props.string("filename"))
        v, f, n, uv = load_serialized(filename,
                                      props.int_("shape_index", 0))
        if props.bool_("face_normals", False):
            n = None
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name=filename)
        self.apply_transform(_get_to_world(props))


@register_plugin("shape", "ply")
class PLYShape(Mesh):
    """(ply.cpp:1-786) Stanford PLY mesh: ``filename`` (through the file
    resolver), ``face_normals``,
    ``to_world``; the file's extra vertex properties become mesh
    attributes (ply.cpp:180-267), which ``mesh_attribute`` textures
    read."""

    def __init__(self, props=None):
        from ..core.fresolver import file_resolver
        from ..utils.io_ply import load_ply
        filename = file_resolver().resolve(props.string("filename"))
        face_normals = props.bool_("face_normals", False)
        v, f, n, uv, attrs = load_ply(filename)
        if face_normals:
            n = None
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name=filename)
        for name, data in attrs.items():
            self.add_attribute(name, data.shape[1], data)
        self.apply_transform(_get_to_world(props))


@register_plugin("shape", "shapegroup")
class ShapeGroup(Mesh):
    """(shapegroup.cpp, shapegroup.h:15) a named collection of shapes to
    be instanced; it renders nothing itself (``expand`` gives no shape).
    Its analytic children are tessellated: an instance places triangle
    meshes."""

    def __init__(self, props=None):
        self.children = []
        if props is not None:
            for _, obj in props.objects():
                if getattr(obj, "plugin_category", "") == "shape":
                    if obj.is_analytic():
                        obj = obj._tessellate()
                    self.children.append(obj)
        super().__init__(props, vertices=np.zeros((0, 3), np.float32),
                         faces=np.zeros((0, 3), np.int32), name="shapegroup")

    def expand(self):
        return []


# an instance of a group of at most this many faces materializes
# transformed copies of the group's meshes by default (they ride the path
# kernel); a larger group is shared: one packed copy in the scene and a
# transform row an instance, its memory O(1) in the instance count
# (mitsuba2_tpu/models/shapes.py:452)
INSTANCE_MATERIALIZE_FACES = 65536


@register_plugin("shape", "instance")
class Instance(Mesh):
    """(instance.cpp) a shapegroup placed under ``to_world``. With
    ``materialize`` true, or absent and a group of at most
    ``INSTANCE_MATERIALIZE_FACES`` faces, ``expand`` gives transformed
    copies of the group's meshes; otherwise the instance itself, which the
    scene packs as one row of its instance table: ``_A`` and ``_b`` take
    a world point into the group's frame (float32 of a float64 inverse),
    ``_B`` a tangent back to the world."""

    def __init__(self, props=None):
        group = None
        if props is not None:
            for _, obj in props.objects():
                if isinstance(obj, ShapeGroup):
                    group = obj
        if group is None:
            raise RuntimeError("instance requires a shapegroup reference")
        self.group = group
        self.to_world = _get_to_world(props)
        self.materialize = None
        if props is not None and props.has_property("materialize"):
            self.materialize = props.bool_("materialize")
        super().__init__(props, vertices=np.zeros((0, 3), np.float32),
                         faces=np.zeros((0, 3), np.int32), name="instance")
        M = np.asarray(self.to_world.matrix, np.float64)
        A = np.linalg.inv(M[:3, :3])
        self._A = A.astype(np.float32)
        self._b = (-A @ M[:3, 3]).astype(np.float32)
        self._B = M[:3, :3].astype(np.float32)

    def is_instance(self):
        return True

    def group_face_count(self):
        return sum(len(c.faces) for c in self.group.children
                   if c.is_mesh())

    def _materialized(self):
        import copy
        out = []
        for child in self.group.children:
            if not child.is_mesh():
                continue
            dup = copy.copy(child)
            dup.vertices = child.vertices.copy()
            dup.faces = child.faces.copy()
            dup.normals = None if child.normals is None \
                else child.normals.copy()
            dup.apply_transform(self.to_world)
            out.append(dup)
        return out

    def expand(self):
        if self.materialize is True:
            return self._materialized()
        if self.materialize is False:
            return [self]
        if self.group_face_count() <= INSTANCE_MATERIALIZE_FACES:
            return self._materialized()
        return [self]


# ---- the Blender bridge -----------------------------------------------------
# Blender 2.8x mesh struct layouts (blender.cpp:9-46); the exporter add-on
# passes raw pointers to them as integer properties
_ML_LOOP = np.dtype([("v", "<u4"), ("e", "<u4")])
_ML_LOOPTRI = np.dtype([("tri", "<u4", 3), ("poly", "<u4")])
_M_POLY = np.dtype([("loopstart", "<i4"), ("totloop", "<i4"),
                    ("mat_nr", "<i2"), ("flag", "i1"), ("pad", "i1")])
_M_VERT = np.dtype([("co", "<f4", 3), ("no", "<i2", 3),
                    ("flag", "i1"), ("bweight", "i1")])
_ML_LOOPUV = np.dtype([("uv", "<f4", 2), ("flag", "<i4")])
_ML_LOOPCOL = np.dtype([("r", "u1"), ("g", "u1"), ("b", "u1"), ("a", "u1")])
_ME_SMOOTH = 1


def _read_ptr(ptr: int, count: int, dtype: np.dtype) -> np.ndarray:
    """A copy of ``count`` records of ``dtype`` at address ``ptr`` (the
    reinterpret_casts of blender.cpp:105-118)."""
    import ctypes
    if count == 0 or ptr == 0:
        return np.zeros(0, dtype)
    buf = (ctypes.c_char * (int(count) * dtype.itemsize)).from_address(
        int(ptr))
    return np.frombuffer(buf, dtype=dtype, count=int(count)).copy()


@register_plugin("shape", "blender")
class BlenderMesh(Mesh):
    """(blender.cpp:60-325) a mesh read from Blender's memory: MLoop,
    MLoopTri, MPoly and MVert pointers (and optional MLoopUV and MLoopCol
    layers) as integer properties, filtered to one material slot
    (``mat_nr``), degenerate flat faces culled, flat or smooth shading per
    face; corners that share a Blender vertex, a shading key and a uv
    become one vertex (one ``np.unique`` over the corner rows, the
    reference's per-vertex hash chain). uv v is flipped; vertex colors go
    from sRGB bytes to linear attributes."""

    def __init__(self, props=None):
        from ..utils.io_image import srgb_to_linear
        p = props
        name = p.string("name")
        mat_nr = p.int_("mat_nr")
        vert_count = p.int_("vert_count")
        tri_count = p.int_("loop_tri_count")
        loop_count = p.int_("loop_count", 0)
        loops = _read_ptr(p.long_("loops"), loop_count or 3 * tri_count,
                          _ML_LOOP)
        tris = _read_ptr(p.long_("loop_tris"), tri_count, _ML_LOOPTRI)
        n_polys = int(tris["poly"].max()) + 1 if tri_count else 0
        polys = _read_ptr(p.long_("polys"), n_polys, _M_POLY)
        verts = _read_ptr(p.long_("verts"), vert_count, _M_VERT)
        has_uvs = p.has_property("uvs")
        uvs = _read_ptr(p.long_("uvs"), len(loops), _ML_LOOPUV) \
            if has_uvs else None
        col_layers = [(k, _read_ptr(p.long_(k), len(loops), _ML_LOOPCOL))
                      for k in p.property_names() if k.startswith("vertex_")]
        to_world = _get_to_world(props)

        # the material filter (blender.cpp:190), then the degenerate cull
        face_poly = tris["poly"].astype(np.int64)
        keep = polys["mat_nr"][face_poly] == mat_nr
        tris = tris[keep]
        face_poly = face_poly[keep]
        corner_loop = tris["tri"].astype(np.int64)          # (f, 3)
        corner_vert = loops["v"][corner_loop].astype(np.int64)
        M = np.asarray(to_world.matrix)
        Mit = np.asarray(to_world.inverse_transpose)
        pos = verts["co"][corner_vert]                      # (f, 3, 3)
        pos = pos @ M[:3, :3].T + M[:3, 3]
        fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        fn_len = np.linalg.norm(fn, axis=-1)
        smooth = (polys["flag"][face_poly] & _ME_SMOOTH) != 0
        good = smooth | (fn_len > 0)                        # blender.cpp:212
        tris, face_poly, corner_loop, corner_vert, pos, fn, fn_len, smooth \
            = (a[good] for a in (tris, face_poly, corner_loop, corner_vert,
                                 pos, fn, fn_len, smooth))
        f = len(tris)

        # corner normals: a flat face's normal, or the vertex normal
        # (int16 / 32767 in Blender, blender.cpp:231)
        flat_n = fn / np.maximum(fn_len, 1e-20)[:, None]
        vn = verts["no"].astype(np.float32) / 32767.0
        vn = vn @ Mit[:3, :3].T
        vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
        corner_n = np.where(smooth[:, None, None],
                            vn[corner_vert], flat_n[:, None, :])

        corner_uv = np.zeros((f, 3, 2), np.float32)
        if has_uvs:
            corner_uv = uvs["uv"][corner_loop].copy()
            corner_uv[..., 1] = 1.0 - corner_uv[..., 1]     # blender.cpp:243

        # corner de-duplication (blender.cpp:153-176 Key): one vertex for
        # the same Blender vertex, shading key (smooth, or the same flat
        # polygon) and uv
        shade_key = np.where(smooth, -1, face_poly)
        key = np.zeros((f * 3, 5), np.float64)
        key[:, 0] = corner_vert.ravel()
        key[:, 1] = np.repeat(shade_key, 3)
        key[:, 2] = np.repeat(smooth.astype(np.int64), 3)
        key[:, 3:] = corner_uv.reshape(-1, 2)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        faces = inverse.reshape(f, 3).astype(np.int32)
        v_out = pos.reshape(-1, 3)[first].astype(np.float32)
        n_out = corner_n.reshape(-1, 3)[first].astype(np.float32)
        uv_out = corner_uv.reshape(-1, 2)[first] if has_uvs else None

        super().__init__(props, vertices=v_out, faces=faces, normals=n_out,
                         uvs=uv_out, name=name)
        # vertex colors: sRGB bytes in Blender (blender.cpp:277)
        for lname, cols in col_layers:
            c = np.stack([cols["r"], cols["g"], cols["b"]], -1)
            c = srgb_to_linear(c.astype(np.float32) / 255.0)
            self.add_attribute(lname, 3, c[corner_loop.ravel()][first])
