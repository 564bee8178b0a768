"""Shape plugins (reference: src/shapes/ — rectangle; the cube is composed
of rectangles in the reference's scene assets and is a plugin here).

Both are flat triangle meshes with the same vertices, faces, winding and
normals as ``mitsuba2_tpu.models.shapes``.
"""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
from ..core.transform import Transform
from ..render.shape import Mesh


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
