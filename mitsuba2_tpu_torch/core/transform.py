"""4x4 homogeneous transforms (reference: include/mitsuba/core/transform.h).

A Transform stores the matrix and its inverse-transpose as float32 numpy
arrays on the host. The factories build them in float64 and round once, as
the JAX package does; ``@`` composes in float32. Scene loading bakes
transforms into vertex positions and camera rows on the host, so no
transform ever has to live on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Transform(NamedTuple):
    matrix: np.ndarray             # (4, 4) float32
    inverse_transpose: np.ndarray  # (4, 4) float32

    # ---- constructors -------------------------------------------------------
    @staticmethod
    def identity() -> "Transform":
        i = np.eye(4, dtype=np.float32)
        return Transform(i, i)

    @staticmethod
    def from_matrix(mat) -> "Transform":
        mat = np.asarray(mat, np.float32)
        inv_t = np.linalg.inv(mat).T.astype(np.float32)
        return Transform(mat, inv_t)

    @staticmethod
    def translate(v) -> "Transform":
        v = np.asarray(v, dtype=np.float64)
        mat = np.eye(4)
        mat[:3, 3] = v
        inv_t = np.eye(4)
        inv_t[3, :3] = -v
        return Transform(mat.astype(np.float32), inv_t.astype(np.float32))

    @staticmethod
    def scale(v) -> "Transform":
        v = np.broadcast_to(np.asarray(v, dtype=np.float64), (3,))
        mat = np.diag(np.concatenate([v, [1.0]]))
        inv_t = np.diag(np.concatenate([1.0 / v, [1.0]]))
        return Transform(mat.astype(np.float32), inv_t.astype(np.float32))

    @staticmethod
    def rotate(axis, angle_deg) -> "Transform":
        """Rotation around an axis, angle in degrees (transform.h rotate)."""
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        theta = np.deg2rad(float(angle_deg))
        s, c = np.sin(theta), np.cos(theta)
        x, y, z = axis
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R = np.eye(3) * c + (1 - c) * np.outer(axis, axis) + s * K
        mat = np.eye(4)
        mat[:3, :3] = R
        # rotation: the inverse-transpose is the matrix itself
        return Transform(mat.astype(np.float32), mat.astype(np.float32))

    @staticmethod
    def look_at(origin, target, up) -> "Transform":
        """Camera-to-world: +z toward target, +y ~ up (transform.h look_at)."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        dir_ = target - origin
        dir_ = dir_ / np.linalg.norm(dir_)
        left = np.cross(up / np.linalg.norm(up), dir_)
        left = left / np.linalg.norm(left)
        new_up = np.cross(dir_, left)
        mat = np.eye(4)
        mat[:3, 0] = left
        mat[:3, 1] = new_up
        mat[:3, 2] = dir_
        mat[:3, 3] = origin
        return Transform.from_matrix(mat.astype(np.float32))

    # ---- application --------------------------------------------------------
    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.matrix @ other.matrix,
                         self.inverse_transpose @ other.inverse_transpose)

    def inverse(self) -> "Transform":
        """Swaps the matrix and the transposed inverse (no arithmetic)."""
        return Transform(np.ascontiguousarray(self.inverse_transpose.T),
                         np.ascontiguousarray(self.matrix.T))
