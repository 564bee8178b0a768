"""4x4 homogeneous transforms (reference: include/mitsuba/core/transform.h).

A Transform stores the matrix and its inverse-transpose as float32 numpy
arrays on the host. The factories build them in float64 and round once, as
the JAX package does; ``@`` composes in float32. Scene loading bakes
transforms into vertex positions and camera rows on the host, so no
transform ever has to live on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import weakref

import numpy as np

# each matrix's copy on a device, made at its first use there (a copy from
# the host at every call would wait for the device's stream); an entry
# goes with its array
_DEVICE_MATRICES = {}


def _device_matrix(arr, device):
    import torch
    key = (id(arr), str(device))
    if key not in _DEVICE_MATRICES:
        _DEVICE_MATRICES[key] = torch.as_tensor(arr, device=device)
        weakref.finalize(arr, _DEVICE_MATRICES.pop, key, None)
    return _DEVICE_MATRICES[key]


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

    @staticmethod
    def perspective(fov_deg, near, far) -> "Transform":
        """Projection onto the z = 1 image plane (transform.h
        perspective)."""
        recip = 1.0 / (far - near)
        cot = 1.0 / np.tan(np.deg2rad(float(fov_deg)) * 0.5)
        mat = np.array([[cot, 0, 0, 0], [0, cot, 0, 0],
                        [0, 0, far * recip, -near * far * recip],
                        [0, 0, 1, 0]], dtype=np.float64)
        return Transform.from_matrix(mat.astype(np.float32))

    # ---- application --------------------------------------------------------
    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.matrix @ other.matrix,
                         self.inverse_transpose @ other.inverse_transpose)

    def inverse(self) -> "Transform":
        """Swaps the matrix and the transposed inverse (no arithmetic)."""
        return Transform(np.ascontiguousarray(self.inverse_transpose.T),
                         np.ascontiguousarray(self.matrix.T))

    def transform_point(self, p):
        """Points (..., 3), a torch tensor, through the matrix with the
        homogeneous divide."""
        mat = _device_matrix(self.matrix, p.device)
        out = p @ mat[:3, :3].T + mat[:3, 3]
        return out / (p @ mat[3, :3] + mat[3, 3])[..., None]

    def transform_vector(self, v):
        return v @ _device_matrix(self.matrix, v.device)[:3, :3].T
