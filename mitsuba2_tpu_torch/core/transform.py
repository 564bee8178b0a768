"""4x4 homogeneous transforms (reference: include/mitsuba/core/transform.h).

A Transform stores the matrix and its inverse-transpose as float32 numpy
arrays on the host. The factories build them in float64 and round once, as
the JAX package does; ``@`` composes in float32. Scene loading bakes
transforms into vertex positions and camera rows on the host, so no
transform ever has to live on the device.

``AnimatedTransform`` (transform.h:240+) decomposes its keyframes on the
host into scale, rotation quaternion and translation and interpolates
them at ``eval``, as the JAX package does.
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

    @staticmethod
    def orthographic(near, far) -> "Transform":
        return (Transform.scale([1.0, 1.0, 1.0 / (far - near)])
                @ Transform.translate([0.0, 0.0, -near]))

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

    def transform_normal(self, n):
        """Normals (..., 3) through the inverse transpose."""
        return n @ _device_matrix(self.inverse_transpose, n.device)[:3, :3].T

    def transform_ray(self, o, d):
        return self.transform_point(o), self.transform_vector(d)

    @property
    def translation(self):
        return self.matrix[:3, 3]

    def has_scale(self) -> bool:
        lin = self.matrix[:3, :3]
        return not np.allclose(lin @ lin.T, np.eye(3), atol=1e-5)


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _host_time(time) -> float:
    """A keyframe time from a number, or a one-element array or tensor."""
    if hasattr(time, "cpu"):
        time = time.detach().cpu()
    return float(np.asarray(time, np.float64).reshape(-1)[0])


class AnimatedTransform:
    """A keyframed transform (transform.h:240+): each keyframe decomposed
    on the host (float64, numpy) into a symmetric scale, a rotation
    quaternion and a translation by polar decomposition; ``eval(t)``
    lerps the scales and translations and slerps the quaternions between
    the two keyframes around ``t`` -> a Transform."""

    def __init__(self, base: Transform | None = None):
        self._base = base if base is not None else Transform.identity()
        self._times: list[float] = []
        self._scales: list[np.ndarray] = []
        self._quats: list[np.ndarray] = []
        self._trans: list[np.ndarray] = []

    def append(self, time: float, trafo: Transform) -> None:
        mat = np.asarray(trafo.matrix, np.float64)
        # polar decomposition A = R S
        U, s, Vt = np.linalg.svd(mat[:3, :3])
        R = U @ Vt
        if np.linalg.det(R) < 0:
            U[:, -1] *= -1
            s = s.copy()
            s[-1] *= -1
            R = U @ Vt
        self._times.append(float(time))
        self._scales.append(Vt.T @ np.diag(s) @ Vt)
        self._quats.append(_quat_from_matrix(R))
        self._trans.append(mat[:3, 3])

    @property
    def is_static(self) -> bool:
        return len(self._times) <= 1

    def eval(self, time) -> Transform:
        if not self._times:
            return self._base
        time = _host_time(time)
        times = np.asarray(self._times)
        if len(times) == 1 or time <= times[0]:
            idx0 = idx1 = 0
            t = 0.0
        elif time >= times[-1]:
            idx0 = idx1 = len(times) - 1
            t = 0.0
        else:
            idx1 = int(np.searchsorted(times, time, side="right"))
            idx0 = idx1 - 1
            t = (time - times[idx0]) / (times[idx1] - times[idx0])
        S = (1 - t) * self._scales[idx0] + t * self._scales[idx1]
        T = (1 - t) * self._trans[idx0] + t * self._trans[idx1]
        q0, q1 = self._quats[idx0], self._quats[idx1]
        d = float(np.dot(q0, q1))
        if d < 0:
            q1, d = -q1, -d
        if d > 0.9995:
            q = (1 - t) * q0 + t * q1
        else:
            th = np.arccos(np.clip(d, -1, 1))
            q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) \
                / np.sin(th)
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y)]])
        mat = np.eye(4)
        mat[:3, :3] = R @ S
        mat[:3, 3] = T
        return Transform.from_matrix(mat.astype(np.float32))

    def translation_bounds(self):
        pts = np.asarray(self._trans) if self._trans else np.zeros((1, 3))
        return pts.min(axis=0), pts.max(axis=0)
