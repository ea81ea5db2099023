"""SE(3) / quaternion / axis-angle math — host-side float64 (numpy).

This is the bookkeeping library used by the imperative shell (pose state
machine, file codecs). The jit-compiled device twin lives in
slam3d_gx_tpu.ops.lie (float32, batched).

Parity notes:
- quaternions are TUM/g2o order (qx, qy, qz, qw);
- set_estimate_data / get_estimate_data mirror g2o VertexSE3's 7-double
  (x y z qx qy qz qw) interface (reference src/GraphicEnd.h:159-160,
  src/generateTrajectory.cpp:67);
- euler_angles_zxz reproduces Eigen's eulerAngles(2,0,2) exactly, including
  its sign/range conventions, because the reference odometry remap keys off
  it (reference src/GraphicEnd.h:161-169);
- motion_norm / motion_norm2 are the two keyframe-decision formulas
  (reference src/GraphicEnd.cpp:618 and src/GraphicEnd2.cpp:292).
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray


def identity() -> Array:
    return np.eye(4, dtype=np.float64)


# ---------------------------------------------------------------------------
# quaternion <-> rotation matrix (TUM order: qx, qy, qz, qw)
# ---------------------------------------------------------------------------

def quat_to_rot(q: Array) -> Array:
    """Unit quaternion (qx,qy,qz,qw) -> 3x3 rotation matrix."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    if n < np.finfo(np.float64).eps:
        return np.eye(3)
    s = 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def rot_to_quat(R: Array) -> Array:
    """3x3 rotation matrix -> unit quaternion (qx,qy,qz,qw), qw >= 0."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    q /= np.linalg.norm(q)
    if q[3] < 0:  # canonical sign, matches g2o's normalize()
        q = -q
    return q


# ---------------------------------------------------------------------------
# axis-angle (Rodrigues) <-> rotation matrix
# ---------------------------------------------------------------------------

def rodrigues(rvec: Array) -> Array:
    """Axis-angle vector -> rotation matrix (OpenCV Rodrigues semantics)."""
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def inv_rodrigues(R: Array) -> Array:
    """Rotation matrix -> axis-angle vector, theta in [0, pi]."""
    R = np.asarray(R, dtype=np.float64)
    cos_theta = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near pi: axis from the symmetric part
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs using off-diagonals
        i = int(np.argmax(axis))
        if axis[i] > 0:
            for j in range(3):
                if j != i and A[i, j] < 0:
                    axis[j] = -axis[j]
        axis /= np.linalg.norm(axis)
        return axis * theta
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (theta / (2.0 * np.sin(theta)))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def make_isometry(R: Array, t: Array) -> Array:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t, dtype=np.float64).reshape(3)
    return T


def inverse(T: Array) -> Array:
    R = T[:3, :3]
    t = T[:3, 3]
    return make_isometry(R.T, -R.T @ t)


def transform_points(T: Array, pts: Array) -> Array:
    pts = np.asarray(pts)
    return pts @ T[:3, :3].T + T[:3, 3]


def set_estimate_data(data7) -> Array:
    """g2o VertexSE3::setEstimateData: (x y z qx qy qz qw) -> 4x4."""
    d = np.asarray(data7, dtype=np.float64).reshape(7)
    q = d[3:7] / np.linalg.norm(d[3:7])
    return make_isometry(quat_to_rot(q), d[:3])


def get_estimate_data(T: Array) -> Array:
    """g2o VertexSE3::getEstimateData: 4x4 -> (x y z qx qy qz qw)."""
    q = rot_to_quat(T[:3, :3])
    return np.concatenate([T[:3, 3], q])


# ---------------------------------------------------------------------------
# Eigen eulerAngles clone (needed by the odometry remap)
# ---------------------------------------------------------------------------

def euler_angles(R: Array, a0: int, a1: int, a2: int) -> Array:
    """Reimplementation of Eigen::MatrixBase::eulerAngles(a0,a1,a2).

    Only the proper-Euler branch (a0 == a2) is needed by the reference
    (it calls eulerAngles(2,0,2) at src/GraphicEnd.h:161); the Tait-Bryan
    branch is included for completeness.
    """
    R = np.asarray(R, dtype=np.float64)
    res = np.zeros(3)
    odd = 0 if ((a0 + 1) % 3 == a1) else 1
    i = a0
    j = (a0 + 1 + odd) % 3
    k = (a0 + 2 - odd) % 3
    if a0 == a2:
        res[0] = np.arctan2(R[j, i], R[k, i])
        if (odd and res[0] < 0.0) or ((not odd) and res[0] > 0.0):
            res[0] = res[0] - np.pi if res[0] > 0.0 else res[0] + np.pi
            s2 = np.hypot(R[j, i], R[k, i])
            res[1] = -np.arctan2(s2, R[i, i])
        else:
            s2 = np.hypot(R[j, i], R[k, i])
            res[1] = np.arctan2(s2, R[i, i])
        s1, c1 = np.sin(res[0]), np.cos(res[0])
        res[2] = np.arctan2(c1 * R[j, k] - s1 * R[k, k], c1 * R[j, j] - s1 * R[k, j])
    else:
        res[0] = np.arctan2(R[j, k], R[k, k])
        c2 = np.hypot(R[i, i], R[i, j])
        if (odd and res[0] < 0.0) or ((not odd) and res[0] > 0.0):
            res[0] = res[0] - np.pi if res[0] > 0.0 else res[0] + np.pi
            res[1] = np.arctan2(-R[i, k], -c2)
        else:
            res[1] = np.arctan2(-R[i, k], c2)
        s1, c1 = np.sin(res[0]), np.cos(res[0])
        res[2] = np.arctan2(s1 * R[k, i] - c1 * R[j, i], c1 * R[j, j] - s1 * R[k, j])
    if not odd:
        res = -res
    return res


def axis_angle_matrix(angle: float, axis: Array) -> Array:
    """Eigen AngleAxisd(angle, axis) -> rotation matrix."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return rodrigues(axis * angle)


def odometry_remap(data7) -> Array:
    """The reference's hand-rolled TUM-odometry -> camera-frame remap.

    Reference GraphicEnd::readOdometry (src/GraphicEnd.h:148-170):
    full pose from (x y z qx qy qz qw), yaw = eulerAngles(2,0,2)[2],
    T = AngleAxis(yaw, -UnitY) with translation (-ty, -tz, tx).
    """
    d = np.asarray(data7, dtype=np.float64).reshape(7)
    T_full = set_estimate_data(d)
    rpy = euler_angles(T_full[:3, :3], 2, 0, 2)
    R = axis_angle_matrix(rpy[2], np.array([0.0, -1.0, 0.0]))
    return make_isometry(R, np.array([-d[1], -d[2], d[0]]))


# ---------------------------------------------------------------------------
# motion norms (keyframe decision)
# ---------------------------------------------------------------------------

def motion_norm(rvec: Array, tvec: Array) -> float:
    """Plane-pipeline norm: |min(||r||, 2pi-||r||)| + 0.9*|||t|||.

    Reference src/GraphicEnd.cpp:618.
    """
    rn = float(np.linalg.norm(rvec))
    tn = float(np.linalg.norm(tvec))
    return abs(min(rn, 2.0 * np.pi - rn)) + 0.9 * abs(tn)


def motion_norm2(rvec: Array, tvec: Array) -> float:
    """Image-only-pipeline norm: |min(||r||, 2pi-||r||) + ||t|||.

    Reference src/GraphicEnd2.cpp:292.
    """
    rn = float(np.linalg.norm(rvec))
    tn = float(np.linalg.norm(tvec))
    return abs(min(rn, 2.0 * np.pi - rn) + tn)
