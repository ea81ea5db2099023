"""Device-side Lie-group math on tensors (counterpart of slam3d_gx_tpu/ops/lie.py).

Branch-free (Taylor-guarded) so it batches and differentiates cleanly;
fp32. The float64 host twin is geometry/se3.py. Per-rotation scalars
keep a trailing unit dim: under torch.func's vmap + forward AD, a 0-d
tensor times a Python float gets a float64 tangent.

Conventions match OpenCV Rodrigues / g2o SE3: rotation vectors are
axis*angle; the se3 tangent is (rho, phi), translation first.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _theta2(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 of (...,3) as (...,1,1)."""
    return torch.sum(v * v, dim=-1, keepdim=True)[..., None]


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """(...,3) axis-angle -> (...,3,3) rotation matrix, small-angle safe."""
    theta2 = _theta2(rvec)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    K = hat(rvec)
    return _eye_like(K) + a * K + b * (K @ K)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) quaternion (qx,qy,qz,qw), qw >= 0; branch-free."""
    # entries as (...,1)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = [
        [R[..., i, j:j + 1] for j in range(3)] for i in range(3)]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = root(1.0 + tr)
    c0 = torch.cat([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1) / (4.0 * qw0)
    qx1 = root(1.0 + m00 - m11 - m22)
    c1 = torch.cat([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (4.0 * qx1)
    qy2 = root(1.0 - m00 + m11 - m22)
    c2 = torch.cat([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (4.0 * qy2)
    qz3 = root(1.0 - m00 - m11 + m22)
    c3 = torch.cat([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1) / (4.0 * qz3)
    best = torch.argmax(torch.cat([tr, m00, m11, m22], -1), dim=-1, keepdim=True)
    # the best-conditioned of the four constructions
    q = torch.where(best == 0, c0, torch.where(best == 1, c1, torch.where(best == 2, c2, c3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(...,4) (qx,qy,qz,qw) -> (...,3,3); q need not be unit."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.where(n > 0, n, 1.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    r0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1)
    r1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1)
    r2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1)
    return torch.stack([r0, r1, r2], -2)


def inv_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle with theta in [0, pi],
    through the quaternion (stable near theta = pi in fp32)."""
    q = rot_to_quat(R)
    vec, w = q[..., :3], q[..., 3:]
    s = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(s, w)
    nz = s > 1e-12
    return vec * torch.where(nz, theta / torch.where(nz, s, 1.0), 2.0)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3),(...,3) -> (...,4,4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    # built from fills: assigning the 1.0 into a CUDA tensor under
    # torch.func's transforms copies it from the host, and the host waits
    lead = R.shape[:-2] + (1,)
    bottom = torch.cat([torch.zeros(lead + (3,), dtype=R.dtype, device=R.device),
                        torch.ones(lead + (1,), dtype=R.dtype, device=R.device)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inv_T(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V such that the se3 exp translation is V @ rho."""
    theta2 = _theta2(phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    K = hat(phi)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye_like(K) + b * K + c * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) tangent (rho, phi) -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_T(rodrigues(phi), t)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,3,3) A, (...,3) b -> A^-1 b by Cramer's rule. Plain arithmetic:
    under vmap, forward-mode AD of the batched torch.linalg.solve gives
    NaN tangents for some batches of well-conditioned systems."""
    a0, a1, a2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    c12 = torch.linalg.cross(a1, a2)
    det = torch.sum(a0 * c12, dim=-1, keepdim=True)
    x = torch.stack([torch.sum(b * c12, dim=-1),
                     torch.sum(a0 * torch.linalg.cross(b, a2), dim=-1),
                     torch.sum(a0 * torch.linalg.cross(a1, b), dim=-1)], dim=-1)
    return x / det


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) tangent (rho, phi)."""
    phi = inv_rodrigues(T[..., :3, :3])
    rho = _solve3(_so3_left_jacobian(phi), T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)
