"""Quaternion / rotation ops on torch tensors.

Counterpart of the JAX package's ops/quat.py, function for function: pure
functions over tensors with a trailing quaternion axis in **xyzw** order
(the Isaac Gym root-state layout, legged_robot.py:140-147).  Everything
broadcasts over leading batch axes.
"""
from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize along the last axis."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b for xyzw quaternions."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (body->world if q is body pose)."""
    qvec = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v + qw * t + _cross(qvec, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world->body if q is body pose)."""
    qvec = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v - qw * t + _cross(qvec, t)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q (legged_gym/utils/math.py:7-12)."""
    q_yaw = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:4]], dim=-1)
    return quat_rotate(normalize(q_yaw), v)


def yaw_rot2d(q: torch.Tensor, eps: float = 1e-18):
    """(cos, sin) of the yaw angle of q (xyzw), by the half-angle
    identities of q_yaw = normalize([0, 0, z, w])."""
    z, w = q[..., 2], q[..., 3]
    inv = 1.0 / (w * w + z * z + eps)
    return (w * w - z * z) * inv, 2.0 * w * z * inv


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> 3x3 rotation matrix (body->world)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> xyzw quaternion (branch-free Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0
    sg = torch.sign
    cand_w = torch.stack([sg(m21 - m12) * qx, sg(m02 - m20) * qy,
                          sg(m10 - m01) * qz, qw], dim=-1)
    cand_x = torch.stack([qx, sg(m10 + m01) * qy, sg(m02 + m20) * qz,
                          sg(m21 - m12) * qw], dim=-1)
    cand_y = torch.stack([sg(m01 + m10) * qx, qy, sg(m21 + m12) * qz,
                          sg(m02 - m20) * qw], dim=-1)
    cand_z = torch.stack([sg(m20 + m02) * qx, sg(m12 + m21) * qy, qz,
                          sg(m10 - m01) * qw], dim=-1)
    pivots = torch.stack([qx, qy, qz, qw], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_x, cand_y, cand_z, cand_w], dim=-2)
    idx = best[..., None, None].expand(cands.shape[:-2] + (1, 4))
    return normalize(torch.gather(cands, -2, idx)[..., 0, :])


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> xyzw quaternion."""
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic xyz Euler angles -> xyzw quaternion (isaacgym.torch_utils parity)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def get_euler_xyz(q: torch.Tensor):
    """xyzw quaternion -> (roll, pitch, yaw) (isaacgym_utils.py:13-33)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (qw * qx + qy * qz),
                       qw * qw - qx * qx - qy * qy + qz * qz)
    pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy),
                      qw * qw + qx * qx - qy * qy - qz * qz)
    return roll, pitch, yaw


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Extract the yaw-only quaternion of q."""
    return normalize(torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:4]],
                               dim=-1))


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] (legged_gym/utils/math.py:14-18)."""
    a = torch.remainder(angles, 2.0 * math.pi)
    return a - 2.0 * math.pi * (a > math.pi)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation with world-frame angular velocity (exponential map)."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.clamp(angle, min=1e-9)
    dq = axis_angle_to_quat(axis, (angle * dt)[..., 0])
    return normalize(quat_mul(dq, q))


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric (cross product) matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))
