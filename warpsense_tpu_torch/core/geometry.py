"""SE(3) / fixed-point geometry on tensors.

Counterpart of ``warpsense_tpu/core/geometry.py``.  Integer functions are
bit-exact with the JAX package, int32 wraparound included: CUDA PyTorch has
no int32 matmul, so ``transform_point_fixed`` is written as explicit int32
multiply-adds (integer addition wraps modulo 2^32 in any order, so the
result equals the JAX int32 dot).  Float functions run in float32.
"""
from __future__ import annotations

import torch

from .consts import MATRIX_RESOLUTION


def to_int_mat(pose: torch.Tensor) -> torch.Tensor:
    """Scale a float 4x4 pose by MATRIX_RESOLUTION and truncate to int32."""
    return (pose * MATRIX_RESOLUTION).to(torch.int32)


def transform_point_fixed(points: torch.Tensor,
                          int_mat: torch.Tensor) -> torch.Tensor:
    """``(R*p + t) / MR`` for int32 mm points (..., 3) and a fixed-point 4x4
    (int32, MATRIX_RESOLUTION-scaled), in wrapping int32 arithmetic.

    Widening to int64 would change results: with MR = 2^15 and points of
    +-20 m the sums approach 2^31 and the reference wraps."""
    p = points.to(torch.int32)
    m = int_mat.to(torch.int32)
    cols = []
    for j in range(3):
        acc = p[..., 0] * m[j, 0] + p[..., 1] * m[j, 1] + p[..., 2] * m[j, 2]
        cols.append(acc + m[j, 3])
    out = torch.stack(cols, dim=-1)
    return div_trunc(out, MATRIX_RESOLUTION)


def div_trunc(a: torch.Tensor, b) -> torch.Tensor:
    """C-style integer division (truncate toward zero).

    Written as ``|a| // |b|`` with a sign fix, exactly like the JAX
    function, so that INT_MIN (whose abs wraps) divides identically."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    q = torch.div(torch.abs(a), torch.abs(b), rounding_mode="floor")
    return torch.where((a < 0) != (b < 0), -q, q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3x3 skew-symmetric matrix of a 3-vector."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from an axis-angle 3-vector, safe at theta -> 0."""
    theta = torch.sqrt(torch.sum(axis_angle * axis_angle))
    small = theta < 1e-12
    safe = torch.where(small, torch.ones_like(theta), theta)
    L = skew(axis_angle / safe)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    R = eye + torch.sin(theta) * L + (1.0 - torch.cos(theta)) * (L @ L)
    return torch.where(small, eye, R)


def xi_to_transform(xi: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Twist (rot[3], trans[3]) -> 4x4 SE3, rotating about ``center`` (mm)
    rather than the origin (registration/util.h:5-39, "Formula 3.9")."""
    rotation = rodrigues(xi[:3])
    center_f = center.to(xi.dtype)
    t = rotation @ (-center_f) + center_f + xi[3:6]
    out = torch.zeros((4, 4), dtype=xi.dtype, device=xi.device)
    out[:3, :3] = rotation
    out[:3, 3] = t
    out[3, 3] = 1.0
    return out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written as ``jnp.cross`` writes
    it (three products and a difference per component), so float32
    results round identically."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, quaternions as (x, y, z, w)."""
    x1, y1, z1, w1 = q1[0], q1[1], q1[2], q1[3]
    x2, y2, z2, w2 = q2[0], q2[1], q2[2], q2[3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by the unit quaternion q = (x, y, z, w)."""
    u = q[:3].expand(v.shape)
    uv = cross(u, v)
    return v + 2.0 * (q[3] * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) exponential -> (unit quaternion (x, y, z, w), translation);
    ``xi`` = (omega[3], upsilon[3]).  Taylor fallback below 1e-10
    (lidar_optimization.cpp:109-146).  Branch-free, so it stays on the
    device of ``xi``."""
    omega, upsilon = xi[:3], xi[3:]
    theta = torch.sqrt(torch.sum(omega * omega))
    half = 0.5 * theta
    theta_sq = theta * theta
    small = theta < 1e-10
    one = torch.ones_like(theta)
    imag = torch.where(
        small, 0.5 - 0.0208333 * theta_sq + 0.000260417 * theta_sq * theta_sq,
        torch.sin(half) / torch.where(small, one, theta))
    q = torch.cat([imag * omega, torch.cos(half).reshape(1)])
    q = q / torch.sqrt(torch.sum(q * q))
    Omega = skew(omega)
    safe_t = torch.where(small, one, theta)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    J = torch.where(
        small, quat_to_mat(q),
        eye + (1 - torch.cos(theta)) / (safe_t * safe_t) * Omega
        + (theta - torch.sin(theta)) / (safe_t ** 3) * (Omega @ Omega))
    return q, J @ upsilon


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous pose from a 3x3 rotation and a translation."""
    out = torch.zeros((4, 4), dtype=R.dtype, device=R.device)
    out[:3, :3] = R
    out[:3, 3] = t
    out[3, 3] = 1.0
    return out


def to_map(pose_mm: torch.Tensor, resolution: int) -> torch.Tensor:
    """mm pose (4x4 float) -> voxel index of its translation (floor)."""
    return torch.floor(pose_mm[:3, 3] / resolution).to(torch.int32)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt of float32 (PyTorch's CPU float32 sqrt is
    not): float64 sqrt rounded once more is exact for float32 inputs."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _norm4_fma(q: torch.Tensor) -> torch.Tensor:
    """|q| of a float32 4-vector as XLA:CPU evaluates ``jnp.linalg.norm``:
    a chain of fused multiply-adds, each emulated in float64 (a float32
    product is exact there) and rounded to float32 once."""
    s = q[0] * q[0]
    for i in (1, 2, 3):
        qi = q[i].to(torch.float64)
        s = (qi * qi + s.to(torch.float64)).to(q.dtype)
    return _sqrt_rn(s)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (x, y, z, w); picks the best
    conditioned of the four constructions like the JAX function, with its
    float32 roundings (a correctly rounded sqrt; the norm as XLA:CPU
    computes it), so a float32 rotation gives JAX's bits."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                      1 - m00 - m11 + m22])
    qw = _sqrt_rn(torch.clamp(qw, min=1e-12)) / 2.0
    idx = int(torch.argmax(torch.stack([tr, m00, m11, m22])))
    s = 4 * qw[idx]
    if idx == 0:
        q = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                         qw[0]])
    elif idx == 1:
        q = torch.stack([qw[1], (m01 + m10) / s, (m02 + m20) / s,
                         (m21 - m12) / s])
    elif idx == 2:
        q = torch.stack([(m01 + m10) / s, qw[2], (m12 + m21) / s,
                         (m02 - m20) / s])
    else:
        q = torch.stack([(m02 + m20) / s, (m12 + m21) / s, qw[3],
                         (m10 - m01) / s])
    return q / _norm4_fma(q)
