# Frozen copy of heligym_tpu_torch/ops/kinematics.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Rigid-body kinematics as scalar-explicit expressions over tuple vectors:
vectors are 3-tuples of (batched) scalars and matrices 3x3 nested tuples, so
every operation is elementwise over the batch."""
import torch


def euler_to_rotmat(phi, theta, psi):
    """ZYX Euler angles -> earth-to-body DCM rows
    (R = Rx(phi) Ry(theta) Rz(psi), written out symbolically)."""
    s0, s1, s2 = torch.sin(phi), torch.sin(theta), torch.sin(psi)
    c0, c1, c2 = torch.cos(phi), torch.cos(theta), torch.cos(psi)
    return (
        (c1 * c2, c1 * s2, -s1),
        (s0 * s1 * c2 - c0 * s2, s0 * s1 * s2 + c0 * c2, s0 * c1),
        (c0 * s1 * c2 + s0 * s2, c0 * s1 * s2 - s0 * c2, c0 * c1),
    )


def transpose_rows(m):
    return (
        (m[0][0], m[1][0], m[2][0]),
        (m[0][1], m[1][1], m[2][1]),
        (m[0][2], m[1][2], m[2][2]),
    )


def matvec(m, v):
    """m @ v with explicit left-to-right accumulation ((a+b)+c). Returns a
    3-tuple."""
    return (
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    )


def pqr_to_eulerdot(phi, theta, p, q, r):
    """Euler-angle rates from body rates, expanded; the zero entries of the
    reference matrix are dropped symbolically."""
    s0, s1 = torch.sin(phi), torch.sin(theta)
    c0, c1 = torch.cos(phi), torch.cos(theta)
    phi_dot = p + (s0 * s1 / c1) * q + (c0 * s1 / c1) * r
    theta_dot = c0 * q + (-s0) * r
    psi_dot = (s0 / c1) * q + (c0 / c1) * r
    return phi_dot, theta_dot, psi_dot
