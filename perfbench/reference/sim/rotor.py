# Frozen copy of heligym_tpu_torch/ops/rotor.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Main- and tail-rotor force/moment terms with inflow and flapping dynamics.

Branch sites are selects (`torch.where`, `torch.clamp`); every expression
keeps the JAX package's operation order and groups its Python-float
constants the same way, so float32 rounding matches (`ops/rotor.py` there).
All vectors are 3-tuples of (batched) scalars.
"""
import math

import torch

from .mathx import cdiv, rdiv


def main_rotor(p, rho, coll, lon, lat, b0, b1, uvw_air, pqr, vi_mr):
    """Returns (force3, moment3, power, b0_dot, b1_dot, vi_mr_dot, psi_mr_dot)."""
    MR, HELI = p.MR, p.HELI
    ua, va, wa = uvw_air

    # Flapping coupling coefficients.
    GAM_OM16 = rho * MR.GAM_OM16_DRO
    KC = rdiv(0.75 * MR.OMEGA * MR.E / MR.R, GAM_OM16) + MR.K1
    om_g = rdiv(MR.OMEGA, GAM_OM16)
    ITB2_OM = rdiv(MR.OMEGA, 1.0 + om_g * om_g)
    ITB = ITB2_OM * MR.OMEGA / GAM_OM16
    DL_DB1 = MR.DL_DB1
    DL_DA1 = rho * MR.DL_DA1_DRO

    # Blade-equivalent axial flow and quasi-steady thrust.
    v_adv_2 = ua * ua + va * va
    wr = wa + (b0 - MR.IS) * ua - b1 * va
    wb = (wr + 0.66667 * MR.V_TIP * (coll + 0.75 * MR.TWST)
          + cdiv(v_adv_2, MR.V_TIP) * (coll + 0.5 * MR.TWST))
    thrust = (wb - vi_mr) * (rho * MR.COEF_TH)
    wv = wr - vi_mr
    vi_mr_dot = 0.75 * math.pi / MR.R * (
        thrust / (2.0 * math.pi * rho * MR.R * MR.R)
        - vi_mr * torch.sqrt(v_adv_2 + wv * wv))

    # Induced + profile power -> torque.
    induced_power = thrust * (vi_mr - wr)
    profile_power = 0.5 * rho * (MR.FR / 4.0) * MR.V_TIP * (
        MR.V_TIP * MR.V_TIP + 3.0 * v_adv_2)
    power = induced_power + profile_power
    torque = cdiv(power, MR.OMEGA)

    # Thrust-coefficient dihedral terms.
    CT = thrust / (rho * math.pi * MR.R * MR.R * MR.V_TIP * MR.V_TIP)
    CT = torch.clamp(CT, min=0.0)
    DB1DV = 2.0 / MR.V_TIP * (cdiv(8.0 * CT, MR.A_SIGMA) + torch.sqrt(0.5 * CT))
    DA1DU = -DB1DV

    # TPP (flapping) dynamics with the wake step at VTRANS.
    wake_fn = torch.where(torch.abs(ua) > HELI.VTRANS, 1.0, 0.0)
    a_sum = b1 - lat + KC * b0 + DB1DV * va * (1.0 + wake_fn)
    b_sum = b0 + lon - KC * b1 + DA1DU * ua * (1.0 + 2.0 * wake_fn)
    b0_dot = -ITB * b_sum - ITB2_OM * a_sum - pqr[1]
    b1_dot = -ITB * a_sum + ITB2_OM * b_sum - pqr[0]

    psi_mr_dot = torch.full_like(vi_mr, MR.OMEGA)

    # Force/moment composition incl. hub stiffness moments.
    X = -thrust * (b0 - MR.IS)
    Y = thrust * b1
    Z = -thrust
    L = Y * MR.H + DL_DB1 * b1 + DL_DA1 * (b0 + lon - MR.K1 * b1)
    M = Z * MR.D - X * MR.H + DL_DB1 * b0 + DL_DA1 * (-b1 + lat - MR.K1 * b0)
    N = torque
    return (X, Y, Z), (L, M, N), power, b0_dot, b1_dot, vi_mr_dot, psi_mr_dot


def tail_rotor(p, rho, pedal, uvw_air, pqr, vi_tr):
    """Returns (force3, moment3, power, vi_tr_dot, psi_tr_dot)."""
    TR = p.TR
    ua, va, wa = uvw_air
    wq = wa + pqr[1] * TR.D
    v_adv_2 = wq * wq + ua * ua
    vr = -(va - pqr[2] * TR.D + pqr[0] * TR.H)
    vb = (vr + 0.66667 * TR.V_TIP * (pedal + 0.75 * TR.TWST)
          + cdiv(v_adv_2, TR.V_TIP) * (pedal + 0.5 * TR.TWST))

    thrust = (vb - vi_tr) * rho * TR.COEF_TH
    wv = vr - vi_tr
    vi_tr_dot = 0.75 * math.pi / TR.R * (
        thrust / (2.0 * math.pi * rho * TR.R ** 2)
        - vi_tr * torch.sqrt(v_adv_2 + wv * wv))
    # Inflow dynamics deliberately slowed 2x for numerical stability, as in
    # the reference.
    vi_tr_dot = vi_tr_dot * 0.5

    psi_tr_dot = torch.full_like(vi_tr, TR.OMEGA)
    power = thrust * (vi_tr - vr)

    Y = thrust
    L = Y * TR.H
    N = -Y * TR.D
    zero = torch.zeros_like(Y)
    return (zero, Y, zero), (L, zero, N), power, vi_tr_dot, psi_tr_dot
