# Frozen copy of heligym_tpu_torch/ops/aero.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Fuselage, empennage and wing aerodynamic force/moment terms.

Each `if` of the reference on state is a branchless `torch.where`: the stall
tests, the triangular-downwash window, and the guarded divisions at wa=0 and
vta=0 (the untaken side cannot poison a value with NaN). The wing term is a
static parameter branch: it vanishes for wingless aircraft such as the aw109.
Vectors are 3-tuples of (batched) scalars.
"""
import math

import torch

from .constants import EPS
from .mathx import cdiv


def fuselage(p, rho, uvw_air, vi_mr):
    """Returns (force3, moment3, power)."""
    FUS, MR = p.FUS, p.MR
    ua, va, _ = uvw_air
    wa_fus = uvw_air[2] - vi_mr                       # rotor downwash included
    wa_fus = wa_fus + (wa_fus > 0) * EPS              # make it nonzero
    # Downwash impingement position; guard the (pathological) wa_fus == 0
    # case that the reference leaves as an inf/NaN.
    denom = torch.where(wa_fus == 0.0, -EPS, -wa_fus)
    d_fw = (ua / denom * (MR.H - FUS.H)) - (FUS.D - MR.D)
    d_fw = d_fw * FUS.COR
    rho_half = 0.5 * rho
    X = rho_half * FUS.XUU * torch.abs(ua) * ua
    Y = rho_half * FUS.YVV * torch.abs(va) * va
    Z = rho_half * FUS.ZWW * torch.abs(wa_fus) * wa_fus
    L = Y * FUS.H
    M = Z * d_fw - X * FUS.H
    power = -X * ua - Y * va - Z * wa_fus
    zero = torch.zeros_like(X)
    return (X, Y, Z), (L, M, zero), power


def horizontal_tail(p, rho, uvw_air, pqr, vi_mr):
    """Returns (force3, moment3)."""
    HT, MR = p.HT, p.MR
    ua, va, wa = uvw_air
    v_dw = torch.clamp(vi_mr - wa, min=EPS)
    d_dw = (ua / v_dw * (MR.H - HT.H)) - (HT.D - MR.D - MR.R)
    # Triangular downwash window.
    eps_ht = torch.where((d_dw > 0) & (d_dw < MR.R),
                         2.0 * (1.0 - cdiv(d_dw, MR.R)), 0.0)
    wa_ht = wa - eps_ht * vi_mr + HT.D * pqr[1]
    # Stall branch; both sides always evaluated, NaN-free.
    vta_ht = torch.sqrt(ua * ua + va * va + wa_ht * wa_ht)
    Z_stall = 0.5 * rho * HT.ZMAX * torch.abs(vta_ht) * wa_ht
    Z_lin = 0.5 * rho * (HT.ZUU * torch.abs(ua) * ua
                         + HT.ZUW * torch.abs(ua) * wa_ht)
    Z = torch.where(torch.abs(wa_ht) > 0.3 * torch.abs(ua), Z_stall, Z_lin)
    M = Z * HT.D
    zero = torch.zeros_like(Z)
    return (zero, zero, Z), (zero, M, zero)


def vertical_tail(p, rho, uvw_air, pqr, vi_tr):
    """Returns (force3, moment3)."""
    VT = p.VT
    ua, va, _ = uvw_air
    va_vt = va + vi_tr - VT.D * pqr[2]
    vta_vt = torch.sqrt(ua * ua + va_vt * va_vt)
    Y_stall = 0.5 * rho * VT.YMAX * torch.abs(vta_vt) * va_vt
    Y_lin = 0.5 * rho * (VT.YUU * torch.abs(ua) * ua
                         + VT.YUV * torch.abs(ua) * va_vt)
    Y = torch.where(torch.abs(va_vt) > 0.3 * torch.abs(ua), Y_stall, Y_lin)
    L = Y * VT.H
    N = -Y * VT.D
    zero = torch.zeros_like(Y)
    return (zero, Y, zero), (L, zero, N)


def wing(p, rho, uvw_air, vi_mr):
    """Returns (force3, moment3, power)."""
    WN = p.WN
    zero = torch.zeros_like(rho)
    if WN.ZUW == 0.0:
        # Static parameter branch: no wing term for wingless aircraft.
        z3 = (zero, zero, zero)
        return z3, z3, zero
    ua, _, wa = uvw_air
    wa_wn = wa - vi_mr
    vta_wn = torch.sqrt(ua * ua + wa_wn * wa_wn)
    Z_stall = 0.5 * rho * WN.ZMAX * torch.abs(vta_wn) * wa_wn
    Z_lin = 0.5 * rho * (WN.ZUU * (ua * ua) + WN.ZUW * ua * wa_wn)
    Z = torch.where(torch.abs(wa_wn) > 0.3 * torch.abs(ua), Z_stall, Z_lin)
    # Induced drag; guard vta == 0 (the reference would divide by zero).
    vta2_safe = torch.where(vta_wn == 0.0, EPS, vta_wn * vta_wn)
    lift = WN.ZUU * ua * ua + WN.ZUW * ua * wa_wn
    X = cdiv(-0.5 * rho, math.pi) / vta2_safe * (lift * lift)
    power = torch.abs(X * ua)
    return (X, zero, Z), (zero, zero, zero), power
