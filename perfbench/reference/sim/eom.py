# Frozen copy of heligym_tpu_torch/ops/eom.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""6-DOF equations of motion: full helicopter state-derivative assembly.

The control mapping, the force/moment summation in the reference's exact
accumulation order, and the 17-dim observation. Pure and elementwise over the
batch: one env, a batch, and the fused step's plain version all run this
code.
"""
import torch

from .constants import D2R
from .mathx import cdiv, cross
from . import aero, gear, rotor
from .atmosphere import air_properties
from .kinematics import euler_to_rotmat, matvec, pqr_to_eulerdot, transpose_rows
from .state import HeliState


def control_inputs(p, a0, a1, a2, a3):
    """Normalized [-1, 1] action channels -> (coll, lon, lat, pedal) in
    radians."""
    H = p.HELI
    coll = D2R * (H.COL_OS + 0.5 * a0 * (H.COL_H - H.COL_L)
                  + 0.5 * (H.COL_H + H.COL_L))
    lon = D2R * (0.5 * a1 * (H.LON_H - H.LON_L) + 0.5 * (H.LON_H + H.LON_L))
    lat = D2R * (0.5 * a2 * (H.LAT_H - H.LAT_L) + 0.5 * (H.LAT_H + H.LAT_L))
    pedal = D2R * (H.PED_OS + 0.5 * a3 * (H.PED_H - H.PED_L)
                   + 0.5 * (H.PED_H + H.PED_L))
    return coll, lon, lat, pedal


def heli_dynamics(p, s: HeliState, action4, wind_ned3, h_ground):
    """State derivative + observation.

    Args:
      p: static HeliParams.
      s: HeliState (fields () or (B,)).
      action4: 4-tuple of normalized control channels.
      wind_ned3: 3-tuple NED wind velocity [ft/s] applied this step.
      h_ground: terrain height at the *committed* CG position [ft], constant
        across RK4 stages as in the reference.

    Returns:
      (dots: HeliState, obs: 17-tuple of scalars, power_total)
    """
    coll, lon, lat, pedal = control_inputs(p, *action4)

    earth2body = euler_to_rotmat(s.phi, s.theta, s.psi)
    body2earth = transpose_rows(earth2body)
    uvw = (s.u, s.v, s.w)
    pqr = (s.p, s.q, s.r)
    phi_dot, theta_dot, psi_dot = pqr_to_eulerdot(s.phi, s.theta, s.p, s.q, s.r)
    ned_vel = matvec(body2earth, uvw)
    wind_body = matvec(earth2body, wind_ned3)
    uvw_air = (s.u - wind_body[0], s.v - wind_body[1], s.w - wind_body[2])

    power_climb = p.HELI.WT * (-ned_vel[2])
    _, rho = air_properties(p.ENV, -s.z)

    (f_mr, m_mr, power_mr, b0_dot, b1_dot, vi_mr_dot, psi_mr_dot) = rotor.main_rotor(
        p, rho, coll, lon, lat, s.b0, s.b1, uvw_air, pqr, s.vi_mr)
    f_tr, m_tr, power_tr, vi_tr_dot, psi_tr_dot = rotor.tail_rotor(
        p, rho, pedal, uvw_air, pqr, s.vi_tr)
    f_fus, m_fus, power_fus = aero.fuselage(p, rho, uvw_air, s.vi_mr)
    f_ht, m_ht = aero.horizontal_tail(p, rho, uvw_air, pqr, s.vi_mr)
    f_vt, m_vt = aero.vertical_tail(p, rho, uvw_air, pqr, s.vi_tr)
    f_wn, m_wn, power_wn = aero.wing(p, rho, uvw_air, s.vi_mr)
    f_lg, m_lg = gear.landing_gear(p, (s.x, s.y, s.z), ned_vel, body2earth,
                                   pqr, h_ground)

    # Climb + fuselage power are charged to main-rotor torque.
    power_extra_mr = power_climb + power_fus
    extra_mr_torque = cdiv(power_extra_mr, p.MR.OMEGA)
    m_mr = (m_mr[0], m_mr[1], m_mr[2] + extra_mr_torque)

    power_total = (power_mr + power_tr + power_extra_mr + power_wn
                   + 550.0 * p.HELI.HP_LOSS)
    wt_vec = (torch.zeros_like(rho), torch.zeros_like(rho),
              torch.full_like(rho, p.HELI.WT))
    f_grav = matvec(earth2body, wt_vec)
    # The reference's accumulation order, per component.
    force = tuple(f_mr[i] + f_tr[i] + f_fus[i] + f_ht[i] + f_vt[i]
                  + f_wn[i] + f_grav[i] + f_lg[i] for i in range(3))
    moment = tuple(m_mr[i] + m_tr[i] + m_fus[i] + m_ht[i] + m_vt[i]
                   + m_wn[i] + m_lg[i] for i in range(3))

    body_acc = tuple(cdiv(force[i], p.HELI.M) for i in range(3))
    w_cross_v = cross(pqr, uvw)
    uvw_dot = tuple(body_acc[i] - w_cross_v[i] for i in range(3))
    i_pqr = matvec(p.HELI.I, pqr)
    w_cross_iw = cross(pqr, i_pqr)
    pqr_dot = matvec(p.HELI.IINV,
                     tuple(moment[i] - w_cross_iw[i] for i in range(3)))

    dots = HeliState(
        vi_mr=vi_mr_dot, vi_tr=vi_tr_dot, psi_mr=psi_mr_dot, psi_tr=psi_tr_dot,
        b0=b0_dot, b1=b1_dot,
        u=uvw_dot[0], v=uvw_dot[1], w=uvw_dot[2],
        p=pqr_dot[0], q=pqr_dot[1], r=pqr_dot[2],
        phi=phi_dot, theta=theta_dot, psi=psi_dot,
        x=ned_vel[0], y=ned_vel[1], z=ned_vel[2])

    # Observation: 17 scalars, ground altitude against the committed terrain
    # height.
    power_total_hp = cdiv(power_total, 550.0)
    alt_gr = -s.z - h_ground
    obs = (power_total_hp,
           uvw_air[0], uvw_air[1], uvw_air[2],
           ned_vel[0], ned_vel[1], ned_vel[2],
           s.phi, s.theta, s.psi,
           s.p, s.q, s.r,
           s.x, s.y, -s.z, alt_gr)
    return dots, obs, power_total
