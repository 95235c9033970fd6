# Frozen copy of heligym_tpu_torch/ops/gear.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Landing-gear spring-damper ground reaction.

Two reference quirks reproduced deliberately:
  * the ground height is sampled at the env's *committed* (pre-RK4-stage) CG
    position, so `h_ground` arrives here as a precomputed value;
  * each contacting leg's moment uses the cross product with the *running
    accumulated* force, not that leg's own contribution.

The 3-leg loop is unrolled (legs are static float tuples), the contact `if`
is masked accumulation, and all vectors are 3-tuples of (batched) scalars.
"""
import torch

from .constants import EPS
from .mathx import cross
from .kinematics import matvec, transpose_rows


def landing_gear(p, xyz, ned_vel, body2earth, pqr, h_ground):
    """Returns (force3, moment3) in the body frame.

    `xyz`, `ned_vel`, `pqr` are 3-tuples; `h_ground` is the terrain height at
    the committed CG position [ft].
    """
    LG, HELI = p.LG, p.HELI
    earth2body = transpose_rows(body2earth)
    touch_alt = h_ground + HELI.WL_CG / 12.0

    zero = torch.zeros_like(h_ground)
    force = (zero, zero, zero)
    moment = (zero, zero, zero)
    for pos_body in LG.LOC:   # static Python-float tuples
        d = matvec(body2earth, pos_body)
        pos_ned = (xyz[0] + d[0], xyz[1] + d[1], xyz[2] + d[2])
        dv = matvec(body2earth, cross(pqr, pos_body))
        vel_ned = (ned_vel[0] + dv[0], ned_vel[1] + dv[1], ned_vel[2] + dv[2])
        contact = (-pos_ned[2]) - touch_alt < 0.0
        cxdot = LG.C * vel_ned[2]
        kx = LG.K * (pos_ned[2] + h_ground)
        f_ned = (zero, zero, -(cxdot + kx) + EPS)
        f_body = matvec(earth2body, f_ned)
        force = tuple(force[i] + torch.where(contact, f_body[i], 0.0)
                      for i in range(3))
        # Reference quirk: cross with the accumulated force so far.
        m_leg = cross(pos_body, force)
        moment = tuple(moment[i] + torch.where(contact, m_leg[i], 0.0)
                       for i in range(3))
    return force, moment
