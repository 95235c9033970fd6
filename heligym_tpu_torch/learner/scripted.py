"""The scripted landing controller: a cascaded PD law around the hover trim.

The port of the JAX package's `learner/scripted.py`. The controller is
memoryless, a pure function obs -> action residual (no integrators, no mode
latches), so it can label any state a student visits (DAgger) and an MLP
student can represent it. Executed action = clip(act_bias + residual, -1, 1).

  * collective: tracks the descent-rate profile vd_ref(agl) =
    clip(k_agl * (agl - agl_td), 0, vmax), with a brisk-entry sink floor
    above the gear band and a commit gate that holds while the airframe is
    not quiet just above it;
  * cyclics: position hold, pad error and ground speed -> desired horizontal
    acceleration (heading frame) -> tilt reference about the trim attitude
    -> PD attitude loop; level through the gear capture band; on the gear,
    cyclic proportional to ground speed;
  * pedal: yaw hold about the trim heading, with a collective -> pedal
    torque feedforward.

The tensor math is elementwise over any leading shape, on the obs' device,
in float32: the gains and the trim attitude enter as Python floats.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ApproachGains:
    """Cascaded-PD gains; the defaults are the tuned values
    (`tools/torch_tune_scripted.py` sweeps them)."""
    # vertical: collective tracks vd_ref(agl)
    k_w: float = 0.03        # collective residual per ft/s of vd error
    vmax: float = 9.0        # [ft/s] descent-rate cap
    k_agl: float = 0.25      # [1/s] profile slope (arrest time constant)
    agl_td: float = 3.0      # [ft] virtual touchdown AGL (below gear rest)
    # touchdown capture: enter the gear band level and briskly
    v_floor: float = 6.0     # [ft/s] minimum commanded sink below floor_agl
    floor_agl: float = 14.0  # [ft] where the sink floor ramps in
    lvl_hi: float = 13.0     # [ft] start blending attitude to level
    lvl_lo: float = 8.5      # [ft] fully level by here (band entry)
    lvl_end: float = 5.2     # [ft] restore hold authority below (on gear)
    lvl_end_w: float = 0.8   # [ft] restore ramp width
    # on the gear: cyclic proportional to ground speed (tilts the disk)
    k_gv: float = 0.15       # cyclic per ft/s of ground speed, on gear
    gnd_agl: float = 9.0     # [ft] where the ground term ramps in
    k_w_gnd: float = 0.0     # extra collective gain per ft/s, on gear
    # commit gate: just above the band, descend only while quiet
    gate_hi: float = 15.0    # [ft] gate zone top
    gate_lo: float = 12.0    # [ft] gate zone bottom (band entry)
    gate_phi: float = 0.04   # [rad] roll tolerance
    gate_p: float = 0.12     # [rad/s] roll-rate tolerance
    gate_q: float = 0.20     # [rad/s] pitch-rate tolerance
    gate_vy: float = 1.8     # [ft/s] lateral speed tolerance
    gate_climb: float = 0.5  # [ft/s] climb command while gated
    lvl_boost: float = 0.0   # extra attitude-gain factor at full w_lvl
    phi_td: float = 0.0      # [rad] roll reference offset at full w_lvl
    # horizontal position hold (outer loop -> desired accel, heading frame)
    k_pos: float = 0.04      # [1/s^2] accel per ft of pad error
    k_vel: float = 0.40      # [1/s] accel per ft/s of ground speed
    a_max: float = 6.0       # [ft/s^2] accel clip
    tilt_max: float = 0.12   # [rad] tilt-reference deviation clip
    # attitude inner loop (cyclic residuals)
    k_att: float = 1.5       # cyclic per rad of attitude error
    k_rate: float = 0.40     # cyclic per rad/s of body rate
    # yaw hold
    k_psi: float = 1.2       # pedal per rad of heading error
    k_r: float = 1.2         # pedal per rad/s of yaw rate
    k_cp: float = 1.3        # pedal per unit of collective residual
    resid_max: float = 0.5   # final residual clip (keeps executed in-band)


# Observation layout (ops/eom.py):
#   0 power_hp, 1-3 uvw_air, 4-6 ned_vel, 7-9 phi/theta/psi,
#   10-12 p/q/r, 13-14 x/y, 15 alt_sea, 16 alt_ground

def landing_residual(obs: torch.Tensor, g: ApproachGains, trim_att) -> torch.Tensor:
    """Pure feedback law: raw obs (..., 17) -> action residual (..., 4).
    `trim_att` = (phi, theta, psi) of the act_bias trim point; attitude and
    heading errors reference it, so a zero error reproduces the trim."""
    phi0, theta0, psi0 = (float(a) for a in trim_att)
    vn, ve, vd = obs[..., 4], obs[..., 5], obs[..., 6]
    phi, theta, psi = obs[..., 7], obs[..., 8], obs[..., 9]
    p, q, r = obs[..., 10], obs[..., 11], obs[..., 12]
    x, y, agl = obs[..., 13], obs[..., 14], obs[..., 16]
    clip = torch.clamp

    # vertical: descent-rate profile with the brisk-entry floor
    floor = g.v_floor * clip((g.floor_agl - agl) / 3.0, 0.0, 1.0)
    vd_ref = clip(torch.maximum(g.k_agl * (agl - g.agl_td), floor), 0.0, g.vmax)

    c, s = torch.cos(psi), torch.sin(psi)
    ex, ey = c * x + s * y, -s * x + c * y          # pad error, body-heading
    vx, vy = c * vn + s * ve, -s * vn + c * ve      # ground vel, body-heading

    # commit gate
    pen = (torch.abs(phi) / g.gate_phi + torch.abs(p) / g.gate_p
           + torch.abs(q) / g.gate_q + torch.abs(vy) / g.gate_vy)
    gate = clip(2.0 - pen, 0.0, 1.0)                # 1 = quiet, commit
    w_z = (clip((g.gate_hi - agl) / (g.gate_hi - g.gate_lo), 0.0, 1.0)
           * clip((agl - g.gate_lo) / 0.4, 0.0, 1.0))
    hold = w_z * (1.0 - gate)
    vd_ref = (1.0 - hold) * vd_ref - hold * g.gate_climb

    w_gnd = clip((g.gnd_agl - agl) / 0.8, 0.0, 1.0)
    d_coll = (g.k_w + w_gnd * g.k_w_gnd) * (vd - vd_ref)
    ax = clip(-(g.k_pos * ex + g.k_vel * vx), -g.a_max, g.a_max)
    ay = clip(-(g.k_pos * ey + g.k_vel * vy), -g.a_max, g.a_max)
    G = 32.174
    # forward accel needs pitch below trim; east accel needs roll above
    theta_ref = theta0 + clip(-ax / G, -g.tilt_max, g.tilt_max)
    phi_ref = phi0 + clip(ay / G, -g.tilt_max, g.tilt_max)
    # level through the gear capture band; authority returns at rest
    w_lvl = (clip((g.lvl_hi - agl) / (g.lvl_hi - g.lvl_lo), 0.0, 1.0)
             * clip((agl - g.lvl_end) / g.lvl_end_w, 0.0, 1.0))
    theta_ref = (1.0 - w_lvl) * theta_ref
    phi_ref = (1.0 - w_lvl) * phi_ref + w_lvl * g.phi_td
    # boost only above band entry
    w_boost = w_lvl * clip((agl - g.lvl_lo) / 0.3, 0.0, 1.0)
    boost = 1.0 + g.lvl_boost * w_boost
    k_att, k_rate = g.k_att * boost, g.k_rate * boost
    d_lon = k_att * (theta - theta_ref) + k_rate * q       # +lon pitches down
    d_lat = k_att * (phi_ref - phi) - k_rate * p           # +lat rolls right
    d_lon = d_lon - w_gnd * g.k_gv * vx                    # +lon -> +forward
    d_lat = d_lat - w_gnd * g.k_gv * vy                    # +lat -> +east

    # yaw hold; a floor modulo, as jnp's `%` (torch.fmod would not wrap).
    # XLA folds `- psi0 + pi` into one float32 constant; so does this.
    shift = float(np.float32(math.pi) - np.float32(psi0))
    dpsi = torch.remainder(psi + shift, 2.0 * math.pi) - math.pi
    d_ped = g.k_psi * dpsi + g.k_r * r + g.k_cp * d_coll   # +ped -> -r

    resid = torch.stack([d_coll, d_lon, d_lat, d_ped], dim=-1)
    return clip(resid, -g.resid_max, g.resid_max)


def make_scripted_policy(env, gains: ApproachGains | None = None):
    """(act_bias, trim_att, fn) where fn(obs) -> residual for this env's
    trim point; act_bias (4,) float32 on the env's device. The host trim is
    solved (or read from the trim cache) once, here."""
    g = gains or ApproachGains()
    tr = env.trim_result()
    trim_att = (float(tr.state.phi), float(tr.state.theta), float(tr.state.psi))
    act_bias = tr.action.to(device=env.device, dtype=torch.float32)

    def fn(obs):
        return landing_residual(obs, g, trim_att)

    return act_bias, trim_att, fn
