# Frozen copy of heligym_tpu_torch/envs/tasks.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""RL task definitions: reward shaping + per-step success predicates.

Tasks are static dataclasses whose targets are constants. `reward` receives
the post-step state and the k4 state derivatives, and keeps every reduction
in the reference's sequential order.

Rounding follows the JAX package's expressions so that the port's CPU
tensors, its CUDA tensors and the fused CUDA kernel agree bit for bit: a
division by a Python constant is a multiply by the float32 reciprocal
(`cdiv`), a division by a tensor is a true division, and every target is
folded on the host by `folded()` — in float64 where the JAX code multiplies
Python floats, in float32 where it starts from `jnp.float32(...)` — then
rounded to float32 once where it meets a tensor. `reward` and the fused
kernel's task table (`ops/cuda/fused_step.py::task_table`) both read
`folded()`, so they cannot disagree on a target.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .kinematics import euler_to_rotmat, matvec, transpose_rows
from .state import HeliState
from .mathx import cdiv


@dataclasses.dataclass(frozen=True)
class Normalizers:
    """Reward normalizers from rotor radius and gravity."""
    t: float
    x: float
    v: float
    a: float

    @classmethod
    def from_params(cls, p) -> "Normalizers":
        return cls(t=math.sqrt(2.0 * p.MR.R / p.ENV.GRAV),
                   x=2.0 * p.MR.R,
                   v=math.sqrt(2.0 * p.MR.R * p.ENV.GRAV),
                   a=p.ENV.GRAV)


def _shaped(final_reward, terminal_reward):
    return torch.maximum(final_reward, terminal_reward)


def _f32(a: float) -> float:
    return float(np.float32(a))


def f32_quotient(a: float, b: float) -> float:
    """float32(a) / float32(b) in float32: how the JAX tasks scale a target
    (`jnp.float32(target) / norm`)."""
    return float(np.float32(a) / np.float32(b))


@dataclasses.dataclass(frozen=True)
class Task:
    """Base task: zero reward, never succeeds.

    `reward(norm, state, dots, task_id=None)` — `task_id` is a per-env i32
    used only by `MixedTask`; plain tasks ignore it (the env always threads
    it through). `KIND` names the task for the fused kernel's task table."""
    KIND = "none"

    def target_dict(self) -> Dict[str, float]:
        return {}

    def with_target(self, **updates) -> "Task":
        return dataclasses.replace(self, **updates)

    def folded(self, norm: Normalizers) -> Tuple[float, ...]:
        """The task's targets as `reward` uses them, folded on the host."""
        return ()

    def reward(self, norm: Normalizers, state: HeliState, dots: HeliState,
               task_id=None):
        return (torch.zeros_like(state.vi_mr),
                torch.zeros_like(state.vi_mr, dtype=torch.bool))


def _pqr_rewards(norm, state, dots, yaw_rate: float = 0.0):
    """Body-rate terms; `yaw_rate` is the yaw-rate target (x - 0.0 is x, so
    the tasks without one share the expression)."""
    pn, qn = state.p * norm.t, state.q * norm.t
    rn = (state.r - yaw_rate) * norm.t
    t2 = norm.t ** 2
    pdn, qdn, rdn = dots.p * t2, dots.q * t2, dots.r * t2
    final = -((pn * pn + qn * qn) + rn * rn)
    terminal = -((torch.sign(pn) * pdn + torch.sign(qn) * qdn)
                 + torch.sign(rn) * rdn)
    return final, terminal


def _tracked(err, rate):
    """(final, shaped reward) of one tracked quantity: quadratic final term,
    derivative-based terminal term, max-combined."""
    final = -(err * err)
    return final, _shaped(final, -(torch.sign(err) * rate))


def _altitude_term(norm, state, dots, dwn_target: float):
    return _tracked(cdiv(state.z, norm.x) - dwn_target, cdiv(dots.z, norm.v))


def _speed(state):
    return torch.sqrt((state.u * state.u + state.v * state.v)
                      + state.w * state.w)


def _speed_rate(state, dots):
    return (state.u * dots.u + state.v * dots.v) + state.w * dots.w


@dataclasses.dataclass(frozen=True)
class HoverTask(Task):
    """Hold position/altitude."""
    KIND = "hover"
    sea_alt: float = 4000.0
    north_loc: float = 0.0
    east_loc: float = 0.0

    def target_dict(self):
        return {"sea_alt": self.sea_alt, "north_loc": self.north_loc,
                "east_loc": self.east_loc}

    def folded(self, norm):
        """(north, east, down) targets over norm.x, as the reward subtracts
        them."""
        return (f32_quotient(self.north_loc, norm.x),
                f32_quotient(self.east_loc, norm.x),
                f32_quotient(-self.sea_alt, norm.x))

    def reward(self, norm, state, dots, task_id=None):
        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        tn, te, td = self.folded(norm)
        en = cdiv(state.x, norm.x) - tn
        ee = cdiv(state.y, norm.x) - te
        ed = cdiv(state.z, norm.x) - td
        xyz_final = -((en * en + ee * ee) + ed * ed)
        xdn, ydn, zdn = (cdiv(dots.x, norm.v), cdiv(dots.y, norm.v),
                         cdiv(dots.z, norm.v))
        xyz_terminal = -((torch.sign(en) * xdn + torch.sign(ee) * ydn)
                         + torch.sign(ed) * zdn)
        xyz_reward = _shaped(xyz_final, xyz_terminal)

        reward = cdiv(pqr_reward + xyz_reward, 2.0)
        success = (pqr_final > -1.0) & (xyz_final > -1.0)
        return reward, success


@dataclasses.dataclass(frozen=True)
class ForwardFlightTask(Task):
    """Hold speed/altitude. Like the reference, the heading target is
    carried but not used by the reward, and the speed-derivative term
    divides by the current speed: at zero speed it yields the same inf/nan
    the reference yields."""
    KIND = "forward"
    sea_alt: float = 4000.0
    heading: float = 0.0
    vel: float = 100.0

    def target_dict(self):
        return {"sea_alt": self.sea_alt, "heading": self.heading, "vel": self.vel}

    def folded(self, norm):
        return (self.vel / norm.v, -self.sea_alt / norm.x)

    def reward(self, norm, state, dots, task_id=None):
        vel_target, dwn_target = self.folded(norm)
        vel = _speed(state)
        veldot_norm = cdiv(_speed_rate(state, dots) / vel, norm.a)
        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)
        vel_final, vel_reward = _tracked(cdiv(vel, norm.v) - vel_target,
                                         veldot_norm)
        dwn_final, dwn_reward = _altitude_term(norm, state, dots, dwn_target)

        reward = cdiv((pqr_reward + vel_reward) + dwn_reward, 3.0)
        success = (pqr_final > -1.0) & (vel_final > -1.0) & (dwn_final > -1.0)
        return reward, success


@dataclasses.dataclass(frozen=True)
class TurningFlightTask(Task):
    """Hold a coordinated turn: constant yaw rate at constant speed and
    altitude."""
    KIND = "turning"
    sea_alt: float = 4000.0
    vel: float = 60.0
    yaw_rate: float = 0.15        # [rad/s]

    def target_dict(self):
        return {"sea_alt": self.sea_alt, "vel": self.vel,
                "yaw_rate": self.yaw_rate}

    def folded(self, norm):
        return (_f32(self.yaw_rate), self.vel / norm.v, -self.sea_alt / norm.x)

    def reward(self, norm, state, dots, task_id=None):
        yaw_rate, vel_target, dwn_target = self.folded(norm)
        # roll/pitch rates should vanish; yaw rate should match the target
        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots, yaw_rate)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        vel = _speed(state)
        veldot_norm = cdiv(_speed_rate(state, dots) / torch.clamp(vel, min=1e-3),
                           norm.a)
        vel_final, vel_reward = _tracked(cdiv(vel, norm.v) - vel_target,
                                         veldot_norm)
        dwn_final, dwn_reward = _altitude_term(norm, state, dots, dwn_target)

        reward = cdiv((pqr_reward + vel_reward) + dwn_reward, 3.0)
        success = (pqr_final > -1.0) & (vel_final > -1.0) & (dwn_final > -1.0)
        return reward, success


@dataclasses.dataclass(frozen=True)
class SlalomTask(Task):
    """Weave along a sinusoidal lateral reference while flying north: track
    east-position y_ref(x) = amplitude * sin(2 pi x / wavelength) at constant
    speed and altitude."""
    KIND = "slalom"
    sea_alt: float = 4000.0
    vel: float = 80.0
    amplitude: float = 150.0      # [ft] lateral weave amplitude
    wavelength: float = 2000.0    # [ft] weave period along north

    def target_dict(self):
        return {"sea_alt": self.sea_alt, "vel": self.vel,
                "amplitude": self.amplitude, "wavelength": self.wavelength}

    def folded(self, norm):
        two_pi_l = 2.0 * math.pi / self.wavelength
        amp = np.float32(self.amplitude)
        return (float(amp), two_pi_l, float(amp * np.float32(two_pi_l)),
                self.vel / norm.v, -self.sea_alt / norm.x)

    def reward(self, norm, state, dots, task_id=None):
        amp, two_pi_l, amp_two_pi_l, vel_target, dwn_target = self.folded(norm)
        y_ref = amp * torch.sin(two_pi_l * state.x)
        ydot_ref = amp_two_pi_l * torch.cos(two_pi_l * state.x) * dots.x
        track_final, track_reward = _tracked(cdiv(state.y - y_ref, norm.x),
                                             cdiv(dots.y - ydot_ref, norm.v))

        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        # northbound ground speed
        vel_final, vel_reward = _tracked(cdiv(dots.x, norm.v) - vel_target,
                                         cdiv(dots.u, norm.a))
        dwn_final, dwn_reward = _altitude_term(norm, state, dots, dwn_target)

        reward = cdiv(((pqr_reward + track_reward) + vel_reward) + dwn_reward,
                      4.0)
        success = ((pqr_final > -1.0) & (track_final > -1.0)
                   & (vel_final > -1.0) & (dwn_final > -1.0))
        return reward, success


@dataclasses.dataclass(frozen=True)
class LandingTask(Task):
    """Descend to a gentle touchdown at a target pad: minimize ground
    altitude over the pad with bounded descent rate and level attitude;
    success while settled on the ground (the env's crash detection still
    fails hard or attitude-violating contacts)."""
    KIND = "landing"
    pad_north: float = 0.0
    pad_east: float = 0.0
    max_touch_rate: float = 3.0   # [ft/s] gentle-touchdown descent limit
    # Sea-level altitude of gear contact at the pad; when set, per-step
    # success additionally requires the CG within 5 ft above it, so "settled"
    # means ON the ground, not merely motionless. None keeps the
    # altitude-agnostic behavior.
    touch_alt: Optional[float] = None

    def target_dict(self):
        return {"pad_north": self.pad_north, "pad_east": self.pad_east,
                "max_touch_rate": self.max_touch_rate,
                "touch_alt": self.touch_alt}

    def folded(self, norm):
        """(pad north, pad east, desired sink, touch_alt + 5, has touch_alt)."""
        has = self.touch_alt is not None
        ceiling = (float(np.float32(self.touch_alt) + np.float32(5.0))
                   if has else 0.0)
        return (_f32(self.pad_north), _f32(self.pad_east),
                f32_quotient(self.max_touch_rate, norm.v), ceiling,
                1.0 if has else 0.0)

    def reward(self, norm, state, dots, task_id=None):
        pad_n, pad_e, desired_sink, ceiling, has_ceiling = self.folded(norm)
        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        en = cdiv(state.x - pad_n, norm.x)
        ee = cdiv(state.y - pad_e, norm.x)
        pad_final = -(en * en + ee * ee)
        pad_terminal = -cdiv(torch.sign(en) * dots.x + torch.sign(ee) * dots.y,
                             norm.v)
        pad_reward = _shaped(pad_final, pad_terminal)

        # reward descending toward the ground but punish fast descent near
        # it; state.z is NED down so dots.z > 0 descends
        sink_err = cdiv(dots.z, norm.v) - desired_sink
        sink_reward = -(sink_err * sink_err)

        reward = cdiv((pqr_reward + pad_reward) + sink_reward, 3.0)
        # settled: essentially motionless and level
        speed2 = (state.u * state.u + state.v * state.v) + state.w * state.w
        success = ((speed2 < 4.0) & (torch.abs(state.phi) < 0.15)
                   & (torch.abs(state.theta) < 0.15) & (pad_final > -1.0))
        if has_ceiling:
            success = success & ((-state.z) < ceiling)
        return reward, success


@dataclasses.dataclass(frozen=True)
class ObliqueFlightTask(Task):
    """Fly at a course offset from the nose heading while holding altitude:
    the horizontal NED velocity must match `vel` along course
    `heading + azimuth`."""
    KIND = "oblique"
    sea_alt: float = 4000.0
    heading: float = 0.0
    vel: float = 100.0
    azimuth: float = math.pi / 4.0   # [rad] course offset from heading

    def target_dict(self):
        return {"sea_alt": self.sea_alt, "heading": self.heading,
                "vel": self.vel, "azimuth": self.azimuth}

    def folded(self, norm):
        course = self.heading + self.azimuth
        return (f32_quotient(self.vel * math.cos(course), norm.v),
                f32_quotient(self.vel * math.sin(course), norm.v),
                -self.sea_alt / norm.x)

    def reward(self, norm, state, dots, task_id=None):
        tv_n, tv_e, dwn_target = self.folded(norm)
        # dots.{x,y} are the NED velocity; NED acceleration is approximated
        # by rotating the body-frame acceleration (adequate for shaping).
        vn = cdiv(dots.x, norm.v)
        ve = cdiv(dots.y, norm.v)
        body2earth = transpose_rows(euler_to_rotmat(state.phi, state.theta,
                                                    state.psi))
        acc = matvec(body2earth, (dots.u, dots.v, dots.w))
        an, ae = cdiv(acc[0], norm.a), cdiv(acc[1], norm.a)

        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        en, ee = vn - tv_n, ve - tv_e
        vel_final = -(en * en + ee * ee)
        vel_terminal = -(torch.sign(en) * an + torch.sign(ee) * ae)
        vel_reward = _shaped(vel_final, vel_terminal)
        dwn_final, dwn_reward = _altitude_term(norm, state, dots, dwn_target)

        reward = cdiv((pqr_reward + vel_reward) + dwn_reward, 3.0)
        success = (pqr_final > -1.0) & (vel_final > -1.0) & (dwn_final > -1.0)
        return reward, success


@dataclasses.dataclass(frozen=True)
class MixedTask(Task):
    """Task-conditioned multi-task batches: each env carries an i32
    `task_id` in its EnvState selecting one of `tasks`. Every sub-reward is
    computed and one selected per env; the success selection is carried in
    float and compared once at the end, as in the JAX package."""
    KIND = "mixed"
    tasks: tuple = ()

    def target_dict(self):
        return {f"task{i}": t.target_dict() for i, t in enumerate(self.tasks)}

    def reward(self, norm, state, dots, task_id=None):
        if not self.tasks:
            raise ValueError("MixedTask needs at least one sub-task")
        if task_id is None:
            return self.tasks[0].reward(norm, state, dots)
        reward = torch.zeros_like(state.vi_mr)
        success_f = torch.zeros_like(state.vi_mr)
        for i, t in enumerate(self.tasks):
            r_i, s_i = t.reward(norm, state, dots)
            sel = task_id == i
            reward = torch.where(sel, r_i, reward)
            success_f = torch.where(sel, s_i.to(reward.dtype), success_f)
        return reward, success_f > 0.5
