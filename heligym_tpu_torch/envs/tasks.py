"""RL task definitions: reward shaping + per-step success predicates.

Tasks are static dataclasses whose targets are constants. `reward` receives
the post-step state and the k4 state derivatives, and keeps every reduction
in the reference's sequential order. This slice of the port has the base
`Task` and `HoverTask`; the other tasks and `MixedTask` live in the JAX
package only so far.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.state import HeliState
from ..utils.math import cdiv


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


def f32_quotient(a: float, b: float) -> float:
    """float32(a) / float32(b) in float32: how the JAX tasks scale a target
    (`jnp.float32(target) / norm`)."""
    return float(np.float32(a) / np.float32(b))


@dataclasses.dataclass(frozen=True)
class Task:
    """Base task: zero reward, never succeeds. `task_id` is accepted and
    ignored (only the JAX package's `MixedTask` reads it)."""

    def reward(self, norm: Normalizers, state: HeliState, dots: HeliState,
               task_id=None):
        return (torch.zeros_like(state.vi_mr),
                torch.zeros_like(state.vi_mr, dtype=torch.bool))


def _pqr_rewards(norm, state, dots):
    pn, qn, rn = state.p * norm.t, state.q * norm.t, state.r * norm.t
    t2 = norm.t ** 2
    pdn, qdn, rdn = dots.p * t2, dots.q * t2, dots.r * t2
    final = -((pn * pn + qn * qn) + rn * rn)
    terminal = -((torch.sign(pn) * pdn + torch.sign(qn) * qdn)
                 + torch.sign(rn) * rdn)
    return final, terminal


@dataclasses.dataclass(frozen=True)
class HoverTask(Task):
    """Hold position/altitude."""
    sea_alt: float = 4000.0
    north_loc: float = 0.0
    east_loc: float = 0.0

    def targets_normalized(self, norm):
        """(north, east, down) targets over norm.x, as the reward subtracts
        them."""
        return (f32_quotient(self.north_loc, norm.x),
                f32_quotient(self.east_loc, norm.x),
                f32_quotient(-self.sea_alt, norm.x))

    def reward(self, norm, state, dots, task_id=None):
        pqr_final, pqr_terminal = _pqr_rewards(norm, state, dots)
        pqr_reward = _shaped(pqr_final, pqr_terminal)

        tn, te, td = self.targets_normalized(norm)
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
