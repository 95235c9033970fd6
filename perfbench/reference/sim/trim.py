# Frozen copy of heligym_tpu_torch/envs/trim.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Trim solver: host Newton iteration zeroing the normalized state derivatives.

The algorithm of the JAX package's host `trim`, step for step: the same 16
variables and scalings, a central-difference Jacobian with eps=1e-4 whose 32
perturbed residuals are ONE batched call, and the backtracking line search
with the reference's quirk of aborting on its last halving without taking an
improvement found there. It stops after 200 Newton iterations (the reference
stops on a 5-second wall clock; an iteration cap is deterministic).

The solve runs on the CPU in float32: it is an init-time scalar Newton with
tight host coupling. The caller's reset moves the result to the env's device
once.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from . import eom
from . import terrain as terrain_ops
from .state import HeliState
from .constants import EPS
from .mathx import cdiv

N_VARS = 16
_MAX_NEWTON_ITERS = 200


@dataclasses.dataclass(frozen=True)
class TrimResult:
    state: HeliState
    action: torch.Tensor   # (4,)
    obs: torch.Tensor      # (17,)
    dots: HeliState        # derivatives at the trim point (≈ 0 for trimmed vars)

    def to(self, device) -> "TrimResult":
        mv = lambda t: t.to(device)
        return TrimResult(state=self.state.map(mv), action=mv(self.action),
                          obs=mv(self.obs), dots=self.dots.map(mv))


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def base_state_from_cond(params, terrain, cond) -> HeliState:
    """Fixed (non-iterated) state fields from the trim condition."""
    s = HeliState.zeros()
    s = s.replace(psi=_f32(cond["yaw"]), psi_mr=_f32(cond["psi_mr"]),
                  psi_tr=_f32(cond["psi_tr"]), x=_f32(cond["xy"][0]),
                  y=_f32(cond["xy"][1]))
    touch = terrain_ops.ground_touching_altitude(params, terrain, s.x, s.y)
    return s.replace(z=-touch - float(np.float32(cond["gr_alt"])))


def apply_x(params, base: HeliState, x) -> Tuple[HeliState, torch.Tensor]:
    """Scatter the normalized trim variables (..., 16) into a state + action:
    [vi_mr, vi_tr, betas(2), uvw(3), pqr(3), phi, theta, action(4)]."""
    MR, TR = params.MR, params.TR
    state = base.replace(
        vi_mr=x[..., 0] * MR.V_TIP, vi_tr=x[..., 1] * TR.V_TIP,
        b0=x[..., 2], b1=x[..., 3],
        u=x[..., 4] * MR.V_TIP, v=x[..., 5] * MR.V_TIP, w=x[..., 6] * MR.V_TIP,
        p=x[..., 7] * MR.OMEGA, q=x[..., 8] * MR.OMEGA, r=x[..., 9] * MR.OMEGA,
        phi=x[..., 10], theta=x[..., 11])
    return state, x[..., 12:16]


def _normalized_dots(params, dots: HeliState) -> torch.Tensor:
    """(..., 16) normalized derivatives in the reference's order."""
    MR, TR = params.MR, params.TR
    return torch.stack([
        cdiv(dots.vi_mr, MR.V_TIP), cdiv(dots.vi_tr, TR.V_TIP),
        dots.b0, dots.b1,
        cdiv(dots.u, MR.V_TIP), cdiv(dots.v, MR.V_TIP), cdiv(dots.w, MR.V_TIP),
        cdiv(dots.p, MR.OMEGA), cdiv(dots.q, MR.OMEGA), cdiv(dots.r, MR.OMEGA),
        dots.phi, dots.theta, dots.psi,
        cdiv(dots.x, MR.R), cdiv(dots.y, MR.R), cdiv(dots.z, MR.R),
    ], dim=-1)


def residual_fn(params, terrain, wind_ned, cond):
    """The residual y(x) of normalized state derivatives, for x of shape
    (16,) or (N, 16). The terrain height is sampled once at the base state
    (the committed-state semantics of the reference)."""
    base = base_state_from_cond(params, terrain, cond)
    h_ground = terrain_ops.ground_height(terrain, base.x, base.y)
    wind3 = tuple(wind_ned[..., i] for i in range(3))

    def residual(x):
        state, action = apply_x(params, base, x)
        dots, _, _ = eom.heli_dynamics(
            params, state, tuple(action[..., i] for i in range(4)), wind3,
            h_ground)
        return _normalized_dots(params, dots)

    return base, h_ground, residual


def initial_guess(params, cond):
    y_target = np.zeros(N_VARS, dtype=np.float32)
    y_target[-4] = cond["yaw_rate"]
    y_target[-3:] = np.array(cond["ned_vel"], dtype=np.float32) / params.MR.R
    uvw0 = np.array(cond["ned_vel"], dtype=np.float32) / params.MR.V_TIP
    x = np.array([0.05, 0.05, 0.0, 0.0,
                  uvw0[-3], uvw0[-2], uvw0[-1],
                  0.0, 0.0, y_target[-4],
                  -0.01, 0.01,
                  0.0, 0.0, 0.0, 0.0], dtype=np.float32)
    return x, y_target


@torch.no_grad()
def trim(params, terrain, wind_ned, cond) -> TrimResult:
    """Host Newton trim on CPU tensors (`terrain` and `wind_ned` on the CPU)."""
    base, h_ground, residual = residual_fn(params, terrain, wind_ned, cond)

    def res(x_np):
        return residual(torch.from_numpy(x_np)).numpy().astype(np.float32)

    x, y_target = initial_guess(params, cond)
    y = res(x)
    tol = float((y - y_target).T @ (y - y_target))

    iters = 0
    while tol > EPS:
        iters += 1
        if iters > _MAX_NEWTON_ITERS:
            raise RuntimeError("Trim failed to converge; try a better trim condition.")
        # Central-difference Jacobian, one batched call of 32 residuals.
        eye = np.eye(N_VARS, dtype=np.float32) * EPS
        xs = np.concatenate([x[None] + eye, x[None] - eye], axis=0)
        ys = res(xs)
        dydx = (ys[:N_VARS] - ys[N_VARS:]) / (2 * EPS)   # rows: dy/dx_i
        dydx = np.stack(list(dydx), axis=-1)             # (16, 16)
        step_dir = np.linalg.inv(dydx) @ (y - y_target)

        step_size = 1.0
        for j in range(10):
            x_new = x - step_size * step_dir
            y_new = res(x_new)
            tol_new = float((y_new - y_target).T @ (y_new - y_target))
            step_size *= 0.5
            if tol_new < tol:
                break
        if j == 9:
            # Reference quirk: aborts without accepting an improvement found
            # on the final halving.
            break
        x, y, tol = x_new, y_new, tol_new

    state, action = apply_x(params, base, torch.from_numpy(x))
    dots, obs_t, _ = eom.heli_dynamics(
        params, state, tuple(action[i] for i in range(4)),
        tuple(wind_ned[..., i] for i in range(3)), h_ground)
    amax = float(action.abs().max())
    if amax > 1.0:
        warnings.warn(
            f"trim action out of the [-1, 1] control range (max |a|={amax:.2f})"
            f" for cond {cond}: the solution is not flyable. Known cause: "
            "gr_alt at or below the landing-gear reach puts the trim point in "
            "ground contact; use a higher start altitude.", stacklevel=2)
    return TrimResult(state=state, action=action, obs=torch.stack(obs_t),
                      dots=dots)
