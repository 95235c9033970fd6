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

`trim_batched` is the JAX package's batched Newton for randomized resets:
one solve per env on the device of its conditions, with an exact
forward-mode Jacobian, a batched (B, 16, 16) solve and all ten halvings of
the line search evaluated at once. It converges to the host solver's fixed
points within tolerance but is not bit-identical to it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ..ops import eom
from ..ops import terrain as terrain_ops
from ..ops.state import HeliState
from ..utils.constants import EPS
from ..utils.math import cdiv

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


def _batched_base(params, terrain, conds) -> HeliState:
    """Per-env base states (fields (B,)) from batched trim conditions."""
    zero = torch.zeros_like(conds["yaw"])
    s = HeliState(**{f: zero for f in HeliState.FIELDS}).replace(
        psi=conds["yaw"], psi_mr=conds["psi_mr"], psi_tr=conds["psi_tr"],
        x=conds["xy"][:, 0], y=conds["xy"][:, 1])
    touch = terrain_ops.ground_touching_altitude(params, terrain, s.x, s.y)
    return s.replace(z=-touch - conds["gr_alt"])


class BatchedSolve(NamedTuple):
    result: TrimResult
    iterations: int            # Newton iterations the slowest env ran
    sq_residual: torch.Tensor  # (B,) squared residual at each env's result


def trim_batched(params, terrain, wind_ned, conds: Mapping, max_iters: int = 50
                 ) -> BatchedSolve:
    """Batched Newton trim, one solve per env, on the device of `conds`.

    `conds` maps yaw, yaw_rate, gr_alt, psi_mr, psi_tr to (B,) and ned_vel
    to (B, 3), xy to (B, 2) arrays (tensors, or numpy arrays for the CPU).
    The semantics of the JAX package's `trim_batched`: each env iterates
    while its squared residual exceeds EPS and fewer than `max_iters`
    iterations ran; a step takes the first of ten halvings that improves,
    and an env with none stops where it is. Returns the TrimResult (fields
    with a leading (B,) axis) with the iteration count and each env's final
    squared residual."""
    dev = conds["gr_alt"].device if torch.is_tensor(conds["gr_alt"]) else torch.device("cpu")
    c = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in conds.items()}
    terrain = terrain.to(dev)
    wind3 = tuple(wind_ned.to(dev)[..., i] for i in range(3))
    n = c["gr_alt"].shape[0]
    base = _batched_base(params, terrain, c)
    h_ground = terrain_ops.ground_height(terrain, base.x, base.y)

    def residual(tiles: int, x):
        """Residuals of x (tiles * B, 16) against the base states tiled."""
        b = base.map(lambda t: t.repeat(tiles))
        state, action = apply_x(params, b, x)
        dots, _, _ = eom.heli_dynamics(
            params, state, tuple(action[..., i] for i in range(4)), wind3,
            h_ground.repeat(tiles))
        return _normalized_dots(params, dots)

    def sq_err(y):
        """(tiles, B) squared residuals of (tiles * B, 16) residuals."""
        d = y.view(-1, n, N_VARS) - y_target
        return (d * d).sum(-1)

    zero = torch.zeros_like(c["yaw_rate"])
    vel_r = cdiv(c["ned_vel"], params.MR.R)
    y_target = torch.stack([zero] * 12 + [c["yaw_rate"], vel_r[:, 0], vel_r[:, 1],
                                          vel_r[:, 2]], dim=-1)
    uvw0 = cdiv(c["ned_vel"], params.MR.V_TIP)
    const = lambda v: torch.full_like(zero, v)
    x = torch.stack([const(0.05), const(0.05), zero, zero, uvw0[:, 0], uvw0[:, 1],
                     uvw0[:, 2], zero, zero, c["yaw_rate"], const(-0.01), const(0.01),
                     zero, zero, zero, zero], dim=-1)
    with torch.no_grad():
        tol = sq_err(residual(1, x))[0]
    # one-hot tangents: row k * B + b carries d/dx_k for env b
    tangents = torch.eye(N_VARS, device=dev).repeat_interleave(n, dim=0)
    scales = 2.0 ** -torch.arange(10, dtype=torch.float32, device=dev)
    envs = torch.arange(n, device=dev)
    iters = 0
    for _ in range(max_iters):
        active = tol > EPS
        if not bool(active.any()):
            break
        iters += 1
        y, jy = torch.func.jvp(lambda xs: residual(N_VARS, xs),
                               (x.repeat(N_VARS, 1),), (tangents,))
        with torch.no_grad():
            jac = jy.view(N_VARS, n, N_VARS).permute(1, 2, 0)     # (B, dy, dx)
            step, info = torch.linalg.solve_ex(jac, (y[:n] - y_target)[..., None])
            # a singular Jacobian gives no step, so no improving halving
            step = torch.where(info[:, None] == 0, step[..., 0], float("nan"))
            cands = x[None] - scales[:, None, None] * step[None]   # (10, B, 16)
            tols = sq_err(residual(10, cands.reshape(10 * n, N_VARS)))
            improving = tols < tol
            first = improving.to(torch.int32).argmax(0)
            found = improving.any(0)
            x_new = torch.where(found[:, None], cands[first, envs], x)
            tol_new = torch.where(found, tols[first, envs], -1.0)
            x = torch.where(active[:, None], x_new, x)
            tol = torch.where(active, tol_new, tol)
    with torch.no_grad():
        state, action = apply_x(params, base, x)
        dots, obs_t, _ = eom.heli_dynamics(
            params, state, tuple(action[..., i] for i in range(4)), wind3, h_ground)
        final = sq_err(residual(1, x))[0]
    return BatchedSolve(TrimResult(state=state, action=action,
                                   obs=torch.stack(obs_t, dim=-1), dots=dots),
                        iters, final)
