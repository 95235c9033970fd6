"""The plain env step of the benchmark's reference.

Assembled from the port's `envs/env.py` (the physics sub-steps, the failure
test, the step counters) and the plain version of its fused step
(`ops/cuda/fused_step.py::fused_step_plain`), on the same row layout:

  carry (63, B): 0-17 heli | 18-22 wind | 23-39 obs | 40-57 dots |
    58-60 wind_ned | 61 steps | 62 successed_steps
  init (62, B): rows 0-60 of a fresh episode's carry | 61 task id
  collect (39, B) per step: 0 reward | 1 done | 2 truncated | 3 failed |
    4-20 obs after auto-reset | 21 succ_step | 22-38 obs before auto-reset

Every operation is an elementwise PyTorch call on (B,) rows, in the order of
the port's plain version, so that on one device the two agree bit for bit
where the arithmetic is the same. The start of a farm is the host trim,
solved here by the copied Newton solver (`trim.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import dryden, eom, terrain as terrain_ops
from .constants import D2R, DT
from .integrator import rk4, rk4_k4only
from .mathx import pi_bound
from .registry import load_params
from .state import HeliState, WindState
from .tasks import (ForwardFlightTask, HoverTask, LandingTask, MixedTask, Normalizers,
                    ObliqueFlightTask, SlalomTask, Task, TurningFlightTask)
from .trim import trim

TASKS = {"hover": HoverTask, "forward": ForwardFlightTask, "oblique": ObliqueFlightTask,
         "turning": TurningFlightTask, "slalom": SlalomTask, "landing": LandingTask}

H0, W0, O0, D0, N0 = 0, 18, 23, 40, 58
SROWS, STEPS, SUCC, CROWS = 61, 61, 62, 63
ITID, IROWS = 61, 62
CREW, CDONE, CTRUNC, CFAIL, COBS0, CSUCC, CFINAL0, XROWS = 0, 1, 2, 3, 4, 21, 22, 39


def non_finite(x):
    return (x != x) | (torch.abs(x) > 1e30)


def _accum_steps_until(threshold: float, dt: float, strict: bool) -> int:
    acc, n = 0.0, 0
    limit = int(threshold / dt) + 3
    while n <= limit:
        if (acc > threshold) if strict else (acc >= threshold):
            return n
        acc += dt
        n += 1
    return n


@dataclasses.dataclass(frozen=True, eq=False)
class Sim:
    """Airframe, task, terrain and wind of one configuration."""
    params: object
    task: Task
    terrain: terrain_ops.Terrain
    wind_params: dryden.WindParams
    max_time: float = 40.0
    dt: float = DT

    @classmethod
    def build(cls, airframe: str, tasks, target: Optional[str], device,
              turbulence_level: Optional[int] = None) -> "Sim":
        """`tasks`: one task name, or several for a task-conditioned
        MixedTask; `target`: 'k=v,...' overrides where 'start' is the
        terrain's gear-contact altitude plus 100 ft at the origin."""
        params = load_params(airframe)
        terrain = terrain_ops.load_terrain(params.ENV, device=device)
        wind = dryden.WindParams.from_env(params.ENV)
        if turbulence_level is not None:
            wind = dataclasses.replace(wind, turbulence_level=int(turbulence_level))
        subs = [TASKS[n]() for n in tasks]
        if target:
            upd = {}
            zero = torch.zeros((), dtype=torch.float32)
            contact = float(terrain_ops.ground_touching_altitude(
                params, terrain.to("cpu"), zero, zero))
            for kv in target.split(","):
                k, v = (s.strip() for s in kv.split("="))
                upd[k] = contact + 100.0 if v == "start" else float(v)
            subs = [t.with_target(**{k: v for k, v in upd.items() if k in t.target_dict()})
                    for t in subs]
        task = MixedTask(tasks=tuple(subs)) if len(subs) > 1 else subs[0]
        return cls(params=params, task=task, terrain=terrain, wind_params=wind)

    @property
    def mixed(self) -> bool:
        return isinstance(self.task, MixedTask)

    @property
    def normalizers(self) -> Normalizers:
        return Normalizers.from_params(self.params)

    @property
    def time_up_steps(self) -> int:
        return _accum_steps_until(self.max_time, self.dt, strict=True)

    @property
    def success_steps_required(self) -> int:
        return _accum_steps_until(self.max_time / 4.0, self.dt, strict=False)

    # -- physics ------------------------------------------------------------
    def heli_step_with_h(self, heli: HeliState, action4, wind_ned3, h_ground):
        def f(s):
            dots, obs, _ = eom.heli_dynamics(self.params, s, action4, wind_ned3, h_ground)
            return dots, obs

        new, k4, obs = rk4(f, heli, self.dt)
        new = new.replace(psi_mr=pi_bound(new.psi_mr), psi_tr=pi_bound(new.psi_tr),
                          b0=pi_bound(new.b0), b1=pi_bound(new.b1),
                          phi=pi_bound(new.phi), theta=pi_bound(new.theta),
                          psi=pi_bound(new.psi))
        return new, k4, obs

    def wind_step(self, wind: WindState, wind_action4, eta3):
        def f(s):
            return dryden.wind_dynamics(self.wind_params, s, wind_action4, eta3)

        new, _, wind_ned = rk4_k4only(f, wind, self.dt)
        return new, wind_ned

    def step_physics(self, heli, wind, wind_action4, eta3, action4, h_ground, task_id=None):
        wind_new, wind_ned = self.wind_step(wind, wind_action4, eta3)
        heli_new, dots, obs = self.heli_step_with_h(heli, action4, wind_ned, h_ground)
        reward, success_step = self.task.reward(self.normalizers, heli_new, dots,
                                                task_id=task_id)
        return wind_new, wind_ned, heli_new, dots, obs, reward, success_step

    def is_failed(self, heli: HeliState, dots: HeliState, h_ground):
        p = self.params
        touch_alt = h_ground + p.HELI.WL_CG / 12.0
        cond1 = (-heli.z) - touch_alt < 0.0
        cond2 = dots.z > p.MR.V_TIP * 0.05
        cond3 = heli.phi > 60.0 * D2R
        cond4 = heli.theta > 60.0 * D2R
        cond5 = ((torch.abs(heli.x) > p.ENV.NS_MAX / 2.0)
                 | (torch.abs(heli.y) > p.ENV.EW_MAX / 2.0)
                 | ((-heli.z) > touch_alt + 10000.0))
        return (cond1 & (cond2 | cond3 | cond4)) | cond5

    def step(self, carry, init, act, eta, auto_reset: bool = True):
        """(carry (63, B), init (62, B), act (B, 4), eta (3, B)) ->
        (carry', collect (39, B))."""
        heli = HeliState.from_rows(carry[H0:W0])
        wind = WindState.from_rows(carry[W0:O0])
        obs = carry[O0:D0]
        h_ground = terrain_ops.ground_height(self.terrain, heli.x, heli.y)
        wind_new, wnd, heli_new, dots, obs_t, reward, succ_step = self.step_physics(
            heli, wind, (obs[4], obs[5], obs[6], obs[16]), (eta[0], eta[1], eta[2]),
            tuple(act[:, i] for i in range(4)), h_ground,
            task_id=init[ITID].to(torch.int32))

        steps1 = carry[STEPS] + 1.0
        succ0 = carry[SUCC]
        f_succ = succ0 >= float(self.success_steps_required)
        time_up = steps1 >= float(self.time_up_steps)
        succ1 = succ0 + succ_step.to(torch.float32)

        h_post = terrain_ops.ground_height(self.terrain, heli_new.x, heli_new.y)
        bad = non_finite(reward) | non_finite(heli_new.z) | non_finite(heli_new.u)
        failed = self.is_failed(heli_new, dots, h_post) | bad
        done = failed | f_succ

        final_obs = torch.stack(obs_t)
        state = torch.cat([heli_new.rows(), wind_new.rows(), final_obs, dots.rows(),
                           torch.stack(wnd)], dim=0)
        if auto_reset:
            ended = done | time_up
            state = torch.where(ended, init[:SROWS], state)
            steps1 = torch.where(ended, 0.0, steps1)
            succ1 = torch.where(ended, 0.0, succ1)
        carry_new = torch.cat([state, steps1[None], succ1[None]], dim=0)
        f = lambda b: b.to(torch.float32)[None]
        collect = torch.cat([reward[None], f(done), f(time_up), f(failed),
                             state[O0:D0], f(succ_step), final_obs], dim=0)
        return carry_new, collect

    # -- the start of a farm --------------------------------------------------
    def trim_cond(self) -> dict:
        return {"yaw": 0.0, "yaw_rate": 0.0, "ned_vel": [0.0, 0.0, 0.0],
                "gr_alt": 100.0, "xy": [0.0, 0.0], "psi_mr": 0.0, "psi_tr": 0.0}

    def start(self, num_envs: int, task_ids=None, device=None):
        """(carry (63, B), init (62, B), trim action (4,)) of a farm whose
        every env starts at the host trim under the mean wind, the Dryden
        filters at zero; `task_ids` (B,) selects a MixedTask's sub-task."""
        tr = trim(self.params, self.terrain.to("cpu"), dryden.mean_wind(self.wind_params),
                  self.trim_cond())
        wind_mean = dryden.mean_wind(self.wind_params)
        col = torch.cat([tr.state.flatten(), torch.zeros(5), tr.obs, tr.dots.flatten(),
                         wind_mean.to(torch.float32)])
        rows = col[:, None].expand(SROWS, num_envs)
        zeros = torch.zeros((1, num_envs))
        tid = (torch.zeros((1, num_envs)) if task_ids is None
               else torch.as_tensor(np.asarray(task_ids), dtype=torch.float32)[None])
        carry = torch.cat([rows, zeros, zeros], dim=0).contiguous().to(device)
        init = torch.cat([rows, tid], dim=0).contiguous().to(device)
        return carry, init, tr.action.to(device)
