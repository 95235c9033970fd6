"""Vectorized env: lockstep batched stepping with on-device auto-reset.

The state's fields carry a leading batch axis; the env's step functions are
elementwise over it, so the batched eager step is the single-env step on
(B,) tensors. This eager step is the port's own reference for the fused CUDA
step (`ops/cuda/fused_step.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops import dryden
from ..ops.state import WindState
from .env import EnvState, HeliEnv, ResetSnapshot, StepOutput, map_tensors
from .trim import TrimResult, trim_batched


def broadcast_state(es: EnvState, n: int) -> EnvState:
    """Tile a single-env EnvState across a leading batch axis (a copy, so the
    envs' tensors never alias)."""
    return map_tensors(lambda x: x.expand((n,) + x.shape).clone(), es)


def _assemble_batched(tr: TrimResult, wind_mean: torch.Tensor, n: int) -> EnvState:
    """EnvState from a batched TrimResult: each env's snapshot is its own
    trim, the Dryden filters start at zero under the mean wind, and the
    counters and task ids at 0. No two fields share storage."""
    dev = tr.obs.device
    wind0 = WindState.zeros((n,), device=dev)
    wm = wind_mean.to(dev).expand(n, 3)
    snap = ResetSnapshot(heli=tr.state, wind=wind0, dots=tr.dots, obs=tr.obs,
                         wind_ned=wm)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    es = EnvState(heli=tr.state, wind=wind0, dots=tr.dots, obs=tr.obs, wind_ned=wm,
                  steps=zero, successed_steps=zero, init=snap, task_id=zero)
    return map_tensors(lambda x: x.clone(), es)


def auto_reset(new_es: EnvState, out: StepOutput) -> Tuple[EnvState, StepOutput]:
    """Where an episode ended, replace the sim state with its ResetSnapshot
    (gymnasium autoreset convention: the returned obs is the fresh episode's
    first obs; reward/flags describe the terminating step)."""
    ended = out.done | out.truncated

    def pick(init_leaf, new_leaf):
        mask = ended.reshape(ended.shape + (1,) * (new_leaf.dim() - ended.dim()))
        return torch.where(mask, init_leaf, new_leaf)

    snap = new_es.init
    pick_state = lambda a, b: type(a)(**{f: pick(getattr(a, f), getattr(b, f))
                                         for f in a.FIELDS})
    zeros_i = torch.zeros_like(new_es.steps)
    es = new_es.replace(
        heli=pick_state(snap.heli, new_es.heli),
        wind=pick_state(snap.wind, new_es.wind),
        dots=pick_state(snap.dots, new_es.dots),
        obs=pick(snap.obs, new_es.obs),
        wind_ned=pick(snap.wind_ned, new_es.wind_ned),
        steps=torch.where(ended, zeros_i, new_es.steps),
        successed_steps=torch.where(ended, zeros_i, new_es.successed_steps),
    )
    return es, out.replace(obs=pick(snap.obs, out.obs))


@dataclasses.dataclass(frozen=True, eq=False)
class VectorHeliEnv:
    """Batch of envs stepping in lockstep on the env's device."""
    env: HeliEnv
    num_envs: int
    auto_reset: bool = True

    def reset(self, trim_cond: Optional[dict] = None) -> Tuple[EnvState, torch.Tensor]:
        """Solve the trim once on the host and broadcast it to every env."""
        return self.reset_from_trim(self.env.trim_result(trim_cond))

    def reset_from_trim(self, tr: TrimResult) -> Tuple[EnvState, torch.Tensor]:
        es_single, _ = self.env.reset_from_trim(tr)
        es = broadcast_state(es_single, self.num_envs)
        return es, es.obs

    def reset_randomized(self, generator: torch.Generator, cond_sampler
                         ) -> Tuple[EnvState, torch.Tensor]:
        """Per-env initial conditions through the batched Newton trim:
        `cond_sampler(generator, n)` gives a dict of batched trim conditions
        (see `trim.trim_batched`) on `generator`'s device; every env's
        auto-reset returns it to its own trim."""
        conds = cond_sampler(generator, self.num_envs)
        wind_mean = dryden.mean_wind(self.env.wind_params, device=self.env.device)
        tr = trim_batched(self.env.params, self.env.terrain, wind_mean, conds).result
        es = _assemble_batched(tr, wind_mean, self.num_envs)
        return es, es.obs

    def assign_tasks(self, es: EnvState, task_ids) -> EnvState:
        """Per-env task assignment for MixedTask batches. `task_ids`:
        (num_envs,) int indices into the MixedTask's sub-task tuple.
        Assignments persist across auto-resets."""
        ids = torch.as_tensor(task_ids).to(device=es.steps.device,
                                           dtype=torch.int32)
        if ids.shape != es.steps.shape:
            raise ValueError(f"task_ids: expected shape {tuple(es.steps.shape)}, "
                             f"got {tuple(ids.shape)}")
        return es.replace(task_id=ids)

    def step_with_eta(self, es: EnvState, actions, eta) -> Tuple[EnvState, StepOutput]:
        """Lockstep transition with injected noise `eta` (num_envs, 3)."""
        new_es, out = self.env.step_with_eta(es, actions, eta)
        if self.auto_reset:
            new_es, out = auto_reset(new_es, out)
        return new_es, out

    def step(self, es: EnvState, actions,
             generator: Optional[torch.Generator] = None) -> Tuple[EnvState, StepOutput]:
        """Lockstep batched transition; `actions` is (num_envs, 4)."""
        eta = torch.randn((self.num_envs, 3), generator=generator,
                          device=es.obs.device) * (1.0 / self.env.dt) ** 0.5
        return self.step_with_eta(es, actions, eta)


def rollout(venv: VectorHeliEnv, es: EnvState, policy: Callable, steps: int,
            policy_params=None, generator: Optional[torch.Generator] = None):
    """Eager rollout: `policy(policy_params, obs) -> actions` each step.
    Returns (final_state, StepOutput stacked over time with leading axis
    `steps`)."""
    outs = []
    for _ in range(steps):
        es, out = venv.step(es, policy(policy_params, es.obs), generator)
        outs.append(out)
    stacked = StepOutput(**{f.name: torch.stack([getattr(o, f.name) for o in outs])
                            for f in dataclasses.fields(StepOutput)})
    return es, stacked
