"""Sharded env farm: thousands of lockstep envs split over the ranks of a
mesh's `env` dimension.

The port of the JAX package's `parallel/farm.py`. Each rank holds its own
rows of the farm (`mesh.py`) and steps them through the fused step, the
CUDA kernel on the card and its plain version on the CPU; stepping is
elementwise over envs, so no rank talks to another while the farm steps.
Reductions over the whole farm (`farm_metrics`) are all-reduces.

Layout invariance: every random draw is of the GLOBAL block, from a
generator that every rank holds in the same state, and each rank keeps its
own rows: the Dryden noise (3, num_envs) of a step, (steps, 3, num_envs) of
a rollout. Env i therefore sees the same noise whatever the number of
ranks, and the generators stay in lockstep (the JAX package folds per-env
keys from the global env index for the same end).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..envs.env import EnvState, HeliEnv, StepOutput
from ..envs.vector import VectorHeliEnv
from .mesh import all_reduce, shard_of, shard_rows


@dataclasses.dataclass(frozen=True, eq=False)
class EnvFarm:
    """A VectorHeliEnv of `num_envs` envs split over a mesh's env
    dimension: `venv` holds this rank's `num_envs // R` of them."""
    venv: VectorHeliEnv
    mesh: object
    num_envs: int

    @classmethod
    def build(cls, env: HeliEnv, num_envs: int, mesh=None,
              auto_reset: bool = True) -> "EnvFarm":
        """`num_envs` is the farm's global size; without a mesh this process
        holds all of it."""
        _, count = shard_of(mesh)
        if num_envs % count != 0:
            raise ValueError(f"num_envs={num_envs} not divisible by {count} devices")
        return cls(venv=VectorHeliEnv(env, num_envs // count, auto_reset), mesh=mesh,
                   num_envs=num_envs)

    @property
    def rows(self) -> slice:
        """This rank's rows of the global farm."""
        return shard_rows(self.num_envs, self.mesh)

    def reset(self, trim_cond: Optional[dict] = None) -> Tuple[EnvState, torch.Tensor]:
        """This rank's rows of a farm reset to one host trim."""
        return self.venv.reset(trim_cond)

    def step_fn(self):
        """`step(es, actions, generator=None) -> (es', StepOutput)`: one
        `fused_step` over this rank's envs (`es`, `actions` (B/R, 4) are its
        rows), with its columns of the global noise draw."""
        from ..ops.cuda import fused_step as fs
        venv = self.venv
        env = venv.env

        def step(es: EnvState, actions, generator: Optional[torch.Generator] = None):
            eta = torch.randn((3, self.num_envs), generator=generator,
                              device=es.obs.device) * (1.0 / env.dt) ** 0.5
            eta = eta[:, self.rows].contiguous()
            successed = es.successed_steps >= env.success_steps_required
            carry, init = fs.pack(es)
            carry, x = fs.fused_step(env, carry, init, actions.contiguous(), eta,
                                     auto_reset=venv.auto_reset, carry_out=carry)
            done, trunc = x[fs.CDONE] != 0, x[fs.CTRUNC] != 0
            out = StepOutput(obs=x[fs.COBS0:fs.CSUCC].T, reward=x[fs.CREW], done=done,
                             truncated=trunc, failed=x[fs.CFAIL] != 0,
                             successed=successed, time_up=trunc)
            return fs.unpack(es, carry), out
        return step

    def rollout_fn(self, policy: Callable, steps: int):
        """`rollout(es, policy_params, generator=None) -> (es', StepOutput
        stacked over steps)`, with `policy(policy_params, obs) -> actions`
        on this rank's envs each step."""
        step = self.step_fn()

        def rollout(es: EnvState, policy_params, generator: Optional[torch.Generator] = None):
            outs = []
            for _ in range(steps):
                es, out = step(es, policy(policy_params, es.obs), generator)
                outs.append(out)
            return es, StepOutput(**{f.name: torch.stack([getattr(o, f.name) for o in outs])
                                     for f in dataclasses.fields(StepOutput)})
        return rollout


def build_sharded_fused_rollout(env: HeliEnv, num_envs: int, steps: int, mesh=None,
                                collect=("reward", "done"), auto_reset: bool = True):
    """Multi-rank fused rollout: each rank runs `build_fused_rollout` (one
    T-step launch of the CUDA kernel on the card) on its own `num_envs // R`
    envs; there is no communication in the rollout. Returns `rollout(es,
    actions, eta_seq=None, generator=None) -> (es', outs)` over this rank's
    rows: `actions` its (B/R, 4) held or (steps, B/R, 4) per step;
    `eta_seq` the GLOBAL (steps, 3, num_envs) noise, already scaled by
    1/sqrt(dt), or None to draw it from `generator`; `outs` its columns of
    the outputs."""
    from ..ops.cuda.fused_step import build_fused_rollout

    rows = shard_rows(num_envs, mesh)
    local = rows.stop - rows.start
    inner = build_fused_rollout(env, local, steps, collect=collect,
                                auto_reset=auto_reset, eta_mode="inject")

    def rollout(es: EnvState, actions, eta_seq=None,
                generator: Optional[torch.Generator] = None):
        if eta_seq is None:
            eta_seq = torch.randn((steps, 3, num_envs), generator=generator,
                                  device=es.obs.device) * (1.0 / env.dt) ** 0.5
        return inner(es, actions, eta_seq[..., rows].contiguous())
    return rollout


def farm_metrics(out: StepOutput, mesh=None) -> dict:
    """Means and the minimum reward over the whole farm: this rank's sums
    and count, then one all-reduce under SUM and one under MIN."""
    flags = [out.done, out.truncated, out.failed]
    sums = torch.stack([out.reward.sum()] + [f.to(torch.float32).sum() for f in flags]
                       + [torch.tensor(float(out.reward.numel()), device=out.reward.device)])
    low = out.reward.min().reshape(1).clone()
    all_reduce(sums, mesh, "sum")
    all_reduce(low, mesh, "min")
    mean = sums[:4] / sums[4]
    return {"reward_mean": mean[0], "reward_min": low[0], "done_frac": mean[1],
            "truncated_frac": mean[2], "failed_frac": mean[3]}
