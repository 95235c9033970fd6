"""The state and per-step work of the gymnasium facades, without gymnasium.

`SingleCore` steps one env without auto-reset (`gym_api.Heli`); `BatchCore`
steps B envs with auto-reset in gymnasium's SAME_STEP convention
(`gym_api.HeliVectorGymEnv`). Each holds its `HeliEnv`, the trims it has
solved (one per condition), a `torch.Generator` on the env's device and the
packed carry and init blocks of the fused step (`ops/cuda/fused_step.py`).

A step draws the Dryden noise from the generator, keeps the success counter
from before the step (the env's success criterion reads it there; the
collect block has no such row), runs one `fused_step` launch (the CUDA
kernel on the card, its plain version on the CPU) and brings back every
output in one device-to-host copy. The env is read at each launch, so an
env replaced by a setter (`max_time`, target) steps from the next launch on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.cuda import fused_step as fs
from .env import ACT_DIM, EnvState, HeliEnv
from .tasks import (ForwardFlightTask, HoverTask, LandingTask,
                    ObliqueFlightTask, SlalomTask, Task, TurningFlightTask)
from .trim import TrimResult
from .vector import broadcast_state

# the task of each single-env class of `gym_api` (and gymnasium id,
# `heligym_tpu_torch.ENV_IDS`)
TASKS = {"Heli": Task, "HeliHover": HoverTask,
         "HeliForwardFlight": ForwardFlightTask,
         "HeliObliqueFlight": ObliqueFlightTask,
         "HeliTurningFlight": TurningFlightTask, "HeliSlalom": SlalomTask,
         "HeliLanding": LandingTask}


@dataclasses.dataclass(frozen=True)
class StepResult:
    """One step's outputs on the host, a leading axis of B envs: obs after
    any auto-reset (B, 17), reward (B,), done, truncated, failed, successed
    (B,) bool, and final_obs (B, 17), the obs before the auto-reset."""
    obs: np.ndarray
    reward: np.ndarray
    done: np.ndarray
    truncated: np.ndarray
    failed: np.ndarray
    successed: np.ndarray
    final_obs: np.ndarray


class _Core:
    """B envs on `env.device`, stepped by one `fused_step` launch each."""

    def __init__(self, env: HeliEnv, num_envs: int, auto_reset: bool):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.generator = torch.Generator(device=env.device)
        self.trims: Dict[tuple, TrimResult] = {}
        dev, n = env.device, num_envs
        self.carry = torch.zeros((fs.CROWS, n), device=dev)
        self.init = torch.zeros((fs.IROWS, n), device=dev)
        # the last step's action and noise; its collect rows, then the
        # success counter before it
        self.act = torch.zeros((n, ACT_DIM), device=dev)
        self.eta = torch.zeros((3, n), device=dev)
        self.out = torch.zeros((fs.XROWS + 1, n), device=dev)
        self._host = torch.zeros((fs.XROWS + 1, n),
                                 pin_memory=dev.type == "cuda")
        self._template: Optional[EnvState] = None

    # -- state --------------------------------------------------------------
    def trim(self, trim_cond: Optional[dict] = None) -> TrimResult:
        """The env's trim at `trim_cond`, solved once per condition."""
        key = tuple(sorted((k, str(v)) for k, v in (trim_cond or {}).items()))
        if key not in self.trims:
            self.trims[key] = self.env.trim_result(trim_cond)
        return self.trims[key]

    def reset(self, trim_cond: Optional[dict] = None) -> np.ndarray:
        """Every env at the trim of `trim_cond`; returns obs (B, 17)."""
        es, _ = self.env.reset_from_trim(self.trim(trim_cond))
        self.load(broadcast_state(es, self.num_envs))
        return self.carry[fs.O0:fs.D0].T.cpu().numpy()

    def load(self, es: EnvState) -> None:
        """Take a batched EnvState of B envs as the current state."""
        carry, init = fs.pack(es)
        if carry.shape != self.carry.shape:
            raise ValueError(f"expected a state of {self.num_envs} envs, "
                             f"got {carry.shape[1]}")
        self.carry.copy_(carry)
        self.init.copy_(init)
        self._template = es

    @property
    def started(self) -> bool:
        """Whether a state was loaded (by a reset)."""
        return self._template is not None

    def state(self) -> EnvState:
        """The current EnvState (views of the carry block)."""
        if not self.started:
            raise RuntimeError("reset the env before reading its state")
        return fs.unpack(self._template, self.carry)

    # -- step ---------------------------------------------------------------
    def _draw_eta(self) -> torch.Tensor:
        torch.randn((3, self.num_envs), generator=self.generator, out=self.eta)
        return self.eta.mul_((1.0 / self.env.dt) ** 0.5)

    def step(self, actions: np.ndarray) -> StepResult:
        """One transition of every env under `actions` (B, 4)."""
        return self.step_with_eta(actions, self._draw_eta())

    def step_with_eta(self, actions, eta) -> StepResult:
        """One transition with the Dryden noise `eta` (3, B), already scaled
        by 1/sqrt(dt): the seam the parity tests inject JAX's noise through."""
        if not self.started:
            raise RuntimeError("reset the env before stepping it")
        actions = torch.as_tensor(np.asarray(actions, np.float32))
        if tuple(actions.shape) != (self.num_envs, ACT_DIM):
            raise ValueError(f"actions must have shape ({self.num_envs}, {ACT_DIM}), "
                             f"got {tuple(actions.shape)}")
        self.act.copy_(actions)
        if eta is not self.eta:
            self.eta.copy_(torch.as_tensor(eta, dtype=torch.float32))
        self.out[fs.XROWS].copy_(self.carry[fs.SUCC])
        fs.fused_step(self.env, self.carry, self.init, self.act, self.eta,
                      auto_reset=self.auto_reset, carry_out=self.carry,
                      collect_out=self.out[:fs.XROWS])
        h = self._host.copy_(self.out).numpy()
        flag = lambda row: h[row] != 0
        return StepResult(obs=h[fs.COBS0:fs.CSUCC].T.copy(), reward=h[fs.CREW].copy(),
                          done=flag(fs.CDONE), truncated=flag(fs.CTRUNC),
                          failed=flag(fs.CFAIL),
                          successed=h[fs.XROWS] >= self.env.success_steps_required,
                          final_obs=h[fs.CFINAL0:fs.XROWS].T.copy())

    def counters(self) -> np.ndarray:
        """(steps, successed_steps) of every env, (2, B) int."""
        return self.carry[fs.STEPS:fs.SUCC + 1].cpu().numpy().astype(np.int64)


class SingleCore(_Core):
    """One env, no auto-reset: an ended episode runs on until a reset."""

    def __init__(self, env: HeliEnv):
        super().__init__(env, 1, auto_reset=False)


class BatchCore(_Core):
    """`num_envs` envs, each auto-reset to its snapshot where it ends."""

    def __init__(self, env: HeliEnv, num_envs: int):
        super().__init__(env, num_envs, auto_reset=True)
