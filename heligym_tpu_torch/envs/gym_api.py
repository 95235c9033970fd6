"""Gymnasium classes over the port: `Heli`, its six task subclasses and
`HeliVectorGymEnv`.

Counterparts of the JAX package's `envs/gym_api.py`, with its names,
metadata, setters, seeding and SAME_STEP autoreset. The work is in
`gym_core`: every step is one launch of the fused step kernel on the card
(its plain version on the CPU) and one device-to-host copy.

Differences from the JAX classes:
  * `device=None` means the CUDA card, and raises where there is none, as
    `HeliEnv.build` does; pass `device="cpu"` for the CPU. (The JAX single
    env defaults to the host CPU.)
  * The Dryden noise comes from a `torch.Generator` on the env's device,
    seeded at each reset; the JAX classes split a PRNG key. A seed gives
    the same episode again in either package, not the same noise in both.
  * The renderer is the port's (`heligym_tpu_torch.render`), created at the
    first `render()` call.
"""
from __future__ import annotations

import copy
from typing import Optional

import gymnasium as gym
import numpy as np
from gymnasium import spaces
from gymnasium.utils import EzPickle

from ..utils.constants import DT, FPS
from .env import ACT_DIM, OBS_DIM, HeliEnv
from .gym_core import TASKS, BatchCore, SingleCore
from .tasks import HoverTask, Task


class Heli(gym.Env, EzPickle):
    """Single-env gymnasium interface; each step one fused-step launch."""

    metadata = {
        "render_modes": ["human", "rgb_array"],
        # the reference's legacy keys, kept as the JAX class keeps them
        "render.modes": ["human", "rgb_array"],
        "video.frames_per_second": FPS,
        "render_fps": FPS,
    }

    default_max_time = 40.0
    default_trim_cond = {
        "yaw": 0.0, "yaw_rate": 0.0, "ned_vel": [0.0, 0.0, 0.0],
        "gr_alt": 100.0, "xy": [0.0, 0.0], "psi_mr": 0.0, "psi_tr": 0.0,
    }

    _task_cls = TASKS["Heli"]

    def __init__(self, heli_name: str = "aw109", render_mode: Optional[str] = None,
                 device: Optional[str] = None):
        EzPickle.__init__(self, heli_name=heli_name, render_mode=render_mode,
                          device=device)
        self.heli_name = heli_name
        self.render_mode = render_mode
        self._core = SingleCore(HeliEnv.build(heli_name, task=self._task_cls(),
                                              device=device))

        self.observation_space = spaces.Box(-np.inf, np.inf, shape=(OBS_DIM,),
                                            dtype=np.float32)
        self.action_space = spaces.Box(-1.0, +1.0, (ACT_DIM,), dtype=np.float32)

        self.set_max_time()
        self.set_target()
        self.set_trim_cond()
        self.set_reward_weights()
        n = self._core.env.normalizers
        self.normalizers = {"t": n.t, "x": n.x, "v": n.v, "a": n.a}

        self._renderer = None
        self._np_seed = 0

    # ------------------------------------------------------------------ API
    def set_max_time(self, max_time: Optional[float] = None):
        """Episode duration and the success and task windows derived from it."""
        self.max_time = self.default_max_time if max_time is None else max_time
        self.success_duration = self.max_time / 4.0
        self.task_duration = self.max_time / 4.0
        self._core.env = self._core.env.replace(max_time=self.max_time)

    def set_target(self, target: Optional[dict] = None):
        task = self._core.env.task
        if target:
            task = task.with_target(**target)
        self.task_target = task.target_dict()
        self._core.env = self._core.env.replace(task=task)

    def get_target(self):
        return copy.deepcopy(self.task_target)

    def set_trim_cond(self, trim_cond: Optional[dict] = None):
        self.trim_cond = copy.deepcopy(self.default_trim_cond)
        self.trim_cond.update(trim_cond or {})

    def get_trim_cond(self):
        return copy.deepcopy(self.trim_cond)

    def set_reward_weights(self, base_reward_weight=None, terminal_reward_weight=None):
        """Stored for API parity; the task rewards do not read them (as in
        the reference)."""
        zero = np.zeros((OBS_DIM, OBS_DIM))
        self.base_reward_weight = zero if base_reward_weight is None else base_reward_weight
        self.terminal_reward_weight = zero if terminal_reward_weight is None else terminal_reward_weight

    # ---------------------------------------------------------------- core
    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._np_seed = seed
        self._core.generator.manual_seed(self._np_seed)
        self._np_seed += 1
        if options and "trim_cond" in options:
            self.set_trim_cond(options["trim_cond"])
        obs = self._core.reset(self.trim_cond)
        return obs[0], {"failed": False, "successed": False, "time_up": False}

    def step(self, actions):
        actions = np.asarray(actions, np.float32)
        if actions.shape != (ACT_DIM,):
            raise ValueError(
                f"action must have shape ({ACT_DIM},), got {actions.shape}")
        out = self._core.step(actions[None])
        info = {"failed": bool(out.failed[0]), "successed": bool(out.successed[0]),
                "time_up": bool(out.truncated[0])}
        return (out.obs[0], float(out.reward[0]), bool(out.done[0]),
                bool(out.truncated[0]), info)

    @property
    def time_counter(self) -> float:
        return float(self._core.counters()[0, 0]) * DT if self._core.started else 0.0

    @property
    def successed_time(self) -> float:
        return float(self._core.counters()[1, 0]) * DT if self._core.started else 0.0

    # -------------------------------------------------------------- render
    def render(self):
        from ..render import get_renderer   # lazy: never in the step path
        if self._renderer is None:
            self._renderer = get_renderer(self._core.env)
        return self._renderer.render(self._core.state(),
                                     mode=self.render_mode or "rgb_array")

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


class HeliVectorGymEnv(gym.vector.VectorEnv):
    """Gymnasium VectorEnv over B envs stepped together on the env's device,
    auto-reset included; each step one fused-step launch.

    Autoreset follows gymnasium's SAME_STEP convention: a terminating step
    returns the fresh episode's first obs, and the terminal (pre-reset)
    observation is in `info["final_obs"]` (gymnasium >= 1.0) and
    `info["final_observation"]` (the 0.29 name), with the `_final_*` masks
    and per-env `final_info` dicts."""

    metadata = {"autoreset_mode": gym.vector.AutoresetMode.SAME_STEP}

    def __init__(self, num_envs: int, heli_name: str = "aw109",
                 task: Optional[Task] = None, device: Optional[str] = None):
        self._core = BatchCore(HeliEnv.build(heli_name, task=task or HoverTask(),
                                             device=device), num_envs)
        self.num_envs = num_envs
        self.single_observation_space = spaces.Box(
            -np.inf, np.inf, shape=(OBS_DIM,), dtype=np.float32)
        self.single_action_space = spaces.Box(-1.0, 1.0, (ACT_DIM,),
                                              dtype=np.float32)
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(
            self.single_action_space, num_envs)
        self._trim_cond = None

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        # Gymnasium semantics: an unseeded reset draws fresh entropy (two
        # unseeded resets differ), while any explicit seed, 0 included, is
        # reproducible.
        if seed is None:
            seed = int(np.random.SeedSequence().entropy & 0x7FFFFFFFFFFFFFFF)
        self._core.generator.manual_seed(seed)
        if self._trim_cond is None:     # the first reset's condition stays
            self._trim_cond = (options or {}).get("trim_cond") or {}
        return self._core.reset(self._trim_cond), {}

    def step(self, actions):
        out = self._core.step(np.asarray(actions, np.float32))
        done, trunc = out.done, out.truncated
        info = {"failed": out.failed, "successed": out.successed}
        ended = done | trunc
        if ended.any():
            obs_arr = np.full(self.num_envs, None, dtype=object)
            info_arr = np.full(self.num_envs, None, dtype=object)
            for i in np.nonzero(ended)[0]:
                obs_arr[i] = out.final_obs[i]
                info_arr[i] = {"failed": bool(out.failed[i]),
                               "successed": bool(out.successed[i])}
            info["final_obs"] = obs_arr
            info["_final_obs"] = ended
            info["final_observation"] = obs_arr        # gymnasium < 1.0 name
            info["_final_observation"] = ended
            info["final_info"] = info_arr
            info["_final_info"] = ended
        return out.obs, out.reward, done, trunc, info

    def close(self):
        pass


class HeliHover(Heli):
    """Hover task."""
    _task_cls = TASKS["HeliHover"]


class HeliForwardFlight(Heli):
    """Forward-flight task."""
    _task_cls = TASKS["HeliForwardFlight"]


class HeliObliqueFlight(Heli):
    """Oblique-flight task."""
    _task_cls = TASKS["HeliObliqueFlight"]


class HeliTurningFlight(Heli):
    """Turning-flight task."""
    _task_cls = TASKS["HeliTurningFlight"]


class HeliSlalom(Heli):
    """Slalom maneuver task."""
    _task_cls = TASKS["HeliSlalom"]


class HeliLanding(Heli):
    """Landing / ground task."""
    _task_cls = TASKS["HeliLanding"]


__all__ = ["Heli", "HeliForwardFlight", "HeliHover", "HeliLanding",
           "HeliObliqueFlight", "HeliSlalom", "HeliTurningFlight",
           "HeliVectorGymEnv"]
