"""PPO's collection side: the policy in the loop of the fused env step.

So far the port holds what collecting experience and evaluating a
policy need from the JAX package's `learner/ppo.py`: the configuration, the
observation statistics, the task-conditioned network input, the stochastic
policy with its log-std ceiling, and the rollout through
`build_fused_policy_rollout` with its reward sanitising and value bootstrap.
The update itself (statistics merge, GAE, loss, minibatch epochs, the train
step and loop) is not ported yet.

Where the JAX learner passes a flax parameter tree, the port passes the
`ActorCritic` module that holds the parameters; where it passes a PRNG key,
the port passes a `torch.Generator` on the env's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..envs.env import EnvState, HeliEnv
from ..envs.vector import VectorHeliEnv
from .networks import ActorCritic, gaussian_log_prob, obs_scales


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The fields of the JAX package's PPOConfig that collection and
    evaluation read, with its defaults; the update's fields join them with
    the update."""
    num_envs: int = 1024
    rollout_steps: int = 64
    hidden: Tuple[int, ...] = (256, 256)
    # Running mean/var observation normalization (on top of the fixed
    # physical scales), frozen within an update.
    obs_norm: bool = True
    # Center executed actions on the nominal hover-trim action: the env runs
    # clip(trim_action + a) where a ~ N(mean, std) is the learned residual.
    center_actions: bool = True
    log_std_init: float = -0.5
    # Scheduled exploration-std ceiling: the effective log-std is
    # min(learned, cap(t)) with cap decaying linearly from log_std_init to
    # `std_cap_final` over `std_cap_updates` updates. 0 updates = off.
    std_cap_final: float = -3.5
    std_cap_updates: int = 0


@dataclasses.dataclass(frozen=True)
class ObsStats:
    """Running statistics of the SCALED observation (after the fixed
    physical normalizers)."""
    mean: torch.Tensor     # (17,)
    var: torch.Tensor      # (17,)
    count: torch.Tensor    # () f32

    @classmethod
    def init(cls, device=None):
        return cls(mean=torch.zeros(17, device=device),
                   var=torch.ones(17, device=device),
                   count=torch.tensor(1e-4, device=device))


@dataclasses.dataclass(frozen=True)
class TrainState:
    """What collection and evaluation carry: the network (its parameters),
    the env farm, the update counter and the observation statistics. The
    optimizer state joins it with the PPO update."""
    params: ActorCritic
    env_state: Optional[EnvState]
    update_count: int
    obs_stats: ObsStats

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Transition:
    """One rollout, leading axes (T, B)."""
    obs: torch.Tensor
    action: torch.Tensor     # the raw residual action the loss sees
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    # Termination (failed/successed) and time-limit truncation are kept
    # separate: GAE bootstraps V(final_obs) through truncation-only resets.
    terminated: torch.Tensor
    truncated: torch.Tensor
    v_boot: torch.Tensor     # V(pre-reset next obs), current params
    failed: torch.Tensor     # crash/OOB flag per transition
    succ_step: torch.Tensor  # per-transition in-tolerance flag
    task_oh: torch.Tensor    # (T, B, K) task one-hot, K = 0 on single-task runs


class PPOLearner:
    """The collection side of PPO for a HeliEnv, on the env's device."""

    def __init__(self, env: HeliEnv, config: PPOConfig = PPOConfig()):
        self.env = env
        self.config = config
        self.venv = VectorHeliEnv(env, config.num_envs, auto_reset=True)
        # MixedTask: the policy must know which task each env is on, so a
        # task one-hot from EnvState.task_id is appended to the network
        # input (task_dim = 0 on single-task envs: nothing changes).
        self.task_dim = len(getattr(env.task, "tasks", ()))
        # executed action = clip(act_bias + residual); (4,) f32 constant
        self.act_bias = (env.trim_result().action.to(env.device)
                         if config.center_actions
                         else torch.zeros(4, device=env.device))
        self._scales = torch.from_numpy(obs_scales(env.params)).to(env.device)
        self._fused_rollout = None

    # ------------------------------------------------------------- setup
    def make_network(self, generator: Optional[torch.Generator] = None) -> ActorCritic:
        """A freshly initialised network on the env's device; `generator` (a
        CPU generator) seeds the orthogonal init."""
        return ActorCritic(in_dim=17 + self.task_dim, action_dim=4,
                           hidden=self.config.hidden,
                           log_std_init=self.config.log_std_init,
                           generator=generator).to(self.env.device)

    def init(self, generator: Optional[torch.Generator] = None,
             trim_cond: Optional[dict] = None, task_ids=None) -> TrainState:
        """Fresh network and env farm. `task_ids` (num_envs,) assigns
        MixedTask sub-tasks per env."""
        es, _ = self.venv.reset(trim_cond)
        if task_ids is not None:
            es = self.venv.assign_tasks(es, task_ids)
        return TrainState(params=self.make_network(generator), env_state=es,
                          update_count=0,
                          obs_stats=ObsStats.init(self.env.device))

    def _norm(self, obs, stats: Optional[ObsStats] = None):
        """Fixed physical scaling, then (optionally) running standardization.
        Collection and the loss must use the SAME stats snapshot.

        The scaled obs is sanitized and clipped: a blowing-up env can emit
        obs up to ~1e30 before the non-finite failsafe terminates it, and a
        single such row would NaN a whole update. Sane data lives in O(1)
        scaled units; +-50 only clips garbage."""
        x = obs / self._scales
        x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=50.0, neginf=-50.0),
                        -50.0, 50.0)
        if stats is not None:
            x = torch.clamp((x - stats.mean) * torch.rsqrt(stats.var + 1e-8),
                            -10.0, 10.0)
        return x

    def _task_oh(self, task_id) -> torch.Tensor:
        """(..., task_dim) one-hot of EnvState.task_id (an id outside the
        range gives a zero row); zero-width on single-task envs."""
        ids = torch.arange(self.task_dim, device=task_id.device)
        return (task_id[..., None] == ids).to(torch.float32)

    def _net_in(self, obs, stats, task_oh=None):
        """Network input: normalized obs, plus the task one-hot on MixedTask
        runs. `task_oh` broadcasts over leading dims; it is REQUIRED when
        task_dim > 0."""
        x = self._norm(obs, stats)
        if self.task_dim:
            if task_oh is None:
                raise ValueError(
                    "MixedTask learner needs the task one-hot for the "
                    "network input (pass _task_oh(es.task_id))")
            toh = task_oh.expand(x.shape[:-1] + (self.task_dim,))
            x = torch.cat([x, toh], dim=-1)
        return x

    def policy(self, params: ActorCritic, obs,
               generator: Optional[torch.Generator] = None,
               obs_stats: Optional[ObsStats] = None, task_oh=None,
               stochastic: bool = False):
        """Executed action: the mean policy, or with `stochastic` a sample
        of the learned Gaussian drawn from `generator`. `task_oh` is
        required on MixedTask learners."""
        mean, log_std, _ = params(self._net_in(obs, obs_stats, task_oh))
        if stochastic:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            mean = mean + torch.exp(log_std) * noise
        return torch.clamp(self.act_bias + mean, -1.0, 1.0)

    # ------------------------------------------------------------ rollout
    def log_std_cap(self, update_count: int) -> float:
        """The log-std ceiling at `update_count` (1e9 = off)."""
        cfg = self.config
        if cfg.std_cap_updates <= 0:
            return 1e9
        frac = min(max(update_count / float(cfg.std_cap_updates), 0.0), 1.0)
        return cfg.log_std_init + (cfg.std_cap_final - cfg.log_std_init) * frac

    def _policy_fn(self):
        def policy_fn(p, obs, generator):
            # stats: ObsStats or None (cfg.obs_norm off); cap: log-std
            # ceiling (a float or a 0-d tensor); toh: (B, task_dim) task
            # one-hot on MixedTask runs
            params, stats, cap, toh = p
            mean, log_std, value = params(self._net_in(obs, stats, toh))
            log_std = torch.clamp(log_std, max=cap)
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
            action = mean + torch.exp(log_std) * noise
            log_prob = gaussian_log_prob(mean, log_std, action)
            return (torch.clamp(self.act_bias + action, -1.0, 1.0),
                    {"raw_action": action, "log_prob": log_prob, "value": value})
        return policy_fn

    def _collect_fused(self, params: ActorCritic, stats, cap, es: EnvState,
                       generator: Optional[torch.Generator] = None,
                       graphed: Optional[bool] = None):
        """Rollout through the fused step: the policy's matmuls in PyTorch,
        the physics in one CUDA kernel per step, the whole loop one CUDA
        graph replay on the card (`graphed=False`: the eager loop); its
        plain version on CPU tensors. `cap` is a 0-d tensor, so that a new
        ceiling needs no new capture."""
        from ..ops.cuda.fused_step import build_fused_policy_rollout

        if self._fused_rollout is None:
            self._fused_rollout = build_fused_policy_rollout(
                self.env, self.config.num_envs, self.config.rollout_steps,
                self._policy_fn())
        toh = self._task_oh(es.task_id)          # (B, K); static per rollout
        es, traj = self._fused_rollout(es, (params, stats, cap, toh), generator,
                                       graphed=graphed)
        with torch.no_grad():
            # the terminating step of a blown-up env can carry a non-finite
            # reward; sanitize so one env cannot poison a whole batch
            reward = torch.clamp(torch.nan_to_num(traj["reward"], nan=-100.0,
                                                  posinf=100.0, neginf=-100.0),
                                 -100.0, 100.0)
            v_boot = self._value_of(params, stats, traj["final_obs"], toh)
        steps = traj["obs"].shape[0]
        f32 = lambda k: traj[k].to(torch.float32)
        out = Transition(obs=traj["obs"], action=traj["raw_action"],
                         log_prob=traj["log_prob"], value=traj["value"],
                         reward=reward, terminated=f32("terminated"),
                         truncated=f32("truncated"), v_boot=v_boot,
                         failed=f32("failed"), succ_step=f32("succ_step"),
                         task_oh=toh.expand((steps,) + toh.shape))
        return es, out

    def _value_of(self, params: ActorCritic, stats, obs, task_oh=None):
        """Value head over arbitrary leading dims (one batched apply)."""
        return params(self._net_in(obs, stats, task_oh))[2]

    def collect(self, ts: TrainState,
                generator: Optional[torch.Generator] = None,
                graphed: Optional[bool] = None) -> Tuple[TrainState, Transition]:
        """One rollout of `rollout_steps` from the train state's env farm,
        as the train step collects it: the statistics snapshot and the
        log-std ceiling of the current update. On the card the rollout is
        one CUDA graph replay (`graphed=False`: the eager loop, its
        reference). Returns the state with the farm advanced, and the
        rollout."""
        stats = ts.obs_stats if self.config.obs_norm else None
        cap = torch.tensor(self.log_std_cap(ts.update_count), device=self.env.device)
        es, traj = self._collect_fused(ts.params, stats, cap, ts.env_state,
                                       generator, graphed)
        return ts.replace(env_state=es), traj

    # -------------------------------------------------------- checkpointing
    def restore(self, path: str, template: Optional[TrainState] = None) -> TrainState:
        """The network and observation statistics of a flat-npz TrainState
        checkpoint written by the JAX package. The checkpoint's optimizer
        and env farm are not read; the env farm comes from `template`
        (None: no farm, which is all evaluation needs)."""
        from ..convert import obs_stats_from_numpy, policy_from_numpy
        from ..utils.checkpoint import load_policy_npz

        ckpt = load_policy_npz(path)
        net = policy_from_numpy(ckpt["params"], self.env.device)
        want = self.make_network()
        got_shapes = [tuple(p.shape) for p in net.parameters()]
        if got_shapes != [tuple(p.shape) for p in want.parameters()]:
            raise ValueError(
                f"checkpoint {path} holds a network of shapes {got_shapes}, "
                f"not this learner's (hidden {self.config.hidden}, "
                f"{17 + self.task_dim} inputs)")
        return TrainState(
            params=net, update_count=ckpt["update_count"],
            env_state=None if template is None else template.env_state,
            obs_stats=obs_stats_from_numpy(ckpt["obs_stats"], self.env.device))
