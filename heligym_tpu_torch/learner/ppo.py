"""PPO on the fused env step: collection, the update and the training loop.

The port of the JAX package's `learner/ppo.py`: the configuration, the
observation statistics and their Chan merge, the task-conditioned network
input, the stochastic policy with its log-std ceiling, the rollout through
`build_fused_policy_rollout` (on the card one CUDA graph replay of the
collector's loop around `csrc/fused_step.cu`) with its reward sanitising and
value bootstrap, GAE with the training-only shaping, the clipped PPO loss,
the minibatch epochs with optax's clipped Adam written out by hand
(`optim.py`), the train step, the flat-npz checkpoints the JAX package reads
and writes, and the training loop.

Where the JAX learner passes a flax parameter tree, the port passes the
`ActorCritic` module that holds the parameters, and an update writes into
them in place; where it passes a PRNG key, the port passes a
`torch.Generator` on the env's device. The random streams differ from JAX's,
so a resume across packages is exact in everything but the random draws.

With a mesh (`PPOLearner(env, config, mesh)`, `parallel/mesh.py`) the
learner is one rank of a multi-process run, one process per card: the farm
is split along the env axis over the mesh's `env` dimension, the network and
Adam's state are replicated, and the train step keeps the semantics of the
JAX step over the GLOBAL batch: every random draw is of the global block
from a generator held in the same state on every rank, each rank keeping
its rows (the rollout's Dryden noise, the policy's action noise, the start
conditions); the epoch's shuffle is one permutation of the global samples
and each rank takes the ones it holds; the advantage normalisation, every
mean of the loss, the KL stop, the observation statistics and the metrics
are global, through all-reduces; the gradients are summed over the ranks
in one flat bucket per minibatch, before the clip by global norm. No
collective runs inside the collector's CUDA graph. Without a mesh the
learner is one process holding the whole farm.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..envs.env import EnvState, HeliEnv
from ..envs.vector import VectorHeliEnv
from ..ops.state import HELI_STATE_FIELDS, WIND_STATE_FIELDS
from ..parallel.mesh import all_reduce, assert_replicated, gather_rows, shard_rows
from .networks import ActorCritic, gaussian_entropy, gaussian_log_prob, obs_scales
from .optim import AdamState, adam_init, apply_step


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's PPOConfig (`heligym_tpu/learner/ppo.py:29-170`):
    every field, with its name and default."""
    num_envs: int = 1024
    rollout_steps: int = 64
    minibatches: int = 8
    epochs: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (256, 256)
    # Collection always runs through the fused step (the CUDA kernel on the
    # card, its plain version on the CPU); the field is kept for the JAX
    # config's sake and must stay True.
    use_fused_rollout: bool = True
    # Running mean/var observation normalization (on top of the fixed
    # physical scales), updated from each rollout, frozen within an update.
    obs_norm: bool = True
    # Stop UPDATING the running stats (still applied): the fine-tuning
    # setting, where a warm-started farm's first rollouts would shift stats
    # that the checkpoint's policy depends on.
    freeze_obs_stats: bool = False
    # Linear decay horizon (in updates) for lr and entropy coefficient down
    # to `anneal_floor` of their base values; 0 disables the schedules.
    anneal_updates: int = 0
    anneal_floor: float = 0.05
    # Epoch minibatch shuffle: "perm" = full random permutation, "roll" =
    # random circular shift.
    shuffle: str = "perm"
    # Center executed actions on the nominal hover-trim action: the env runs
    # clip(trim_action + a) where a ~ N(mean, std) is the learned residual.
    center_actions: bool = True
    log_std_init: float = -0.5
    # TRAINING-ONLY reward shaping, applied inside GAE (the env's reward and
    # every reported reward metric stay the reference's): `success_bonus`
    # per in-tolerance transition, `fail_penalty` per crash/OOB transition.
    success_bonus: float = 0.0
    fail_penalty: float = 0.0
    # Potential-based shaping coef * (gamma * Phi(s') - Phi(s)), gated off
    # across episode boundaries: agl Phi = -altitude above ground (obs[16]);
    # flare Phi = -|w| * exp(-agl / flare_scale); vel Phi = -|v_horiz -
    # target|; prof Phi = -|w_ned - vmax * (1 - exp(-agl / scale))|; track
    # Phi = -|y - A sin(2 pi x / L)|.
    agl_shaping: float = 0.0
    flare_shaping: float = 0.0
    flare_scale: float = 10.0   # [ft] e-folding altitude of the flare zone
    vel_shaping: float = 0.0
    vel_target_n: float = 0.0   # [ft/s] target north velocity
    vel_target_e: float = 0.0   # [ft/s] target east velocity
    prof_shaping: float = 0.0
    prof_vmax: float = 7.0     # [ft/s] asymptotic descent rate at altitude
    prof_scale: float = 25.0   # [ft] e-folding altitude of the taper
    track_shaping: float = 0.0
    track_amplitude: float = 150.0   # [ft]
    track_wavelength: float = 2000.0  # [ft]
    # Value-loss clipping range; 0 disables value clipping.
    vf_clip_eps: float = 0.2
    # Skip minibatch updates once the pre-update approximate KL to the
    # rollout policy exceeds this (0 = off); Adam's moments still advance.
    target_kl: float = 0.0
    # Freeze the ACTOR for the first N updates (critic and obs stats still
    # learn; Adam's moments for the actor still advance).
    critic_warmup: int = 0
    # Scheduled exploration-std ceiling: the effective log-std is
    # min(learned, cap(t)) with cap decaying linearly from log_std_init to
    # `std_cap_final` over `std_cap_updates` updates. 0 updates = off.
    std_cap_final: float = -3.5
    std_cap_updates: int = 0


@dataclasses.dataclass(frozen=True)
class ObsStats:
    """Running statistics of the SCALED observation (after the fixed
    physical normalizers), Chan-merged per rollout. `count` is capped so
    late batches keep a floor weight."""
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
    """The network (its parameters), Adam's state, the env farm, the
    generator of every random draw (JAX's `key`), the update counter and the
    observation statistics. An evaluation-only state may lack the optimizer
    state, the farm and the generator."""
    params: ActorCritic
    env_state: Optional[EnvState]
    update_count: int
    obs_stats: ObsStats
    opt_state: Optional[AdamState] = None
    generator: Optional[torch.Generator] = None

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

    def map(self, fn) -> "Transition":
        return Transition(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@contextlib.contextmanager
def _fp32_matmuls():
    """Full float32 matmuls (TF32 off) for the policy's forward and backward
    passes, as the JAX package computes them."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _f32(x) -> np.float32:
    return np.float32(x)


class PPOLearner:
    """PPO for a HeliEnv, on the env's device; with a `mesh`, this rank's
    part of a run sharded over the mesh's env dimension (module docstring).
    `config.num_envs` is the global farm size, which the env dimension must
    divide."""

    def __init__(self, env: HeliEnv, config: PPOConfig = PPOConfig(), mesh=None):
        if not config.use_fused_rollout:
            raise ValueError("the port always collects through the fused step; "
                             "use_fused_rollout must be True")
        if config.shuffle not in ("perm", "roll"):
            raise ValueError(f"shuffle must be 'perm' or 'roll', not {config.shuffle!r}")
        self.env = env
        self.config = config
        self.mesh = mesh
        # this rank's rows of the global farm (all of it without a mesh)
        self.rows = shard_rows(config.num_envs, mesh)
        self.local_envs = self.rows.stop - self.rows.start
        self.shards = config.num_envs // self.local_envs
        # the rank that prints, evaluates and writes checkpoints
        self.is_main = mesh is None or torch.distributed.get_rank() == 0
        self.venv = VectorHeliEnv(env, self.local_envs, auto_reset=True)
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
             trim_cond: Optional[dict] = None, task_ids=None,
             cond_sampler=None) -> TrainState:
        """Fresh network, optimizer state and env farm. `generator` (a CPU
        generator; None: an unseeded one) seeds the network, then the train
        state's own generator on the env's device, then (with
        `cond_sampler`) the farm's start conditions. `cond_sampler(generator,
        n)` switches the farm to per-env initial conditions through the
        batched Newton trim (`VectorHeliEnv.reset_randomized`); `task_ids`
        (num_envs,) assigns MixedTask sub-tasks per env. With a mesh every
        rank makes the same network and generators (checked by one
        all-reduce of a digest), draws the global `num_envs` conditions and
        trims and keeps its own rows, and keeps its rows of `task_ids`."""
        net = self.make_network(generator)
        dev = self.env.device
        if self.mesh is not None:
            assert_replicated(b"".join(p.detach().cpu().numpy().tobytes()
                                       for p in self.param_list(net)),
                              self.mesh, "the initial network", dev)

        def device_generator():
            gen = torch.Generator(device=dev)
            if generator is None:
                gen.seed()
            else:
                gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=generator)))
            return gen
        gen = device_generator()
        if cond_sampler is not None:
            es, _ = self.venv.reset_randomized(device_generator(),
                                               self._own_conditions(cond_sampler))
        else:
            es, _ = self.venv.reset(trim_cond)
        if task_ids is not None:
            es = self.venv.assign_tasks(es, self._own_rows(task_ids))
        return TrainState(params=net, env_state=es, update_count=0,
                          obs_stats=ObsStats.init(dev),
                          opt_state=adam_init(self.param_list(net)), generator=gen)

    def _own_rows(self, x):
        """This rank's rows of a per-env array of the global farm."""
        x = torch.as_tensor(x)
        if x.shape[0] != self.config.num_envs:
            raise ValueError(f"expected {self.config.num_envs} rows (the global "
                             f"farm), got {tuple(x.shape)}")
        return x[self.rows]

    def _own_conditions(self, cond_sampler):
        """`cond_sampler` as this rank draws it: the global `num_envs`
        conditions, then its own rows, so that every rank's generator makes
        the same draws and a shard's trim is the global trim's rows (the
        batched trim stops per env)."""
        n = self.config.num_envs

        def sampler(generator, _):
            return {k: (v[self.rows] if torch.is_tensor(v) and v.dim() and v.shape[0] == n
                        else v) for k, v in cond_sampler(generator, n).items()}
        return sampler

    def _noise(self, shape, generator, device) -> torch.Tensor:
        """Standard normal noise of `shape` for this rank's envs (leading
        axis): this rank's rows of one draw of the global block."""
        full = torch.randn((self.config.num_envs,) + tuple(shape[1:]),
                           generator=generator, device=device)
        return full[self.rows]

    @staticmethod
    def param_list(net: ActorCritic) -> List[torch.Tensor]:
        """The network's parameters in the flax leaf order, the order of the
        optimizer state."""
        return [p for _, _, p in net.flax_leaves()]

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

    def _merge_stats(self, stats: ObsStats, obs) -> ObsStats:
        """Chan parallel merge of one rollout's scaled-obs statistics into the
        running stats (population variance). Non-finite obs (blowup steps)
        are zeroed out of the batch rather than poisoning the stats. With a
        mesh the batch is the global rollout: its count, sums and squared
        deviations are summed over the ranks (two all-reduces)."""
        x = obs.reshape(-1, obs.shape[-1]) / self._scales
        x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                        -50.0, 50.0)
        s = self._reduce(torch.cat([x.sum(0), x.new_tensor([float(x.shape[0])])]))
        nb = s[-1]
        mb = s[:-1] / nb
        # the population variance, in two passes as jnp.var
        vb = self._reduce(((x - mb) ** 2).sum(0)) / nb
        n = stats.count + nb
        delta = mb - stats.mean
        mean = stats.mean + delta * (nb / n)
        m2 = stats.var * stats.count + vb * nb + delta * delta * (stats.count * nb / n)
        # cap the count so fresh data keeps a floor weight (EMA-like tail)
        return ObsStats(mean=mean, var=m2 / n, count=torch.clamp(n, max=5e6))

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
            noise = self._noise(mean.shape, generator, mean.device)
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
        ceiling needs no new capture. The Dryden noise is this rank's
        columns of the global (T, 3, num_envs) draw, made here before the
        policy's draws as the rollout would make its own."""
        from ..ops.cuda.fused_step import build_fused_policy_rollout

        cfg = self.config
        if self._fused_rollout is None:
            self._fused_rollout = build_fused_policy_rollout(
                self.env, self.local_envs, cfg.rollout_steps, self._policy_fn())
        toh = self._task_oh(es.task_id)          # (B, K); static per rollout
        eta = (torch.randn((cfg.rollout_steps, 3, cfg.num_envs), generator=generator,
                           device=es.obs.device) * (1.0 / self.env.dt) ** 0.5)[..., self.rows]
        with _fp32_matmuls():
            es, traj = self._fused_rollout(es, (params, stats, cap, toh), generator,
                                           eta_seq=eta, graphed=graphed)
        with torch.no_grad(), _fp32_matmuls():
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
        log-std ceiling of the current update, the noise from `generator`
        (None: torch's default generator; the train step passes the train
        state's). On the card the rollout is one CUDA graph replay
        (`graphed=False`: the eager loop, its reference). Returns the state
        with the farm advanced, and the rollout."""
        stats = ts.obs_stats if self.config.obs_norm else None
        cap = torch.tensor(self.log_std_cap(ts.update_count), device=self.env.device)
        es, traj = self._collect_fused(ts.params, stats, cap, ts.env_state,
                                       generator, graphed)
        return ts.replace(env_state=es), traj

    # ---------------------------------------------------------------- GAE
    def _gae(self, traj: Transition):
        """GAE with correct truncation handling: termination zeroes the
        bootstrap; truncation bootstraps V(final_obs) but still cuts the
        advantage accumulation across the reset boundary. A reverse loop of
        small launches over the T steps."""
        cfg = self.config
        shaping = torch.zeros_like(traj.reward)
        if (cfg.agl_shaping != 0.0 or cfg.flare_shaping != 0.0
                or cfg.vel_shaping != 0.0 or cfg.track_shaping != 0.0
                or cfg.prof_shaping != 0.0):
            # potential-based: coef * (gamma * Phi(s_{t+1}) - Phi(s_t));
            # obs[t+1] is post-reset so boundary transitions are gated off
            intra = (1.0 - traj.terminated) * (1.0 - traj.truncated)
            intra[-1] = 0.0
            obs = traj.obs

            def telescope(phi):
                phi_next = torch.cat([phi[1:], phi[-1:]], dim=0)
                return intra * (cfg.gamma * phi_next - phi)

            if cfg.agl_shaping != 0.0:   # Phi = -alt_above_ground
                shaping += cfg.agl_shaping * telescope(-obs[..., 16])
            if cfg.flare_shaping != 0.0:  # Phi = -|w| * exp(-agl/scale)
                phi_f = -torch.abs(obs[..., 3]) * torch.exp(
                    -obs[..., 16] / cfg.flare_scale)
                shaping += cfg.flare_shaping * telescope(phi_f)
            if cfg.prof_shaping != 0.0:  # Phi = -|w_ned - v_ref(agl)| [ft/s]
                v_ref = cfg.prof_vmax * (
                    1.0 - torch.exp(-obs[..., 16] / cfg.prof_scale))
                shaping += cfg.prof_shaping * telescope(
                    -torch.abs(obs[..., 6] - v_ref))
            if cfg.vel_shaping != 0.0:  # Phi = -|v_horiz - target| [ft/s]
                phi_v = -torch.sqrt(
                    (obs[..., 4] - cfg.vel_target_n) ** 2
                    + (obs[..., 5] - cfg.vel_target_e) ** 2 + 1e-6)
                shaping += cfg.vel_shaping * telescope(phi_v)
            if cfg.track_shaping != 0.0:  # Phi = -|y - y_ref(x)| [ft]
                y_ref = cfg.track_amplitude * torch.sin(
                    2.0 * math.pi * obs[..., 13] / cfg.track_wavelength)
                shaping += cfg.track_shaping * telescope(
                    -torch.abs(obs[..., 14] - y_ref))

        not_reset = (1.0 - traj.terminated) * (1.0 - traj.truncated)
        # select, don't multiply: v_boot at a terminated blowup step can be
        # NaN, and NaN * 0 = NaN would poison the whole recursion
        boot = torch.where(traj.terminated > 0, 0.0, traj.v_boot)
        # training-only shaping (config docstring); env rewards untouched
        r = (traj.reward + cfg.success_bonus * traj.succ_step
             - cfg.fail_penalty * traj.failed + shaping)
        delta = r + cfg.gamma * boot - traj.value
        decay = (cfg.gamma * cfg.gae_lambda) * not_reset
        advantages = torch.empty_like(delta)
        gae = torch.zeros_like(delta[-1])
        for t in range(delta.shape[0] - 1, -1, -1):
            gae = delta[t] + decay[t] * gae
            advantages[t] = gae
        return advantages, advantages + traj.value

    # ------------------------------------------------------------- update
    def _loss(self, params: ActorCritic, batch: Transition, advantages, returns,
              stats, ent_coef, cap, norm=None):
        """The clipped PPO loss of one minibatch and its metrics; `cap` is
        the log-std ceiling (a 0-d tensor). `norm` (mean, std, size): the
        advantage mean and population std of the whole minibatch, and its
        size, when `batch` is this rank's part of a minibatch split over
        ranks; every mean is then this rank's sum over the whole size, so
        that the sums over the ranks are the minibatch's loss and metrics.
        None: `batch` is the whole minibatch."""
        cfg = self.config
        if norm is None:
            # jnp.std: the population standard deviation
            norm = (advantages.mean(), advantages.std(correction=0), advantages.shape[0])
        adv_mean, adv_std, size = norm
        avg = lambda x: x.sum() / size
        mean, log_std, value = params(self._net_in(batch.obs, stats, batch.task_oh))
        log_std = torch.minimum(log_std, torch.as_tensor(cap, dtype=log_std.dtype,
                                                         device=log_std.device))
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)
        adv = (advantages - adv_mean) / (adv_std + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
        pg_loss = -avg(torch.minimum(pg1, pg2))
        if cfg.vf_clip_eps > 0:
            v_clipped = batch.value + torch.clamp(value - batch.value,
                                                  -cfg.vf_clip_eps, cfg.vf_clip_eps)
            v_loss = 0.5 * avg(torch.maximum((value - returns) ** 2,
                                             (v_clipped - returns) ** 2))
        else:
            v_loss = 0.5 * avg((value - returns) ** 2)
        ent = avg(gaussian_entropy(log_std))
        total = pg_loss + cfg.vf_coef * v_loss - ent_coef * ent
        with torch.no_grad():
            approx_kl = avg((ratio - 1.0) - torch.log(ratio))
        return total, {"pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
                       "entropy": ent.detach(), "approx_kl": approx_kl}

    def _actor_indices(self, net: ActorCritic) -> List[int]:
        """The positions, in the flax leaf order, of the actor's parameters
        (`ActorCritic.actor_flax_names`: the torso, the mean head and
        log_std), whose updates the critic warm-up scales; the critic's
        are not scaled."""
        actor = net.actor_flax_names()
        return [i for i, (name, _, _) in enumerate(net.flax_leaves()) if name in actor]

    def _update_epoch(self, params: ActorCritic, opt_state: AdamState,
                      flat: Transition, advantages, returns, stats, ent_coef, lr,
                      cap, actor_scale=None, generator=None, idx=None):
        """One epoch of minibatch steps over the flattened rollout, the
        parameters updated in place. `idx` (n,) is the epoch's shuffle of
        the global T * B samples, in the flat order t * B + b (injected by
        tests, to reproduce JAX's draw); by default a permutation ("perm")
        or a circular shift ("roll") drawn from `generator`. `mb = n //
        minibatches`, so a remainder is dropped. Returns the optimizer state
        and each metric per minibatch.

        `flat`, `advantages` and `returns` are this rank's (T * B/R, flat
        order t * B/R + b; all of them without a mesh): each minibatch step
        takes the samples of its global slice that this rank holds,
        normalises their advantages by the slice's global mean and std (two
        all-reduces per epoch) and sums the gradients and metrics over the
        ranks (one all-reduce per step), so that the KL stop and the clip
        see the global step."""
        cfg = self.config
        n = advantages.shape[0] * self.shards        # the global sample count
        dev = advantages.device
        if idx is None:
            if cfg.shuffle == "perm":
                idx = torch.randperm(n, generator=generator, device=dev)
            else:           # roll: out[i] = x[(i - shift) mod n]
                shift = torch.randint(0, n, (), generator=generator, device=dev)
                idx = torch.remainder(torch.arange(n, device=dev) - shift, n)
        mb = n // cfg.minibatches
        order, counts = self._own_samples(idx, mb)
        mix = lambda x: x.index_select(0, order)
        flat_r = flat.map(mix)
        adv_r, ret_r = mix(advantages), mix(returns)
        adv_mean, adv_std = self._advantage_norms(adv_r, counts, mb)
        leaves = self.param_list(params)
        scaled = None if actor_scale is None else self._actor_indices(params)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        metrics, at = [], 0
        for i, count in enumerate(counts):
            sl = lambda x: x[at:at + count]
            loss, aux = self._loss(params, flat_r.map(sl), sl(adv_r), sl(ret_r), stats,
                                   ent_coef, cap, (adv_mean[i], adv_std[i], mb))
            loss, aux, grads = self._sum_over_ranks(
                loss, aux, torch.autograd.grad(loss, leaves))
            at += count
            step_lr = lr
            if cfg.target_kl > 0:
                # KL early stop: once this epoch has drifted past target_kl,
                # the remaining minibatch steps move no parameter (Adam's
                # moments and count still advance)
                step_lr = torch.where(aux["approx_kl"] < cfg.target_kl, lr, 0.0)
            opt_state = apply_step(leaves, grads, opt_state, step_lr,
                                   cfg.max_grad_norm, scaled, actor_scale)
            metrics.append({"loss": loss.detach(), **aux})
        return opt_state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def _own_samples(self, idx, mb: int) -> Tuple[torch.Tensor, List[int]]:
        """The local flat indices of the samples this rank holds among the
        `minibatches` slices of `mb` of the global shuffle `idx`, in the
        shuffle's order, and how many fall in each slice. With one shard
        these are the slices themselves; with more, the counts cost one
        host sync."""
        cfg = self.config
        sel = torch.as_tensor(idx, device=self.env.device)[:cfg.minibatches * mb]
        if self.shards == 1:
            return sel, [mb] * cfg.minibatches
        width, lo = self.local_envs, self.rows.start
        t, b = sel // cfg.num_envs, sel % cfg.num_envs
        mine = (b >= lo) & (b < lo + width)
        counts = mine.reshape(cfg.minibatches, mb).sum(1).tolist()
        return (t * width + (b - lo))[mine], counts

    def _advantage_norms(self, adv_r, counts: List[int], mb: int):
        """Each minibatch's advantage mean and population std over the
        global minibatch (two passes, as `jnp.std`; one all-reduce each),
        from this rank's advantages in the shuffle's order, `counts` of
        them in each minibatch."""
        parts = torch.split(adv_r, counts)
        means = self._reduce(torch.stack([p.sum() for p in parts])) / mb
        sq = torch.stack([((p - m) ** 2).sum() for p, m in zip(parts, means)])
        return means, torch.sqrt(self._reduce(sq) / mb)

    def _sum_over_ranks(self, loss, aux, grads):
        """The loss, its metrics and the gradients of a minibatch step
        summed over the ranks: one flat bucket, one all-reduce (nothing to
        sum without a mesh)."""
        if self.mesh is None:
            return loss, aux, grads
        keys = ("pg_loss", "v_loss", "entropy", "approx_kl")
        bucket = torch.cat([g.reshape(-1) for g in grads]
                           + [torch.stack([loss.detach()] + [aux[k] for k in keys])])
        parts = torch.split(self._reduce(bucket), [g.numel() for g in grads]
                            + [1 + len(keys)])
        tail = parts[-1]
        return (tail[0], dict(zip(keys, tail[1:])),
                [p.view_as(g) for p, g in zip(parts, grads)])

    def _reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place over the ranks of the env mesh
        (`parallel.mesh.all_reduce`), and returned; `t` itself without a
        mesh. Every collective of the train step goes through here."""
        return all_reduce(t, self.mesh, op)

    def schedules(self, update_count: int):
        """(lr, entropy coefficient, log-std ceiling, actor scale) of the
        update `update_count`, in float32 as the JAX train step computes
        them; the actor scale is None without critic warm-up."""
        cfg = self.config
        if cfg.anneal_updates > 0:
            frac = np.clip(_f32(1.0) - _f32(update_count) / _f32(cfg.anneal_updates),
                           _f32(cfg.anneal_floor), _f32(1.0))
        else:
            frac = _f32(1.0)
        actor_scale = ((0.0 if update_count < cfg.critic_warmup else 1.0)
                       if cfg.critic_warmup > 0 else None)
        return (_f32(cfg.lr) * frac, _f32(cfg.ent_coef) * frac,
                self.log_std_cap(update_count), actor_scale)

    def update(self, ts: TrainState, traj: Transition, idx: Optional[Sequence] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The update half of a train step, from the rollout `traj` that
        `collect` gave: GAE, `epochs` x `_update_epoch` (the parameters and
        Adam's state advance in place), the metrics, the statistics merge
        (unless frozen). `idx`: one injected shuffle per epoch. Returns the
        new state and the metrics as 0-d tensors, without a host sync."""
        cfg = self.config
        stats = ts.obs_stats if cfg.obs_norm else None
        lr_t, ent_t, cap, actor_scale = self.schedules(ts.update_count)
        dev = traj.reward.device
        cap = torch.tensor(cap, dtype=torch.float32, device=dev)
        with torch.no_grad():
            advantages, returns = self._gae(traj)
            # (T, B, ...) -> (T*B, ...)
            flat = traj.map(lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]))
        opt_state, per_mb = ts.opt_state, []
        with _fp32_matmuls():
            for e in range(cfg.epochs):
                opt_state, m = self._update_epoch(
                    ts.params, opt_state, flat, advantages.reshape(-1),
                    returns.reshape(-1), stats, float(ent_t), lr_t, cap, actor_scale,
                    ts.generator, None if idx is None else idx[e])
                per_mb.append(m)
        with torch.no_grad():
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
            metrics.update(self._rollout_metrics(traj))
            metrics["lr"] = torch.tensor(lr_t, device=dev)
            new_stats = (self._merge_stats(ts.obs_stats, traj.obs)
                         if cfg.obs_norm and not cfg.freeze_obs_stats else ts.obs_stats)
        return ts.replace(opt_state=opt_state, update_count=ts.update_count + 1,
                          obs_stats=new_stats), metrics

    def _rollout_metrics(self, traj: Transition) -> Dict[str, torch.Tensor]:
        """Reward, in-tolerance, episode-end, success and failure fractions
        of the rollout; per sub-task on a MixedTask. Sums and counts, then
        the ratios: with a mesh the sums are of every rank's envs (one
        all-reduce)."""
        ended = torch.maximum(traj.terminated, traj.truncated)
        # terminated & ~failed == the env's success criterion fired
        won = traj.terminated * (1.0 - traj.failed)
        sums = [traj.reward.sum(), traj.succ_step.sum(), ended.sum(), won.sum(),
                traj.failed.sum(), traj.reward.new_tensor(float(traj.reward.numel()))]
        per_task = bool(getattr(self.env.task, "tasks", None))
        if per_task:
            for i in range(self.task_dim):
                mask = traj.task_oh[0, :, i][None, :]         # (1, B)
                sums += [(ended * mask).sum(), (won * mask).sum(),
                         (traj.succ_step * mask).sum(), mask.sum()]
        s = self._reduce(torch.stack(sums))
        n_ep = torch.clamp(s[2], min=1.0)
        m = {"reward_mean": s[0] / s[5], "succ_step_frac": s[1] / s[5],
             "done_frac": s[2] / s[5], "success_ep_frac": s[3] / n_ep,
             "fail_ep_frac": s[4] / n_ep}
        if per_task:
            steps = float(traj.reward.shape[0])
            for i in range(self.task_dim):
                e, w, inside, count = s[6 + 4 * i:10 + 4 * i]
                m[f"success_ep_frac_t{i}"] = w / torch.clamp(e, min=1.0)
                m[f"in_tol_t{i}"] = inside / torch.clamp(count * steps, min=1.0)
        return m

    def train_step(self, ts: TrainState, graphed: Optional[bool] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One PPO iteration, the counterpart of the JAX package's
        `train_step_fn`: `collect` (on the card one graph replay of the
        collector) with the train state's generator, then `update`. With a
        mesh, one all-reduce then checks that the generator's state is the
        same on every rank."""
        ts, traj = self.collect(ts, ts.generator, graphed)
        ts, metrics = self.update(ts, traj)
        if self.mesh is not None:
            assert_replicated(ts.generator.get_state().numpy().tobytes(), self.mesh,
                              "the generator's state", self.env.device)
        return ts, metrics

    # -------------------------------------------------------- checkpointing
    def _checkpoint_tree(self, net: ActorCritic, adam: dict, env: dict,
                         key, update_count, stats: dict):
        """The JAX package's TrainState tree (`save_npz`'s layout) of numpy
        parts: the flax parameters, optax's (EmptyState, ScaleByAdamState),
        the EnvState with its per-env keys, the key, the counter and the
        ObsStats."""
        from ..convert import policy_to_numpy
        from ..utils.checkpoint import Node

        cols = lambda a, name, fields: Node(name, [a[..., i] for i in range(len(fields))])
        heli = lambda a: cols(a, "HeliState", HELI_STATE_FIELDS)
        wind = lambda a: cols(a, "WindState", WIND_STATE_FIELDS)
        init = Node("ResetSnapshot", [heli(env["init.heli"]), wind(env["init.wind"]),
                                      heli(env["init.dots"]), env["init.obs"],
                                      env["init.wind_ned"]])
        env_node = Node("EnvState", [heli(env["heli"]), wind(env["wind"]),
                                     heli(env["dots"]), env["obs"], env["wind_ned"],
                                     env["steps"], env["successed_steps"], env["key"],
                                     init, env["task_id"]])
        opt = (Node("EmptyState", [], namedtuple=True),
               Node("ScaleByAdamState", [adam["count"], {"params": adam["mu"]},
                                         {"params": adam["nu"]}], namedtuple=True))
        return Node("TrainState", [
            {"params": policy_to_numpy(net)}, opt, env_node, key,
            np.asarray(update_count, np.int32),
            Node("ObsStats", [stats["mean"], stats["var"], stats["count"]])])

    def _treedef(self, net: ActorCritic) -> str:
        """The treedef string the JAX package writes for this learner's
        TrainState."""
        from ..convert import adam_state_to_numpy
        from ..utils.checkpoint import flatten

        empty = lambda *shape: np.zeros((0,) + shape, np.float32)
        env = {"heli": empty(18), "wind": empty(5), "dots": empty(18), "obs": empty(17),
               "wind_ned": empty(3), "steps": empty(), "successed_steps": empty(),
               "key": empty(2), "init.heli": empty(18), "init.wind": empty(5),
               "init.dots": empty(18), "init.obs": empty(17), "init.wind_ned": empty(3),
               "task_id": empty()}
        adam = adam_state_to_numpy(net, adam_init(self.param_list(net)))
        stats = {"mean": empty(17), "var": empty(17), "count": empty()}
        return flatten(self._checkpoint_tree(net, adam, env, empty(2), 0, stats))[0]

    @staticmethod
    def _keys_of(generator: torch.Generator, num_envs: int):
        """The checkpoint's `key` (2,) and per-env keys (B, 2), uint32, drawn
        from a hash of `generator`'s state (the generator itself does not
        advance). JAX cannot continue the port's random streams from them."""
        digest = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                                 digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "little"))
        return (np.frombuffer(digest, np.uint32).copy(),
                rng.integers(0, 2 ** 32, (num_envs, 2), dtype=np.uint32))

    def save(self, path: str, ts: TrainState) -> None:
        """Snapshot the full training state in the JAX package's flat-npz
        format: its `load_npz` reads the file back against a template of the
        same configuration. The generator's state rides beside the leaves
        ("generator_state"), so that the port's own resume continues its
        random streams; the `key` leaves are derived from it.

        With a mesh every rank must call it: the farm's rows are put
        together from every rank (one all-reduce, bit for bit), and the main
        rank writes the file of the global farm."""
        from ..convert import adam_state_to_numpy, env_state_to_numpy
        from ..utils.checkpoint import save_npz

        if ts.opt_state is None or ts.env_state is None or ts.generator is None:
            raise ValueError("save needs a full TrainState: optimizer state, env "
                             "farm and generator")
        env = env_state_to_numpy(ts.env_state)
        if self.mesh is not None:
            names = list(env)
            env = dict(zip(names, gather_rows([env[k] for k in names],
                                              self.config.num_envs, self.mesh,
                                              self.env.device)))
            if not self.is_main:
                return
        key, env["key"] = self._keys_of(ts.generator, env["steps"].shape[0])
        s = ts.obs_stats
        stats = {k: getattr(s, k).detach().cpu().numpy() for k in ("mean", "var", "count")}
        tree = self._checkpoint_tree(ts.params, adam_state_to_numpy(ts.params, ts.opt_state),
                                     env, key, ts.update_count, stats)
        save_npz(path, tree, generator_state=ts.generator.get_state().numpy())

    def restore(self, path: str, template: Optional[TrainState] = None,
                farm_size: Optional[int] = None, with_farm: bool = False) -> TrainState:
        """A TrainState checkpoint (the JAX package's or the port's): the
        network, Adam's state and the observation statistics; with a
        `template`, also the env farm, which must be the template's size;
        with `with_farm`, the farm the file holds, whatever its size.
        `farm_size`: the farm size the checkpoint must have (a scale-up
        resume's check); None: the template's. The generator continues the
        port's saved stream where the file holds one for a generator of the
        template's kind; otherwise it is seeded from the `key` leaf. With a
        mesh, sizes are of the global farm, and each rank keeps its rows."""
        from ..convert import (adam_state_from_numpy, env_state_from_numpy,
                               obs_stats_from_numpy, policy_from_numpy)
        from ..utils.checkpoint import TreedefError, load_train_state_npz

        dev = self.env.device
        ck = load_train_state_npz(path)
        net = policy_from_numpy(ck["params"], dev)
        want = self.make_network()
        got_shapes = [tuple(p.shape) for p in net.parameters()]
        if got_shapes != [tuple(p.shape) for p in want.parameters()]:
            raise ValueError(
                f"checkpoint {path} holds a network of shapes {got_shapes}, "
                f"not this learner's (hidden {self.config.hidden}, "
                f"{17 + self.task_dim} inputs)")
        if ck["treedef"] != self._treedef(net):
            raise TreedefError(f"{path}: its treedef is not this learner's "
                               f"TrainState: {ck['treedef'][:80]}...")
        stored = ck["env_state"]["steps"].shape[0]
        if farm_size is None and template is not None and template.env_state is not None:
            farm_size = template.env_state.steps.shape[0] * self.shards
        if farm_size is not None and stored != farm_size:
            raise ValueError(f"checkpoint {path} holds a farm of {stored} envs, not "
                             f"{farm_size} (a scale-up resume takes resume_num_envs)")
        es = None
        if with_farm or (template is not None and template.env_state is not None):
            rows = shard_rows(stored, self.mesh)
            es = env_state_from_numpy({k: v[rows] for k, v in ck["env_state"].items()},
                                      dev)
        gen = torch.Generator(device=dev)
        state = ck["extra"].get("generator_state")
        if state is not None and state.shape == tuple(gen.get_state().shape):
            gen.set_state(torch.from_numpy(state))
        else:
            gen.manual_seed(int.from_bytes(np.asarray(ck["key"], np.uint32).tobytes(),
                                           "little"))
        return TrainState(params=net, env_state=es, update_count=ck["update_count"],
                          obs_stats=obs_stats_from_numpy(ck["obs_stats"], dev),
                          opt_state=adam_state_from_numpy(net, ck["opt_state"], dev),
                          generator=gen)

    # ----------------------------------------------------------- training
    def train(self, generator: Optional[torch.Generator] = None, num_updates: int = 1,
              log_every: int = 10, trim_cond: Optional[dict] = None,
              cond_sampler=None, task_ids=None,
              checkpoint_path: Optional[str] = None, checkpoint_every: int = 100,
              resume_from: Optional[str] = None, fresh_farm: bool = False,
              resume_num_envs: Optional[int] = None, reset_schedules: bool = False,
              set_log_std: Optional[float] = None, eval_every: int = 0,
              eval_episodes: int = 64, eval_env: Optional[HeliEnv] = None,
              eval_cond_sampler=None):
        """`num_updates` train steps from a fresh state (`init(generator,
        trim_cond, task_ids, cond_sampler)`) or a checkpoint. Returns (state,
        history of the logged metrics).

        `resume_from`: a TrainState checkpoint of this configuration; a
        same-size resume restores everything, farm included (`fresh_farm`:
        keep the fresh farm and generator instead, as a new start-condition
        curriculum needs). `resume_num_envs`: the checkpoint's farm size when
        it differs from `num_envs` (scale-up resume): the parameters, Adam's
        state and the observation statistics are transplanted, the schedules
        restart. `reset_schedules`: on a same-size resume, restart the
        schedules (update_count 0). `set_log_std`: overwrite the restored
        policy's learned log-std.

        `eval_every`: every N updates (and after the last) run the
        deterministic evaluator (`evaluate.make_evaluator`: `eval_episodes`
        fresh episodes to their first termination, in `eval_env` or the
        training env, from `eval_cond_sampler`'s per-episode starts or
        `trim_cond`'s) and best-track on its success fraction, the minimum
        over sub-tasks on a MixedTask, instead of the rollout's
        selection-biased `success_ep_frac`. Every evaluation draws the same
        noise: a generator seeded with 1234 afresh each time.

        With `checkpoint_path`, the state is saved every `checkpoint_every`
        updates and at the end, and to `checkpoint_path + ".best.npz"`
        whenever the tracked success beats its best, checked every update
        (or every evaluation).

        With a mesh every rank runs the loop; the main rank alone prints,
        runs the evaluator (on its own device) and writes the checkpoints,
        and broadcasts each evaluation's success, so that every rank takes
        the same best-checkpoint decision. Only the main rank's history
        holds the evaluations."""
        ts = self.init(generator, trim_cond, task_ids, cond_sampler=cond_sampler)
        if resume_from and resume_num_envs and resume_num_envs != self.config.num_envs:
            small = self.restore(resume_from, farm_size=resume_num_envs)
            ts = ts.replace(params=small.params, opt_state=small.opt_state,
                            obs_stats=small.obs_stats)
        elif resume_from:
            restored = self.restore(resume_from, ts)
            if fresh_farm:
                restored = restored.replace(env_state=ts.env_state,
                                            generator=ts.generator)
            ts = restored
        if resume_from and reset_schedules:
            ts = ts.replace(update_count=0)
        if resume_from and set_log_std is not None:
            with torch.no_grad():
                ts.params.log_std.fill_(set_log_std)
        evaluator = None
        if eval_every and self.is_main:
            from .evaluate import make_evaluator
            eval_tids = (np.arange(eval_episodes) % (int(np.max(task_ids)) + 1)
                         if task_ids is not None else None)
            e_env = eval_env or self.env
            evaluator = make_evaluator(
                e_env, self, episodes=eval_episodes, steps=e_env.time_up_steps + 3,
                stochastic=False, trim_cond=trim_cond, task_ids=eval_tids,
                cond_sampler=eval_cond_sampler)
        history = []
        best_succ = -1.0
        for i in range(num_updates):
            ts, metrics = self.train_step(ts)
            if eval_every and ((i + 1) % eval_every == 0 or i == num_updates - 1):
                s = None
                if evaluator is not None:
                    # the same noise in every evaluation, so that they compare
                    ev = evaluator(ts, torch.Generator(device=e_env.device).manual_seed(1234))
                    metrics = dict(metrics)
                    metrics.update({f"eval_{k}": v for k, v in ev.items()
                                    if k != "episodes"})
                    s = ev["success_frac"]
                    # MixedTask: select on the worst sub-task, not the mean
                    per_task = [v for k, v in sorted(ev.items())
                                if k.startswith("success_frac_t")]
                    if per_task:
                        s = min(per_task)
                        print(f"  eval @ update {i + 1}: det per-task "
                              f"{[round(v, 3) for v in per_task]} "
                              f"min={s:.3f} fail={ev['fail_frac']:.3f}", flush=True)
                    else:
                        print(f"  eval @ update {i + 1}: det success={s:.3f} "
                              f"fail={ev['fail_frac']:.3f}", flush=True)
                s = self._from_main(s)
                if checkpoint_path and s > best_succ:
                    best_succ = s
                    self.save(checkpoint_path + ".best.npz", ts)
                    if self.is_main:
                        print(f"  saved best at update {i + 1} "
                              f"(eval success={s:.3f})", flush=True)
            # keep the peak-success policy, checked every update: PPO on an
            # unstable plant can unlearn a succeeding policy late in a run
            if checkpoint_path and not eval_every:
                s = float(metrics["success_ep_frac"])
                if s > max(best_succ, 0.0):
                    best_succ = s
                    self.save(checkpoint_path + ".best.npz", ts)
                    if self.is_main:
                        print(f"  saved best at update {i + 1} (success_ep={s:.3f})",
                              flush=True)
            if (i + 1) % log_every == 0 or i == num_updates - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["update"] = i + 1
                history.append(m)
                if self.is_main:
                    print(f"update {i+1}: reward={m['reward_mean']:.4f} "
                          f"loss={m['loss']:.4f} kl={m['approx_kl']:.4f} "
                          f"success_ep={m['success_ep_frac']:.3f} "
                          f"fail_ep={m['fail_ep_frac']:.3f} "
                          f"in_tol={m['succ_step_frac']:.3f}", flush=True)
            if checkpoint_path and (i + 1) % checkpoint_every == 0:
                self.save(checkpoint_path, ts)
        if checkpoint_path:
            self.save(checkpoint_path, ts)
        return ts, history

    def _from_main(self, value: Optional[float]) -> float:
        """The main rank's `value` on every rank (one broadcast); `value`
        itself without a mesh."""
        if self.mesh is None:
            return value
        t = torch.tensor([0.0 if value is None else value], dtype=torch.float64,
                         device=self.env.device)
        torch.distributed.broadcast(t, src=0)
        return float(t[0])
