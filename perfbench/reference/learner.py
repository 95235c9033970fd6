"""The plain reference of the learner: the actor-critic forward, the
stochastic policy of the collector, the rollout, GAE, the clipped PPO loss
and optax's clipped Adam, in float32 PyTorch with TF32 off.

Written from the algorithm (PPO with GAE, a Gaussian policy with a learned
log-std, observation standardisation with frozen statistics, clip by global
norm, Adam with bias correction, the learning rate applied after Adam) and
the checkpoint's flat-npz layout. It imports nothing of the port and takes
nothing the port made: the weights, the optimizer state and the statistics
are read from the committed checkpoint, the start of the farm is solved by
`sim.trim`, and the random draws are made from a generator seeded as the
benchmark seeds the program's, in the order the collector makes them (the
Dryden noise of a rollout first, then one action draw per step, then one
shuffle per epoch).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .graphs import Stepper
from .sim.env import CDONE, CFAIL, CFINAL0, CREW, CSUCC, CTRUNC, D0, O0, XROWS, Sim

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
N_LAYERS = 6            # actor: 2 hidden + mean head; critic: 2 hidden + value head


def obs_scales(params) -> torch.Tensor:
    v = float(np.sqrt(2.0 * params.MR.R * params.ENV.GRAV))
    x = 2.0 * params.MR.R
    return torch.from_numpy(np.asarray(
        [1000.0, v, v, v, v, v, v, 1.0, 1.0, np.pi, 1.0, 1.0, 1.0,
         x * 10, x * 10, 5000.0, 5000.0], dtype=np.float32))


@dataclasses.dataclass
class Checkpoint:
    """A TrainState file's network, Adam state and observation statistics.
    `leaves` are [b0, W0, b1, W1, ..., b5, W5, log_std], each W (out, in)."""
    leaves: List[torch.Tensor]
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    stats_mean: torch.Tensor
    stats_var: torch.Tensor


def load_checkpoint(path: str, device) -> Checkpoint:
    """Leaves 0-12 the network (per Dense layer bias then kernel (in, out),
    then log_std), 13 Adam's count, 14-26 and 27-39 its moments in the same
    order; the last three the statistics' mean, variance and count."""
    with np.load(path) as z:
        n = int(z["n"])
        leaf = lambda i: np.asarray(z[f"leaf_{i}"])
        flat = [leaf(i) for i in range(3 * (2 * N_LAYERS + 1) + 1)]
        stats = [leaf(n - 3), leaf(n - 2)]
    per = 2 * N_LAYERS + 1

    def layout(group):
        out = []
        for j, a in enumerate(group):
            t = torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
            out.append(t.to(device=device, dtype=torch.float32).contiguous())
        return out
    for j in range(N_LAYERS):
        if flat[2 * j + 1].ndim != 2 or flat[2 * j].shape[0] != flat[2 * j + 1].shape[1]:
            raise ValueError(f"{path}: leaf {2 * j + 1} is not Dense_{j}'s kernel")
    return Checkpoint(leaves=layout(flat[:per]),
                      count=torch.as_tensor(flat[per], dtype=torch.int32, device=device),
                      mu=layout(flat[per + 1:2 * per + 1]),
                      nu=layout(flat[2 * per + 1:3 * per + 1]),
                      stats_mean=torch.from_numpy(stats[0]).to(device),
                      stats_var=torch.from_numpy(stats[1]).to(device))


def actor_indices() -> List[int]:
    """Leaves of the actor: Dense_0..2 and log_std."""
    return list(range(6)) + [2 * N_LAYERS]


def forward(leaves, x):
    """(mean, log_std broadcast to the mean, value) of inputs (..., in)."""
    a = c = x
    for j in range(2):
        a = torch.tanh(F.linear(a, leaves[2 * j + 1], leaves[2 * j]))
    mean = F.linear(a, leaves[5], leaves[4])
    for j in range(3, 5):
        c = torch.tanh(F.linear(c, leaves[2 * j + 1], leaves[2 * j]))
    value = F.linear(c, leaves[11], leaves[10])
    return mean, leaves[12].expand(mean.shape), value[..., 0]


def gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var)
                     - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


# PPO settings the reference implements only at these values
FIXED = {"obs_norm": True, "center_actions": True,
         "shuffle": "perm", "target_kl": 0.0, "std_cap_updates": 0, "agl_shaping": 0.0,
         "flare_shaping": 0.0, "vel_shaping": 0.0, "prof_shaping": 0.0,
         "track_shaping": 0.0, "use_fused_rollout": True}


class Learner:
    """The reference's collector and update for one configuration (the
    settings keyed by the port's PPOConfig field names)."""

    def __init__(self, sim: Sim, cfg: dict, ck: Checkpoint, carry, init, act_bias,
                 generator: torch.Generator, device):
        for k, v in FIXED.items():
            if cfg.get(k, v) != v:
                raise ValueError(f"the reference implements {k}={v!r} only, not {cfg[k]!r}")
        if tuple(cfg.get("hidden", (256, 256))) != (ck.leaves[1].shape[0],
                                                     ck.leaves[3].shape[0]):
            raise ValueError("the reference's network has two hidden layers of the "
                             "checkpoint's width")
        self.sim, self.cfg, self.dev = sim, cfg, device
        self.leaves = ck.leaves
        self.count, self.mu, self.nu = ck.count, ck.mu, ck.nu
        self.mean, self.var = ck.stats_mean, ck.stats_var
        if cfg.get("set_log_std") is not None:
            self.leaves[12] = torch.full_like(self.leaves[12], float(cfg["set_log_std"]))
        self.carry, self.init, self.act_bias = carry, init, act_bias
        self.gen = generator
        self.scales = obs_scales(sim.params).to(device)
        self.num_envs = carry.shape[1]
        tasks = getattr(sim.task, "tasks", ())
        self.task_dim = len(tasks)
        ids = torch.arange(self.task_dim, device=device)
        self.toh = (init[61].to(torch.int32)[:, None] == ids).to(torch.float32)
        self.update_count = int(cfg.get("start_update", 0))
        self.stepper = Stepper(sim, init)
        # a fault planted in the reference put in the program's place (the
        # correctness check's own test): "alter" one transition's reward
        # where the rollout makes it, leave "half_batch" of each minibatch
        # out of the loss, leave the network and Adam's state "unchanged",
        # or scale the actor's update by 0 ("frozen_actor")
        self.fault: Optional[str] = None

    # -- policy ---------------------------------------------------------------
    def net_in(self, obs, toh=None):
        x = obs / self.scales
        x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=50.0, neginf=-50.0), -50.0, 50.0)
        x = torch.clamp((x - self.mean) * torch.rsqrt(self.var + 1e-8), -10.0, 10.0)
        if self.task_dim:
            x = torch.cat([x, toh.expand(x.shape[:-1] + (self.task_dim,))], dim=-1)
        return x

    def schedules(self):
        cfg, k = self.cfg, self.update_count
        f32 = np.float32
        if cfg.get("anneal_updates", 0) > 0:
            frac = np.clip(f32(1.0) - f32(k) / f32(cfg["anneal_updates"]),
                           f32(cfg.get("anneal_floor", 0.05)), f32(1.0))
        else:
            frac = f32(1.0)
        warm = cfg.get("critic_warmup", 0)
        scale = (0.0 if k < warm else 1.0) if warm > 0 else None
        return f32(cfg["lr"]) * frac, f32(cfg["ent_coef"]) * frac, scale

    # -- collection -------------------------------------------------------------
    @torch.no_grad()
    def collect(self, steps: int) -> Dict[str, torch.Tensor]:
        """One rollout of `steps` from the farm: per step the stochastic
        policy, then the plain env step; then the reward sanitising and
        the value of every pre-reset observation."""
        b, dev = self.num_envs, self.dev
        start = self.carry
        eta = torch.randn((steps, 3, b), generator=self.gen, device=dev) * (1.0 / self.sim.dt) ** 0.5
        cap = torch.tensor(1e9, device=dev)
        xbuf = torch.empty((steps, XROWS, b), device=dev)
        obs_buf = torch.empty((steps, b, 17), device=dev)
        raw, logp, value = [], [], []
        for t in range(steps):
            obs_buf[t].copy_(self.carry[O0:D0].T)
            mean, log_std, v = forward(self.leaves, self.net_in(obs_buf[t], self.toh))
            log_std = torch.clamp(log_std, max=cap)
            noise = torch.randn((b, 4), generator=self.gen, device=dev)
            action = mean + torch.exp(log_std) * noise
            logp.append(gaussian_log_prob(mean, log_std, action))
            raw.append(action)
            value.append(v)
            act = torch.clamp(self.act_bias + action, -1.0, 1.0).contiguous()
            self.carry, xbuf[t] = self.stepper(self.carry, act, eta[t])
        self.carry = self.carry.clone()       # off the step graph's buffer
        if self.fault == "alter":
            xbuf[0, CREW, 0] += 1.0
        reward = torch.clamp(torch.nan_to_num(xbuf[:, CREW], nan=-100.0, posinf=100.0,
                                              neginf=-100.0), -100.0, 100.0)
        if self.fault == "unchanged":
            self.carry = start
        final_obs = xbuf[:, CFINAL0:XROWS].permute(0, 2, 1)
        v_boot = forward(self.leaves, self.net_in(final_obs, self.toh))[2]
        return {"obs": obs_buf, "action": torch.stack(raw), "log_prob": torch.stack(logp),
                "value": torch.stack(value), "reward": reward, "v_boot": v_boot,
                "terminated": xbuf[:, CDONE], "truncated": xbuf[:, CTRUNC],
                "failed": xbuf[:, CFAIL], "succ_step": xbuf[:, CSUCC],
                "carry": self.carry}

    # -- the update -----------------------------------------------------------------
    def gae(self, tr):
        cfg = self.cfg
        gamma, lam = cfg.get("gamma", 0.99), cfg.get("gae_lambda", 0.95)
        not_reset = (1.0 - tr["terminated"]) * (1.0 - tr["truncated"])
        boot = torch.where(tr["terminated"] > 0, 0.0, tr["v_boot"])
        r = (tr["reward"] + cfg.get("success_bonus", 0.0) * tr["succ_step"]
             - cfg.get("fail_penalty", 0.0) * tr["failed"])
        delta = r + gamma * boot - tr["value"]
        decay = (gamma * lam) * not_reset
        adv = torch.empty_like(delta)
        g = torch.zeros_like(delta[-1])
        for t in range(delta.shape[0] - 1, -1, -1):
            g = delta[t] + decay[t] * g
            adv[t] = g
        return adv, adv + tr["value"]

    def loss(self, leaves, obs, toh, action, old_logp, old_value, adv, ret,
             adv_mean, adv_std, size, ent_coef):
        cfg = self.cfg
        mean, log_std, value = forward(leaves, self.net_in(obs, toh))
        log_std = torch.minimum(log_std, torch.tensor(1e9, device=self.dev))
        ratio = torch.exp(gaussian_log_prob(mean, log_std, action) - old_logp)
        a = (adv - adv_mean) / (adv_std + 1e-8)
        clip = cfg.get("clip_eps", 0.2)
        pg = -torch.minimum(ratio * a, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * a).sum() / size
        vclip = cfg.get("vf_clip_eps", 0.2)
        if vclip > 0:
            vc = old_value + torch.clamp(value - old_value, -vclip, vclip)
            vl = 0.5 * torch.maximum((value - ret) ** 2, (vc - ret) ** 2).sum() / size
        else:
            vl = 0.5 * ((value - ret) ** 2).sum() / size
        ent = gaussian_entropy(log_std).sum() / size
        return pg + cfg.get("vf_coef", 0.5) * vl - ent_coef * ent

    def adam_step(self, grads, lr, scale):
        """Clip by global norm, Adam with bias correction, then `-lr`, the
        actor's updates times `scale` (None: no scale), in place."""
        max_norm = self.cfg.get("max_grad_norm", 0.5)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        keep = norm < max_norm
        one = torch.ones((), device=self.dev)
        div, mul = torch.where(keep, one, norm), torch.where(keep, one, one * max_norm)
        grads = [g / div * mul for g in grads]
        self.mu = [g * (1.0 - B1) + m * B1 for g, m in zip(grads, self.mu)]
        self.nu = [(g * g) * (1.0 - B2) + v * B2 for g, v in zip(grads, self.nu)]
        self.count = torch.where(self.count < torch.iinfo(torch.int32).max,
                                 self.count + 1, self.count)
        steps = self.count.to(torch.float32)
        c1, c2 = 1.0 - torch.pow(B1, steps), 1.0 - torch.pow(B2, steps)
        lr_t = -torch.as_tensor(lr, dtype=torch.float32, device=self.dev)
        actor = set(actor_indices())
        with torch.no_grad():
            for i, (p, m, v) in enumerate(zip(self.leaves, self.mu, self.nu)):
                u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) * lr_t
                if scale is not None and i in actor:
                    u = u * scale
                p.add_(u)

    def update(self, tr) -> Dict[str, object]:
        """GAE, then `epochs` x `minibatches` steps over the flattened
        rollout, each on a random permutation's slice; the statistics stay
        frozen. Returns the mean loss, the advantages and returns, and the
        gradient norm of each leaf at the first minibatch step."""
        cfg = self.cfg
        if not cfg.get("freeze_obs_stats", False):
            raise ValueError("the reference's update keeps the statistics frozen")
        lr, ent_coef, scale = self.schedules()
        if self.fault == "frozen_actor":
            scale = 0.0
        with torch.no_grad():
            adv, ret = self.gae(tr)
        n = adv.numel()
        flat = lambda x: x.reshape((n,) + x.shape[2:])
        obs, act = flat(tr["obs"]), flat(tr["action"])
        logp, val = flat(tr["log_prob"]), flat(tr["value"])
        toh = (self.toh.expand((tr["obs"].shape[0],) + self.toh.shape).reshape(n, -1)
               if self.task_dim else None)
        fa, fr = adv.reshape(-1), ret.reshape(-1)
        mbs = cfg["minibatches"]
        mb = n // mbs
        for p in self.leaves:
            p.requires_grad_(True)
        losses, first_grads = [], None
        for _ in range(cfg["epochs"]):
            idx = torch.randperm(n, generator=self.gen, device=self.dev)[:mbs * mb]
            pick = lambda x: x.index_select(0, idx)
            o, a, lp, v = pick(obs), pick(act), pick(logp), pick(val)
            t = pick(toh) if toh is not None else None
            ad, rt = pick(fa), pick(fr)
            parts = torch.split(ad, [mb] * mbs)
            means = torch.stack([q.sum() for q in parts]) / mb
            stds = torch.sqrt(torch.stack([((q - m) ** 2).sum()
                                           for q, m in zip(parts, means)]) / mb)
            for i in range(mbs):
                s = slice(i * mb, (i + 1) * mb)
                size, m_i, s_i = mb, means[i], stds[i]
                if self.fault == "half_batch":
                    s = slice(i * mb, i * mb + mb // 2)
                    size, m_i, s_i = mb // 2, ad[s].mean(), ad[s].std(correction=0)
                loss = self.loss(self.leaves, o[s], None if t is None else t[s], a[s],
                                 lp[s], v[s], ad[s], rt[s], m_i, s_i, size,
                                 float(ent_coef))
                grads = torch.autograd.grad(loss, self.leaves)
                if first_grads is None:
                    first_grads = [float(torch.linalg.vector_norm(g)) for g in grads]
                if self.fault != "unchanged":
                    self.adam_step(grads, lr, scale)
                losses.append(loss.detach())
        for p in self.leaves:
            p.requires_grad_(False)
        self.update_count += 1
        return {"loss": float(torch.stack(losses).mean()), "advantages": adv,
                "returns": ret, "first_grads": first_grads}
