"""Self-imitation distillation: clone successful stochastic episodes into
the deterministic mean policy.

    python -m heligym_tpu_torch.learner.distill --checkpoint land.npz \
        --task landing --target touch_alt=ground --train-num-envs 2048 \
        --band 6:55 --episodes 2048 --rounds 4 --out distilled.npz

The port of the JAX package's `learner/distill.py`. On the landing task the
stochastic policy can succeed far more often than its own mean: the
exploration dither is load-bearing. Conditioned on success, the executed
noise correlates with the state, so regressing the mean onto the executed
actions of successful episodes (reward-filtered behaviour cloning) distills
that correlation into a deterministic feedback law. Rounds of collect ->
clone, each collecting under the updated policy, walk the mean toward a
policy whose deterministic rollout lands.

Only the actor tower is regressed: the critic and log_std stay bit-equal,
so a PPO polish can resume from the distilled checkpoint. After a
std-cap-annealed run the stored log_std keeps its pre-cap value; pass
--collect-std-cap (or --collect-log-std) to collect under the behaviour the
run trained.

Every collector steps the farm through `fused_step(auto_reset=False)`: the
CUDA kernel on the card, its plain version with `--cpu`. Noise comes from
`torch.Generator`s seeded from `--seed` (the evaluation's from 1234), so the
streams differ from the JAX tool's: results agree statistically.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..envs import HeliEnv, VectorHeliEnv
from .evaluate import make_evaluator, rollout
from .optim import adam_init, adam_update
from .ppo import PPOConfig, PPOLearner, TrainState, _fp32_matmuls
from .train import (TASKS, _band, _parse_target, make_alt_band_sampler,
                    make_alt_grid_sampler)


def make_collector(env: HeliEnv, learner: PPOLearner, *, episodes: int,
                   steps: int, cond_sampler):
    """Build a reusable `collect(ts, generator, ...) -> (obs, resid, w,
    succ_frac)` rolling `episodes` stochastic episodes for `steps` steps,
    without auto-reset; obs (T, B, 17), resid (T, B, 4), w (T, B) float32 is
    1 only on the pre-termination steps of successful episodes.

    The regression target is the executed action as the pre-bias residual
    (executed - act_bias): cloning it makes clip(act_bias + mean(obs))
    reproduce the executed action. Success is read from the counter before
    each step, as the env's criterion does; each env's first end is latched.

    Seams (for parity tests): `start` (an EnvState: no reset), `noise`
    (T, B, 4) standard-normal action noise, `eta_seq` (T, 3, B) Dryden noise
    already scaled by 1/sqrt(dt). What is not given is drawn from
    `generator`, a `torch.Generator` on the env's device: the reset's start
    conditions first, then each step's action noise and Dryden noise."""
    venv = VectorHeliEnv(env, episodes, auto_reset=False)

    def run(params, log_std, stats, es, generator, noise, eta_seq):
        toh = learner._task_oh(es.task_id)
        std = torch.exp(log_std)

        def act(t, obs):
            mean = params(learner._net_in(obs, stats, toh))[0]
            n_t = (noise[t] if noise is not None else
                   torch.randn(mean.shape, generator=generator, device=mean.device))
            executed = torch.clamp(learner.act_bias + mean + std * n_t, -1.0, 1.0)
            return executed, executed - learner.act_bias
        r = rollout(env, es, act, steps, generator, eta_seq=eta_seq, keep_obs=True)
        w = r["alive"] & r["succ"][None, :]
        return r["obs"], r["extra"], w.to(torch.float32), r["succ"]

    def collect(ts: TrainState, generator: Optional[torch.Generator] = None, *,
                log_std_override: Optional[float] = None,
                std_cap: Optional[float] = None, start=None, noise=None,
                eta_seq=None):
        log_std = ts.params.log_std.detach()
        if log_std_override is not None:
            log_std = torch.full_like(log_std, log_std_override)
        elif std_cap is not None:
            # a std-cap-annealed run's effective behaviour std
            log_std = torch.clamp(log_std, max=std_cap)
        print(f"  sampling log_std = "
              f"{np.array2string(log_std.cpu().numpy(), precision=2)}", flush=True)
        stats = ts.obs_stats if learner.config.obs_norm else None
        if start is not None:
            es0 = start
        elif cond_sampler is not None:
            es0, _ = venv.reset_randomized(generator, cond_sampler)
        else:
            es0, _ = venv.reset()
        with torch.no_grad(), _fp32_matmuls():
            obs, resid, w, succ = run(ts.params, log_std, stats, es0, generator,
                                      noise, eta_seq)
        return obs, resid, w, float(succ.to(torch.float32).mean())

    return collect


def make_bc_fitter(learner: PPOLearner, *, lr: float, minibatch: int):
    """Build a reusable weighted-MSE regressor of the actor mean onto
    residuals: `fit(ts, obs, resid, w, *, epochs, generator) -> (ts', loss)`.

    Plain Adam (optax.adam: b1 0.9, b2 0.999, eps 1e-8, no clipping), fresh
    on each call, steps only the actor tower minus log_std: the critic,
    log_std and the learner's own Adam state stay bit-equal. The network is
    copied, so `ts` keeps its parameters. Each epoch cuts a permutation to
    `nb * mb` rows (`mb = min(minibatch, n)`, `nb = n // mb`; the remainder
    is dropped); the loss returned is the mean over the last epoch's
    minibatches. The dataset stays on its device; the only host sync is the
    returned loss.

    `task_oh` (T, B, K): the per-row task one-hot of a MixedTask student's
    input (the rows of a multitask dataset come from different tasks).
    `perms`: one permutation of the n rows per epoch (injected by tests);
    by default drawn from `generator`."""
    def loss_fn(net, stats, o, r, ww, toh):
        mean = net(learner._net_in(o, stats, toh))[0]
        per = torch.sum((mean - r) ** 2, dim=-1)
        return torch.sum(ww * per) / (torch.sum(ww) + 1e-8)

    def fit(ts: TrainState, obs, resid, w, *, epochs: int,
            generator: Optional[torch.Generator] = None, task_oh=None,
            perms: Optional[Sequence[torch.Tensor]] = None):
        if epochs < 1:
            raise ValueError("bc_fit needs epochs >= 1")
        T, B = w.shape
        n = T * B
        obs = obs.reshape(n, -1)
        resid = resid.reshape(n, -1)
        w = w.reshape(n)
        toh = None if task_oh is None else task_oh.reshape(n, -1)
        stats = ts.obs_stats if learner.config.obs_norm else None
        net = copy.deepcopy(ts.params)
        names = net.actor_flax_names() - {"log_std"}
        actor = [p for name, _, p in net.flax_leaves() if name in names]
        state = adam_init(actor)
        mb = min(minibatch, n)                 # small sanity runs: n < minibatch
        nb = n // mb
        lr_t = torch.tensor(-lr, dtype=torch.float32, device=w.device)
        with _fp32_matmuls():
            for e in range(epochs):
                perm = (perms[e] if perms is not None else
                        torch.randperm(n, generator=generator, device=w.device))
                idx = perm[:nb * mb].reshape(nb, mb)
                losses = []
                for i in range(nb):
                    sel = idx[i]
                    loss = loss_fn(net, stats, obs[sel], resid[sel], w[sel],
                                   None if toh is None else toh[sel])
                    grads = torch.autograd.grad(loss, actor)
                    direction, state = adam_update(grads, state)
                    with torch.no_grad():
                        torch._foreach_add_(actor, torch._foreach_mul(direction, lr_t))
                    losses.append(loss.detach())
        return ts.replace(params=net), float(torch.stack(losses).mean())

    return fit


def mask_non_finite(obs, label, w):
    """(obs, label, w) with every row whose obs or label is not finite
    weighted 0 and zeroed: an env blown up past its end can emit non-finite
    observations, and a 0-weight NaN row still poisons the loss (0 * NaN is
    NaN). `w` (T, B) bool; the returned weights are float32. (The scripted
    and hybrid distillation tools sanitize their datasets so; the
    self-imitation collector does not, as the JAX module does not.)"""
    finite = torch.isfinite(obs).all(-1) & torch.isfinite(label).all(-1)
    clean = lambda x: torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return clean(obs), clean(label), (w & finite).to(torch.float32)


def collect_successful(env, learner, ts, *, episodes, steps, generator,
                       cond_sampler, log_std_override=None, std_cap=None):
    """One-shot wrapper over `make_collector` (tests / interactive use)."""
    return make_collector(env, learner, episodes=episodes, steps=steps,
                          cond_sampler=cond_sampler)(
        ts, generator, log_std_override=log_std_override, std_cap=std_cap)


def bc_fit(learner, ts, obs, resid, w, *, epochs, lr, minibatch, generator):
    """One-shot wrapper over `make_bc_fitter` (tests / interactive use)."""
    return make_bc_fitter(learner, lr=lr, minibatch=minibatch)(
        ts, obs, resid, w, epochs=epochs, generator=generator)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--task", choices=sorted(TASKS), default="landing")
    ap.add_argument("--target", default=None)
    ap.add_argument("--train-num-envs", type=int, default=512,
                    help="the checkpoint's training num_envs: sizes the "
                         "learner's config; the reader needs no template")
    ap.add_argument("--band", type=str, default="6:55", metavar="LO:HI",
                    help="start-altitude band: collection samples it "
                         "uniformly, evaluation grids it; 'none' uses the "
                         "task's default trim resets (non-landing tasks)")
    ap.add_argument("--episodes", type=int, default=2048,
                    help="stochastic episodes collected per round")
    ap.add_argument("--rounds", type=int, default=4,
                    help="DAgger-style collect->clone rounds (collection "
                         "re-runs under the UPDATED policy each round)")
    ap.add_argument("--epochs", type=int, default=8,
                    help="BC epochs over the collected dataset per round")
    ap.add_argument("--bc-lr", type=float, default=3e-4)
    ap.add_argument("--minibatch", type=int, default=65536)
    ap.add_argument("--collect-log-std", type=float, default=None,
                    help="sample collection actions at this log-std instead "
                         "of the checkpoint's parameter")
    ap.add_argument("--collect-std-cap", type=float, default=None,
                    help="elementwise ceiling on the sampling log-std: set it "
                         "to the training run's --std-cap-final (after a "
                         "std-cap anneal the stored parameter keeps its "
                         "pre-cap value)")
    ap.add_argument("--eval-band", type=str, default=None, metavar="LO:HI",
                    help="evaluation/selection altitude grid when it should "
                         "differ from the collection band; default: --band")
    ap.add_argument("--eval-episodes", type=int, default=256)
    ap.add_argument("--turb-level", type=int, default=None,
                    help="override the Dryden turbulence level (1..7) for "
                         "collection (robustness distillation)")
    ap.add_argument("--eval-turb-level", type=int, default=None,
                    help="turbulence level of the selection evaluator "
                         "(default: the model's nominal level)")
    ap.add_argument("--no-center-actions", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="output checkpoint; '<out>.best.npz' keeps the "
                         "round with the highest deterministic band success "
                         "(round 0 = the input checkpoint)")
    ap.add_argument("--metrics-out", default=None)
    return ap


def with_turbulence(env: HeliEnv, level: Optional[int]) -> HeliEnv:
    """`env` with its Dryden turbulence level overridden (the mean wind, and
    so the trim, unchanged); None keeps it."""
    if level is None:
        return env
    return env.replace(wind_params=dataclasses.replace(
        env.wind_params, turbulence_level=level))


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = HeliEnv.build("aw109", task=TASKS[args.task](),
                        device="cpu" if args.cpu else None)
    if args.target:
        env = env.replace(task=env.task.with_target(
            **_parse_target(args.target, env)))
    collect_env = with_turbulence(env, args.turb_level)
    eval_env = with_turbulence(env, args.eval_turb_level)
    learner = PPOLearner(
        env, PPOConfig(num_envs=args.train_num_envs,
                       center_actions=not args.no_center_actions))
    ts = learner.restore(args.checkpoint, with_farm=True)

    if args.band == "none":
        band = grid = None
    else:
        band = make_alt_band_sampler(*_band(args.band))
        grid = make_alt_grid_sampler(*_band(args.band))
    if args.eval_band:
        grid = make_alt_grid_sampler(*_band(args.eval_band))
    steps = env.time_up_steps + 3
    collector = make_collector(collect_env, learner, episodes=args.episodes,
                               steps=steps, cond_sampler=band)
    fitter = make_bc_fitter(learner, lr=args.bc_lr, minibatch=args.minibatch)
    evaluator = make_evaluator(eval_env, learner, episodes=args.eval_episodes,
                               steps=steps, cond_sampler=grid)
    generator = torch.Generator(device=env.device).manual_seed(args.seed)

    def evaluate(ts):
        # the same noise in every round, so that rounds compare
        return evaluator(ts, torch.Generator(device=env.device).manual_seed(1234))

    r0 = evaluate(ts)
    print(f"round 0 (input): det band success={r0['success_frac']:.3f} "
          f"fail={r0['fail_frac']:.3f}", flush=True)
    best, best_ts = r0["success_frac"], ts
    # the input checkpoint is round 0's best: save it so that the printed
    # '<out>.best.npz' path exists even if no round improves on it
    learner.save(args.out + ".best.npz", best_ts)
    history = [{"round": 0, **r0}]

    for rnd in range(1, args.rounds + 1):
        obs, resid, w, succ = collector(
            ts, generator, log_std_override=args.collect_log_std,
            std_cap=args.collect_std_cap)
        kept = float(torch.sum(w))
        print(f"round {rnd}: collected {args.episodes} episodes, "
              f"stochastic success={succ:.3f}, {kept:.0f} cloned steps",
              flush=True)
        if kept < 1.0:
            print("no successful episodes - stopping", flush=True)
            break
        ts, loss = fitter(ts, obs, resid, w, epochs=args.epochs, generator=generator)
        ev = evaluate(ts)
        print(f"round {rnd}: bc_loss={loss:.5f} det band "
              f"success={ev['success_frac']:.3f} "
              f"fail={ev['fail_frac']:.3f}", flush=True)
        history.append({"round": rnd, "stoch_success": succ,
                        "bc_loss": loss, **ev})
        if ev["success_frac"] > best:
            best, best_ts = ev["success_frac"], ts
            learner.save(args.out + ".best.npz", best_ts)
            print(f"  saved best (round {rnd}, success={best:.3f})", flush=True)

    learner.save(args.out, ts)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"config": vars(args), "history": history}, f)
    print(f"final: last round -> {args.out}; best det band success={best:.3f}"
          f" -> {args.out}.best.npz")


if __name__ == "__main__":
    main()
