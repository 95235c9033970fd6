"""Batched policy evaluation: N independent fresh-trim episodes in lockstep.

    python -m heligym_tpu_torch.learner.evaluate \
        --checkpoint examples/hover4k_policy.npz \
        --task hover --target sea_alt=start --episodes 256 --seeds 0,1,2

Each episode runs to its OWN first termination (success / crash / 40 s
wall); there is no auto-reset, so the reported fractions are true
per-episode statistics, not per-transition ones. Per-env end flags are
latched on the device. The env steps through `fused_step(auto_reset=False)`:
the CUDA kernel on the card, its plain version with `--cpu`.

Checkpoints are the flat-npz TrainStates the JAX package commits under
`examples/`; the reader needs no template, so `--train-num-envs` only sizes
the learner's config and no result depends on it. Deterministic (mean-policy) evaluation is the default;
`--stochastic` samples from the learned Gaussian instead. Noise (Dryden
wind, action samples) comes from a `torch.Generator` seeded with `--seed`,
so the streams differ from the JAX evaluator's: results agree statistically,
not episode by episode.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..envs import HeliEnv, VectorHeliEnv
from ..envs.tasks import MixedTask
from ..ops.cuda import fused_step as fs
from .ppo import PPOConfig, PPOLearner, TrainState
from .train import TASKS, _band, _parse_target, make_alt_grid_sampler


def rollout(env: HeliEnv, es, act_fn, steps: int,
            generator: Optional[torch.Generator] = None, *, eta_seq=None,
            keep_obs: bool = False) -> dict:
    """Step the farm `es` for `steps` steps without auto-reset, each step
    one `fused_step(env, ..., auto_reset=False)`: the CUDA kernel on the
    card, its plain version on the CPU. Every evaluator and collector of the
    port runs on this loop.

    `act_fn(t, obs) -> (executed (B, 4), extra)` acts on the observations
    before step t; `extra`, a (B, k) tensor or None, is kept for every
    step. The Dryden noise of step t is `eta_seq[t]` ((T, 3, B), already
    scaled by 1/sqrt(dt)), else drawn from `generator` after `act_fn`.
    Success is read from the counter before each step, as the env's
    criterion does, and each env's first end is latched; an env runs on
    past its end.

    Returns `alive` (T, B) bool, true on each env's steps up to and with
    its first end; `succ` and `fail` (B,) bool; `end` (B,) int32, the step
    of the first end or -1; `reward` (B,), the rewards summed up to the end
    (a non-finite one counts 0); `last_obs` (B, 17), the observations after
    the last step; `extra` (T, B, k) when `act_fn` returns one; and with
    `keep_obs` `obs` (T, B, 17), each step's observations."""
    carry, init = fs.pack(es)
    n, dev = carry.shape[1], carry.device
    succ_required = float(env.success_steps_required)
    eta_scale = (1.0 / env.dt) ** 0.5
    xbuf = torch.empty((fs.XROWS, n), dtype=torch.float32, device=dev)
    obs_buf = (torch.empty((steps, n, 17), dtype=torch.float32, device=dev)
               if keep_obs else None)
    alive_buf = torch.empty((steps, n), dtype=torch.bool, device=dev)
    extra_buf = None
    succ = torch.zeros(n, dtype=torch.bool, device=dev)
    fail = torch.zeros(n, dtype=torch.bool, device=dev)
    end = torch.full((n,), -1, dtype=torch.int32, device=dev)
    reward = torch.zeros(n, dtype=torch.float32, device=dev)
    for t in range(steps):
        obs = carry[fs.O0:fs.D0].T
        if keep_obs:
            obs_buf[t] = obs
        act, extra = act_fn(t, obs)
        if extra is not None:
            if extra_buf is None:
                extra_buf = torch.empty((steps,) + tuple(extra.shape),
                                        dtype=extra.dtype, device=dev)
            extra_buf[t] = extra
        eta = (eta_seq[t] if eta_seq is not None else
               torch.randn((3, n), generator=generator, device=dev) * eta_scale)
        # the env's success criterion reads the counter before the step
        successed = carry[fs.SUCC] >= succ_required
        fs.fused_step(env, carry, init, act.contiguous(), eta.contiguous(),
                      auto_reset=False, carry_out=carry, collect_out=xbuf)
        alive = end < 0
        alive_buf[t] = alive
        end_now = ((xbuf[fs.CDONE] != 0) | (xbuf[fs.CTRUNC] != 0)) & alive
        # a blown-up env can emit one non-finite reward before its
        # non-finite-state termination; keep the sums finite
        r = torch.nan_to_num(xbuf[fs.CREW], nan=0.0, posinf=0.0, neginf=0.0)
        succ = succ | (end_now & successed)
        fail = fail | (end_now & (xbuf[fs.CFAIL] != 0))
        end = torch.where(end_now, t, end)
        reward = reward + torch.where(alive, r, 0.0)
    out = {"alive": alive_buf, "succ": succ, "fail": fail, "end": end,
           "reward": reward, "last_obs": carry[fs.O0:fs.D0].T.clone()}
    if extra_buf is not None:
        out["extra"] = extra_buf
    if keep_obs:
        out["obs"] = obs_buf
    return out


def make_evaluator(env: HeliEnv, learner: PPOLearner, *, episodes: int,
                   steps: int, stochastic: bool = False,
                   trim_cond=None, task_ids=None, cond_sampler=None):
    """Build a reusable evaluator `fn(ts, generator) -> stats dict`;
    `generator` is a `torch.Generator` on the env's device. Every episode
    starts from the trim of `trim_cond`, or with `cond_sampler` (see
    `train.make_alt_grid_sampler`) from its own start condition through the
    batched Newton trim."""
    venv = VectorHeliEnv(env, episodes, auto_reset=False)

    def run(params, stats, es, generator):
        toh = learner._task_oh(es.task_id)

        def act(t, obs):
            return learner.policy(params, obs, generator, stats, toh,
                                  stochastic=stochastic), None
        return rollout(env, es, act, steps, generator)

    def evaluator(ts: TrainState, generator: torch.Generator) -> dict:
        if cond_sampler is not None:
            es0, _ = venv.reset_randomized(generator, cond_sampler)
        else:
            es0, _ = venv.reset(trim_cond)
        if task_ids is not None:
            es0 = venv.assign_tasks(es0, task_ids)
        stats = ts.obs_stats if learner.config.obs_norm else None
        with torch.no_grad():
            res = {k: v.cpu().numpy()
                   for k, v in run(ts.params, stats, es0, generator).items()
                   if k in ("succ", "fail", "end", "reward")}
        succ, fail, end = res["succ"], res["fail"], res["end"]
        ended = end >= 0
        out = {
            "episodes": episodes,
            "success_frac": float(succ.mean()),
            "fail_frac": float(fail.mean()),
            # time_up without the success criterion firing, or never ended
            # within the horizon
            "timeout_frac": float((~succ & ~fail).mean()),
            "median_end_step": int(np.median(np.where(ended, end, steps))),
            "mean_episode_reward": float(
                (res["reward"] / np.maximum(np.where(ended, end + 1, steps),
                                            1)).mean()),
        }
        if task_ids is not None:
            tid = np.asarray(task_ids)
            for i in sorted(set(tid.tolist())):
                m = tid == i
                out[f"success_frac_t{i}"] = float(succ[m].mean())
                out[f"fail_frac_t{i}"] = float(fail[m].mean())
        return out

    return evaluator


def evaluate(env: HeliEnv, learner: PPOLearner, ts: TrainState, *,
             episodes: int, steps: int, generator: torch.Generator,
             stochastic: bool = False, trim_cond=None, task_ids=None,
             cond_sampler=None) -> dict:
    """One-shot wrapper over `make_evaluator` (CLI entry point)."""
    return make_evaluator(env, learner, episodes=episodes, steps=steps,
                          stochastic=stochastic, trim_cond=trim_cond,
                          task_ids=task_ids, cond_sampler=cond_sampler)(ts, generator)


#: the standard committed-artifact eval protocol (examples/*_eval.json):
#: every artifact is scored on the SAME seed set, both policies
STANDARD_SEEDS = (0, 1, 2)


def seeded_generator(env: HeliEnv, seed: int) -> torch.Generator:
    return torch.Generator(device=env.device).manual_seed(int(seed))


def multi_seed_evaluate(env: HeliEnv, learner: PPOLearner, ts: TrainState, *,
                        episodes: int, steps: int, seeds,
                        trim_cond=None, task_ids=None, cond_sampler=None) -> dict:
    """Run the evaluator over `seeds` for BOTH the deterministic (mean) and
    the stochastic policy; return per-seed results plus aggregates
    (mean/std/min/max over seeds of the headline fractions — the cross-seed
    std answers "was this one lucky seed?")."""
    per_seed = {"mean": [], "stochastic": []}
    for policy_name, stochastic in (("mean", False), ("stochastic", True)):
        ev = make_evaluator(env, learner, episodes=episodes, steps=steps,
                            stochastic=stochastic, trim_cond=trim_cond,
                            task_ids=task_ids, cond_sampler=cond_sampler)
        for seed in seeds:
            r = ev(ts, seeded_generator(env, seed))
            per_seed[policy_name].append({"seed": int(seed), **r})

    def aggregate(rows):
        keys = [k for k in rows[0]
                if k.startswith(("success_frac", "fail_frac", "timeout_frac"))]
        out = {}
        for k in keys:
            v = np.asarray([r[k] for r in rows], np.float64)
            out[k] = {"mean": float(v.mean()), "std": float(v.std()),
                      "min": float(v.min()), "max": float(v.max())}
        return out

    return {"episodes": episodes, "seeds": [int(s) for s in seeds],
            "per_seed": per_seed,
            "aggregate": {p: aggregate(rows) for p, rows in per_seed.items()}}


def build_env(task: str = "hover", tasks: str = None, target: str = None,
              max_time: float = None, turb_level: int = None, device=None):
    """The evaluation env of the command line: (env, number of sub-tasks or
    0). `tasks` is a comma list for a MixedTask; `target` a 'k=v,...'
    override applied to every (sub-)task that has the key."""
    if tasks:
        names = [s.strip() for s in tasks.split(",") if s.strip()]
        task_obj = MixedTask(tasks=tuple(TASKS[n]() for n in names))
    else:
        names, task_obj = [], TASKS[task]()
    env = HeliEnv.build("aw109", task=task_obj, device=device)
    if target:
        updates = _parse_target(target, env)
        if names:
            subs = tuple(t.with_target(**{k: v for k, v in updates.items()
                                          if k in t.target_dict()})
                         for t in env.task.tasks)
            env = env.replace(task=MixedTask(tasks=subs))
        else:
            env = env.replace(task=env.task.with_target(**updates))
    if max_time is not None:
        env = env.replace(max_time=max_time)
    if turb_level is not None:
        env = env.replace(wind_params=dataclasses.replace(
            env.wind_params, turbulence_level=turb_level))
    return env, len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--task", choices=sorted(TASKS), default="hover")
    ap.add_argument("--tasks", default=None,
                    help="comma list for MixedTask checkpoints (must match "
                         "training); episodes are split round-robin and "
                         "per-task fractions reported")
    ap.add_argument("--target", default=None,
                    help="task target override 'k=v,...' (match training)")
    ap.add_argument("--train-num-envs", type=int, default=512,
                    help="num_envs of the TRAINING run: sizes the learner's "
                         "config; the checkpoint reader needs no template, so "
                         "no result depends on it")
    ap.add_argument("--episodes", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0,
                    help="horizon (0 = the env's 40 s wall + margin)")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample the learned Gaussian instead of the mean")
    ap.add_argument("--set-log-std", type=float, default=None,
                    help="overwrite the checkpoint's learned log-std before "
                         "evaluating — probes how stochastic success scales "
                         "with noise without retraining")
    ap.add_argument("--no-center-actions", action="store_true")
    ap.add_argument("--start-alt", type=float, default=None,
                    help="initial trim altitude above ground [ft] "
                         "(match training)")
    ap.add_argument("--start-band", type=str, default=None, metavar="LO:HI",
                    help="evaluate on a deterministic linspace(LO, HI) "
                         "start-altitude grid (one altitude per episode, "
                         "batched Newton trim) instead of a single "
                         "--start-alt — reports band-wide generalization")
    ap.add_argument("--max-time", type=float, default=None,
                    help="episode wall [s] (match training)")
    ap.add_argument("--turb-level", type=int, default=None,
                    help="override the Dryden turbulence level (1..7) for "
                         "the evaluation env — robustness probe (mean wind "
                         "unchanged)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=str, default=None, metavar="S0,S1,...",
                    help="multi-seed protocol: run EVERY listed seed for "
                         "BOTH the mean and the stochastic policy and "
                         "report per-seed + aggregate stats (the standard "
                         "committed-artifact protocol is seeds 0,1,2 x 256 "
                         "episodes). Overrides --seed/--stochastic.")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.start_band and args.start_alt is not None:
        ap.error("--start-band and --start-alt are mutually exclusive")

    env, n_tasks = build_env(args.task, args.tasks, args.target, args.max_time,
                             args.turb_level, "cpu" if args.cpu else None)
    task_ids = np.arange(args.episodes) % n_tasks if n_tasks else None
    learner = PPOLearner(
        env, PPOConfig(num_envs=args.train_num_envs,
                       center_actions=not args.no_center_actions))
    ts = learner.restore(args.checkpoint)
    if args.set_log_std is not None:
        with torch.no_grad():
            ts.params.log_std.fill_(args.set_log_std)

    steps = args.steps or env.time_up_steps + 3
    trim_cond = ({"gr_alt": args.start_alt}
                 if args.start_alt is not None else None)
    cond_sampler = make_alt_grid_sampler(*_band(args.start_band)) if args.start_band else None
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",")]
        result = multi_seed_evaluate(
            env, learner, ts, episodes=args.episodes, steps=steps,
            seeds=seeds, trim_cond=trim_cond, task_ids=task_ids,
            cond_sampler=cond_sampler)
        result = {"checkpoint": args.checkpoint,
                  "turb_level": args.turb_level, **result}
    else:
        result = evaluate(
            env, learner, ts, episodes=args.episodes, steps=steps,
            generator=seeded_generator(env, args.seed),
            stochastic=args.stochastic, trim_cond=trim_cond,
            task_ids=task_ids, cond_sampler=cond_sampler)
        result = {"checkpoint": args.checkpoint,
                  "policy": "stochastic" if args.stochastic else "mean",
                  "seed": args.seed, "turb_level": args.turb_level, **result}
    print(json.dumps(result, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
