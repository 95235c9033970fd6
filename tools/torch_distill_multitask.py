#!/usr/bin/env python
"""Distill single-task expert policies into one task-conditioned network.

    python tools/torch_distill_multitask.py \
        --experts hover=examples/hover_policy.npz:512,forward=examples/forward_policy.npz:512 \
        --target sea_alt=start,vel=60 \
        --out-num-envs 1024 --out mt_distilled.npz --eval-episodes 256

The port of the JAX package's `tools/distill_multitask.py`. PPO on a
MixedTask batch lets the dominant task's gradients overwrite the fragile
one's behaviour; supervised distillation has no such interference:
  * for each expert: roll its slightly noised policy (`--collect-log-std`
    around its mean) in its OWN env, recording every step's observation and
    the expert's deterministic mean residual there. The farm steps through
    `fused_step(auto_reset=False)`, so an episode runs on past its end, as
    the JAX tool's direct `env.step` does; only the finite rows are kept;
  * the student's obs stats come from the pooled scaled observations
    (clipped to +-50, var + 1e-6, count 5e6, so that a PPO resume with
    --freeze-obs-stats keeps them);
  * the student (obs + task one-hot input) regresses the expert residuals
    with the actor-only fitter of `learner/distill.py`, the one-hot of each
    row passed as `task_oh`, each row weighted by `--task-loss-weights`;
    log_std is set to --collect-log-std, the critic left at init (a PPO
    resume needs --critic-warmup);
  * DAgger rounds roll the student in each task's env (half the collection
    length), label with the expert, extend the dataset and refit;
  * each round is scored by the per-task deterministic evaluation.

It runs on the CUDA card (the step one launch of `csrc/fused_step.cu`) unless
`--cpu` asks for the CPU. The dataset stays on the device. Noise comes from a
`torch.Generator` seeded with --seed (the evaluation's with 1234).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experts", required=True,
                    help="comma list of task=checkpoint:num_envs entries, "
                         "in MixedTask sub-task order")
    ap.add_argument("--target", default=None,
                    help="task target override 'k=v,...' applied per task "
                         "(as in train.py)")
    ap.add_argument("--collect-steps", type=int, default=1200,
                    help="rollout length per expert")
    ap.add_argument("--collect-envs", type=int, default=512,
                    help="parallel envs per expert collection")
    ap.add_argument("--collect-log-std", type=float, default=-3.0,
                    help="exploration std around the expert mean during "
                         "collection (state coverage incl. recovery "
                         "neighborhoods)")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--dagger-rounds", type=int, default=0,
                    help="after the initial fit, N rounds of: roll the "
                         "STUDENT (with --collect-log-std noise) in each "
                         "task env, label the visited states with the "
                         "expert's mean, extend the dataset, refit")
    ap.add_argument("--bc-lr", type=float, default=3e-4)
    ap.add_argument("--minibatch", type=int, default=65536)
    ap.add_argument("--hidden", default=None, metavar="H1,H2,...",
                    help="student hidden sizes (default PPOConfig's 256,256)")
    ap.add_argument("--task-loss-weights", default=None, metavar="W0,W1,...",
                    help="per-task BC sample weights (floats, expert order)")
    ap.add_argument("--dagger-tasks", default=None,
                    help="comma subset of expert task names to run DAgger "
                         "collection on (default all)")
    ap.add_argument("--out-num-envs", type=int, required=True,
                    help="farm size of the saved student checkpoint")
    ap.add_argument("--out", required=True)
    ap.add_argument("--eval-episodes", type=int, default=256)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    return ap


def pooled_obs_stats(obs, scales):
    """The student's obs stats from the pooled observations (N, 17): the
    scaled obs clipped to +-50, their mean and variance + 1e-6, the count
    saturated at 5e6 so that a PPO resume's running merge cannot shift them
    quickly."""
    import torch
    from heligym_tpu_torch.learner import ObsStats
    scaled = torch.clamp(obs / scales, -50.0, 50.0)
    return ObsStats(mean=scaled.mean(0), var=scaled.var(0, correction=0) + 1e-6,
                    count=torch.tensor(5e6, dtype=torch.float32, device=obs.device))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from heligym_tpu_torch.envs import HeliEnv, MixedTask, VectorHeliEnv
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.distill import make_bc_fitter
    from heligym_tpu_torch.learner.evaluate import make_evaluator, rollout
    from heligym_tpu_torch.learner.ppo import _fp32_matmuls
    from heligym_tpu_torch.learner.train import TASKS, _parse_target

    device = "cpu" if args.cpu else None
    specs = []
    for entry in args.experts.split(","):
        name, rest = entry.split("=")
        ckpt, nenv = rest.rsplit(":", 1)
        specs.append((name.strip(), ckpt.strip(), int(nenv)))

    # ---- experts + per-task collectors ----------------------------------
    B, T = args.collect_envs, args.collect_steps
    noise_std = float(np.exp(np.float32(args.collect_log_std)))
    experts = []          # (name, env, learner, ts, stats)
    for name, ckpt, nenv in specs:
        env = HeliEnv.build("aw109", task=TASKS[name](), device=device)
        if args.target:
            upd = _parse_target(args.target, env)
            env = env.replace(task=env.task.with_target(
                **{k: v for k, v in upd.items() if k in env.task.target_dict()}))
        expert = PPOLearner(env, PPOConfig(num_envs=nenv))
        ts = expert.restore(ckpt)
        stats = ts.obs_stats if expert.config.obs_norm else None
        experts.append((name, env, expert, ts, stats))
    dev = experts[0][1].device

    all_obs, all_resid, all_tid = [], [], []
    student = None        # built below, before any student-driven round

    @torch.no_grad()
    def run(tid, actor, steps, generator):
        """`steps` steps of B envs in task `tid`'s env from its trim: the
        observations and the expert's deterministic residual at each."""
        _, env, expert, ts_e, stats_e = experts[tid]
        es, _ = VectorHeliEnv(env, B, auto_reset=False).reset()
        if actor is not None:
            params_s, stats_s = actor
            toh = student._task_oh(torch.full((B,), tid, dtype=torch.int32, device=dev))

        def act(t, obs):
            label = ts_e.params(expert._norm(obs, stats_e))[0]
            mean_a = (label if actor is None else
                      params_s(student._net_in(obs, stats_s, toh))[0])
            noise = torch.randn(mean_a.shape, generator=generator, device=dev)
            return torch.clamp(expert.act_bias + mean_a + noise_std * noise,
                               -1.0, 1.0), label
        r = rollout(env, es, act, steps, generator, keep_obs=True)
        return r["obs"], r["extra"]

    def collect(tid, actor, generator, steps):
        """Roll `actor` (noised) in task `tid`'s env for `steps`, labelling
        every visited state with the EXPERT's deterministic residual.
        actor = None rolls the expert itself (initial dataset); actor =
        (params_s, stats_s) rolls the student (DAgger rounds)."""
        with _fp32_matmuls():
            o, lbl = run(tid, actor, steps, generator)
        o = o.reshape(-1, o.shape[-1])
        lbl = lbl.reshape(-1, lbl.shape[-1])
        keep = torch.isfinite(o).all(-1) & torch.isfinite(lbl).all(-1)
        all_obs.append(o[keep])
        all_resid.append(lbl[keep])
        n_keep = all_obs[-1].shape[0]
        all_tid.append(torch.full((n_keep,), tid, dtype=torch.int64, device=dev))
        print(f"task {experts[tid][0]}: +{n_keep} samples "
              f"({'expert' if actor is None else 'student'}-driven)", flush=True)

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    for tid in range(len(specs)):
        collect(tid, None, generator, T)

    # ---- student ---------------------------------------------------------
    dst_task = MixedTask(tasks=tuple(TASKS[n]() for n, _, _ in specs))
    dst_env = HeliEnv.build("aw109", task=dst_task, device=device)
    if args.target:
        upd = _parse_target(args.target, dst_env)
        dst_env = dst_env.replace(task=MixedTask(tasks=tuple(
            t.with_target(**{k: v for k, v in upd.items() if k in t.target_dict()})
            for t in dst_task.tasks)))
    hidden = (tuple(int(v) for v in args.hidden.split(","))
              if args.hidden else PPOConfig.hidden)
    student = PPOLearner(dst_env, PPOConfig(num_envs=args.out_num_envs, hidden=hidden))
    task_ids = np.arange(args.out_num_envs) % len(specs)
    ts_s = student.init(torch.Generator().manual_seed(args.seed + 1), task_ids=task_ids)

    ts_s = ts_s.replace(obs_stats=pooled_obs_stats(torch.cat(all_obs), student._scales))
    with torch.no_grad():
        ts_s.params.log_std.fill_(args.collect_log_std)

    fitter = make_bc_fitter(student, lr=args.bc_lr, minibatch=args.minibatch)
    eval_tids = np.arange(args.eval_episodes) % len(specs)
    ev = make_evaluator(dst_env, student, episodes=args.eval_episodes,
                        steps=dst_env.time_up_steps + 3, task_ids=eval_tids)

    def evaluate(ts):
        return ev(ts, torch.Generator(device=dev).manual_seed(1234))

    tlw = (torch.tensor([float(v) for v in args.task_loss_weights.split(",")],
                        dtype=torch.float32, device=dev)
           if args.task_loss_weights else None)
    if tlw is not None and len(tlw) != len(specs):
        raise SystemExit("--task-loss-weights needs one weight per expert")

    def fit(ts_s):
        # the task one-hot of each row enters the student's input through
        # the fitter's `task_oh`
        t = torch.cat(all_tid)
        oh = torch.eye(len(specs), dtype=torch.float32, device=dev)[t]
        o, r = torch.cat(all_obs), torch.cat(all_resid)
        w = tlw[t] if tlw is not None else torch.ones(o.shape[0], device=dev)
        return fitter(ts_s, o[None], r[None], w[None], epochs=args.epochs,
                      generator=generator, task_oh=oh[None])

    def min_per_task(r):
        return min(v for k, v in r.items() if k.startswith("success_frac_t"))

    ts_s, loss = fit(ts_s)
    r = evaluate(ts_s)
    print(f"round 0: bc_loss={loss:.6f} per-task "
          f"{[round(r[f'success_frac_t{i}'], 3) for i in range(len(specs))]}",
          flush=True)
    history = [{"round": 0, "bc_loss": loss, **r}]
    best, best_r = min_per_task(r), r
    student.save(args.out + ".best.npz", ts_s)

    dagger_tids = (
        [i for i, (n, _, _) in enumerate(specs)
         if n in {s.strip() for s in args.dagger_tasks.split(",")}]
        if args.dagger_tasks else list(range(len(specs))))
    for rnd in range(1, args.dagger_rounds + 1):
        stats_s = ts_s.obs_stats if student.config.obs_norm else None
        for tid in dagger_tids:
            collect(tid, (ts_s.params, stats_s), generator, max(T // 2, 1))
        ts_s, loss = fit(ts_s)
        r = evaluate(ts_s)
        print(f"round {rnd}: bc_loss={loss:.6f} per-task "
              f"{[round(r[f'success_frac_t{i}'], 3) for i in range(len(specs))]}",
              flush=True)
        history.append({"round": rnd, "bc_loss": loss, **r})
        if min_per_task(r) > best:
            best, best_r = min_per_task(r), r
            student.save(args.out + ".best.npz", ts_s)
            print(f"  saved best (min per-task {best:.3f})", flush=True)

    student.save(args.out, ts_s)
    print(json.dumps(best_r, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"config": vars(args), "history": history,
                       "best_eval": best_r}, f, indent=1)
    print(f"saved {args.out}; best (min per-task {best:.3f}) -> "
          f"{args.out}.best.npz")
    return history


if __name__ == "__main__":
    main()
