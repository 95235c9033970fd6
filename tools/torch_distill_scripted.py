#!/usr/bin/env python
"""Distill the scripted landing controller into the actor network.

    python tools/torch_distill_scripted.py --init examples/landing100_policy.npz \
        --band 6:100 --episodes 1024 --bc-rounds 2 --dagger-rounds 6 \
        --out landing100_scripted.npz

The port of the JAX package's `tools/distill_scripted.py`: expert-label
distillation with the scripted controller (`learner/scripted.py`) as the
labeller.
  * BC rounds: roll the EXPERT with small exploration noise around its
    command, label every pre-termination step of successful episodes with
    its deterministic residual, regress the student mean onto the labels
    (the actor-only fitter of `learner/distill.py`).
  * DAgger rounds: roll the STUDENT mean (noised), label every
    pre-termination step it visits with the expert (valid anywhere).
  * Selection: the student's deterministic evaluation on the --band grid
    after each round; '<out>.best.npz' keeps the best round.
Non-finite rows (a blown-up env after its end) get weight 0 and are zeroed,
since 0 * NaN would still poison the loss. `--replay N` fits on the last N
rounds' datasets. The student's obs stats stay frozen and log_std untouched.

Each collection steps the farm through `fused_step(auto_reset=False)`: the
CUDA kernel on the card, its plain version with `--cpu`. Noise comes from a
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
    ap.add_argument("--init", required=True,
                    help="student init checkpoint (arch + obs stats; e.g. "
                         "the committed landing100 artifact)")
    ap.add_argument("--train-num-envs", type=int, default=512,
                    help="the init checkpoint's training num_envs: sizes the "
                         "learner's config; the reader needs no template")
    ap.add_argument("--band", type=str, default="6:100", metavar="LO:HI")
    ap.add_argument("--episodes", type=int, default=1024,
                    help="episodes collected per round")
    ap.add_argument("--bc-rounds", type=int, default=2,
                    help="expert-rollout behavior-cloning rounds")
    ap.add_argument("--dagger-rounds", type=int, default=6,
                    help="student-rollout expert-labeled rounds")
    ap.add_argument("--collect-log-std", type=float, default=-3.0,
                    help="exploration noise around the acting policy "
                         "during collection (both phases)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--replay", type=int, default=1,
                    help="fit on the last N rounds' datasets concatenated "
                         "(true-DAgger aggregation; 1 = current round only)")
    ap.add_argument("--bc-lr", type=float, default=3e-4)
    ap.add_argument("--minibatch", type=int, default=65536)
    ap.add_argument("--eval-episodes", type=int, default=256)
    ap.add_argument("--turb-level", type=int, default=None,
                    help="collection turbulence override (train-hard)")
    ap.add_argument("--eval-turb-level", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    ap.add_argument("--out", required=True)
    ap.add_argument("--metrics-out", default=None)
    return ap


def labelled_dataset(obs, label, alive, succ, act_with_student: bool):
    """The fitter's (obs, label, w) of one collection: the expert's labels
    are valid anywhere, so a DAgger round (the student acting) weights
    every step up to each env's end; a BC round (the expert acting) only
    those of its successful episodes, so that its crashes are not cloned.
    Non-finite rows are weighted 0 and zeroed (`mask_non_finite`)."""
    from heligym_tpu_torch.learner.distill import mask_non_finite
    w = alive if act_with_student else alive & succ[None, :]
    return mask_non_finite(obs, label, w)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from heligym_tpu_torch.envs import HeliEnv, VectorHeliEnv
    from heligym_tpu_torch.learner.distill import make_bc_fitter, with_turbulence
    from heligym_tpu_torch.learner.evaluate import make_evaluator, rollout
    from heligym_tpu_torch.learner.ppo import PPOConfig, PPOLearner, _fp32_matmuls
    from heligym_tpu_torch.learner.scripted import ApproachGains, make_scripted_policy
    from heligym_tpu_torch.learner.train import (TASKS, _band, _parse_target,
                                                 make_alt_band_sampler,
                                                 make_alt_grid_sampler)

    env = HeliEnv.build("aw109", task=TASKS["landing"](),
                        device="cpu" if args.cpu else None)
    env = env.replace(task=env.task.with_target(
        **_parse_target("touch_alt=ground", env)))
    collect_env = with_turbulence(env, args.turb_level)
    eval_env = with_turbulence(env, args.eval_turb_level)
    dev = env.device

    learner = PPOLearner(env, PPOConfig(num_envs=args.train_num_envs))
    ts = learner.restore(args.init, with_farm=True)

    band = make_alt_band_sampler(*_band(args.band))
    grid = make_alt_grid_sampler(*_band(args.band))
    steps = env.time_up_steps + 3
    act_bias, _, law = make_scripted_policy(env, ApproachGains())
    assert torch.allclose(act_bias, learner.act_bias), \
        "student act_bias differs from the scripted expert's trim"

    venv = VectorHeliEnv(collect_env, args.episodes, auto_reset=False)
    noise_std = float(np.exp(np.float32(args.collect_log_std)))

    def make_labeled_collector(act_with_student: bool):
        """collect(ts, generator) -> (obs, expert_resid, w, acting success).

        Acts with the expert (BC) or the student mean (DAgger), plus
        exploration noise; labels every visited state with the expert's
        deterministic residual."""
        @torch.no_grad()
        def run(params, stats, es, generator):
            def act(t, obs):
                label = law(obs)
                base = (params(learner._net_in(obs, stats))[0]
                        if act_with_student else label)
                noise = noise_std * torch.randn(base.shape, generator=generator,
                                                device=dev)
                return torch.clamp(learner.act_bias + base + noise, -1.0, 1.0), label
            r = rollout(collect_env, es, act, steps, generator, keep_obs=True)
            obs, label, w = labelled_dataset(r["obs"], r["extra"], r["alive"],
                                             r["succ"], act_with_student)
            return obs, label, w, r["succ"]

        def collect(ts, generator):
            es0, _ = venv.reset_randomized(generator, band)
            stats = ts.obs_stats if learner.config.obs_norm else None
            with _fp32_matmuls():
                obs, label, w, succ = run(ts.params, stats, es0, generator)
            return obs, label, w, float(succ.to(torch.float32).mean())

        return collect

    collect_bc = make_labeled_collector(act_with_student=False)
    collect_dagger = make_labeled_collector(act_with_student=True)
    fitter = make_bc_fitter(learner, lr=args.bc_lr, minibatch=args.minibatch)
    evaluator = make_evaluator(eval_env, learner, episodes=args.eval_episodes,
                               steps=steps, cond_sampler=grid)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    def evaluate(ts):
        return evaluator(ts, torch.Generator(device=dev).manual_seed(1234))

    r0 = evaluate(ts)
    print(f"round 0 (init): det success={r0['success_frac']:.3f} "
          f"fail={r0['fail_frac']:.3f}", flush=True)
    best, best_ts = r0["success_frac"], ts
    learner.save(args.out + ".best.npz", best_ts)
    history = [{"round": 0, **r0}]

    total = args.bc_rounds + args.dagger_rounds
    replay = []   # (obs, label, w) of the last --replay rounds
    for rnd in range(1, total + 1):
        phase = "bc" if rnd <= args.bc_rounds else "dagger"
        collect = collect_bc if phase == "bc" else collect_dagger
        obs, label, w, act_succ = collect(ts, generator)
        kept = float(torch.sum(w))
        print(f"round {rnd} [{phase}]: acting success={act_succ:.3f}, "
              f"{kept:.0f} labeled steps", flush=True)
        if kept < 1.0:
            print("no labeled steps - stopping", flush=True)
            break
        replay = (replay + [(obs, label, w)])[-max(1, args.replay):]
        if len(replay) > 1:   # concat along the episode axis (same T)
            obs, label, w = (torch.cat(parts, dim=1) for parts in zip(*replay))
        ts, loss = fitter(ts, obs, label, w, epochs=args.epochs, generator=generator)
        ev = evaluate(ts)
        print(f"round {rnd} [{phase}]: bc_loss={loss:.5f} det "
              f"success={ev['success_frac']:.3f} "
              f"fail={ev['fail_frac']:.3f}", flush=True)
        history.append({"round": rnd, "phase": phase,
                        "acting_success": act_succ, "bc_loss": loss, **ev})
        if ev["success_frac"] > best:
            best, best_ts = ev["success_frac"], ts
            learner.save(args.out + ".best.npz", best_ts)
            print(f"  new best ({best:.3f}) -> {args.out}.best.npz", flush=True)

    learner.save(args.out, ts)
    print(f"saved {args.out}; best det success={best:.3f}", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"history": history, "best": best,
                       "args": vars(args)}, f, indent=1, default=float)
    return history


if __name__ == "__main__":
    main()
