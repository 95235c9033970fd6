#!/usr/bin/env python
"""Blend two altitude-phase experts into ONE landing policy by distillation.

    python tools/torch_distill_hybrid.py \
        --lander examples/landing_band_policy.npz:4096 \
        --descender descend30.npz:4096 \
        --band 6:100 --switch-agl 34 --blend-width 6 \
        --rounds 8 --out hybrid.npz

The port of the JAX package's `tools/distill_hybrid.py`. A low-altitude
lander and a descend-to-hover expert (a LandingTask with touch_alt raised by
30 ft) cover separable phases; this tool composes them:
  * roll the STUDENT (noised) on the full landing task over the band;
  * label every visited state with an altitude-gated blend of the two
    experts' deterministic means, w(agl) * descender + (1 - w) * lander,
    w = sigmoid((agl - switch) / width), each expert under its OWN obs stats;
  * clone the blend into the student's actor (`learner/distill.py`'s
    fitter), round after round, best-tracking a deterministic evaluation on
    the band grid.
Each env's first end is latched: the farm runs without auto-reset, so
post-crash and post-success states are not labelled. The student starts as
the lander.

It runs on the CUDA card (each step one launch of `csrc/fused_step.cu`,
`fused_step(auto_reset=False)`) unless `--cpu` asks for the CPU. Noise comes
from a `torch.Generator` seeded with --seed (the evaluation's with 1234).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lander", required=True, metavar="CKPT:NENV",
                    help="low-altitude landing expert (student init)")
    ap.add_argument("--descender", required=True, metavar="CKPT:NENV",
                    help="descend-to-hover expert (labels above the switch)")
    ap.add_argument("--target", default="touch_alt=ground",
                    help="the FULL task's target (evaluation objective)")
    ap.add_argument("--band", default="6:100", metavar="LO:HI")
    ap.add_argument("--switch-agl", type=float, default=34.0,
                    help="blend midpoint [ft AGL]")
    ap.add_argument("--blend-width", type=float, default=6.0,
                    help="sigmoid width [ft] of the expert handover")
    ap.add_argument("--episodes", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--bc-lr", type=float, default=3e-4)
    ap.add_argument("--minibatch", type=int, default=65536)
    ap.add_argument("--collect-log-std", type=float, default=-3.0)
    ap.add_argument("--eval-episodes", type=int, default=256)
    ap.add_argument("--out", required=True)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    return ap


def blend_label(obs, lander, params_l, stats_l, desc, params_d, stats_d,
                switch_agl: float, blend_width: float):
    """The label of each observation row: the altitude-gated blend
    w * descender + (1 - w) * lander of the two experts' deterministic
    means, w = sigmoid((agl - switch_agl) / blend_width), each expert under
    its OWN obs stats (`lander` / `desc` are their learners)."""
    import torch
    m_l = params_l(lander._norm(obs, stats_l))[0]
    m_d = params_d(desc._norm(obs, stats_d))[0]
    w = torch.sigmoid((obs[..., 16] - switch_agl) / blend_width)[..., None]
    return w * m_d + (1.0 - w) * m_l


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from heligym_tpu_torch.envs import HeliEnv, VectorHeliEnv
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.distill import make_bc_fitter, mask_non_finite
    from heligym_tpu_torch.learner.evaluate import make_evaluator, rollout
    from heligym_tpu_torch.learner.ppo import _fp32_matmuls
    from heligym_tpu_torch.learner.train import (TASKS, _band, _parse_target,
                                                 make_alt_band_sampler,
                                                 make_alt_grid_sampler)

    env = HeliEnv.build("aw109", task=TASKS["landing"](),
                        device="cpu" if args.cpu else None)
    env = env.replace(task=env.task.with_target(
        **_parse_target(args.target, env)))
    dev = env.device

    def load(spec):
        ck, nenv = spec.rsplit(":", 1)
        learner = PPOLearner(env, PPOConfig(num_envs=int(nenv)))
        return learner, learner.restore(ck, with_farm=True)

    lander, ts_land = load(args.lander)
    desc, ts_desc = load(args.descender)
    # student = the lander (same learner object, its parameters to start)
    ts_s = ts_land

    band = make_alt_band_sampler(*_band(args.band))
    grid = make_alt_grid_sampler(*_band(args.band))
    B = args.episodes
    steps = env.time_up_steps + 3
    venv = VectorHeliEnv(env, B, auto_reset=False)
    noise_std = float(np.exp(np.float32(args.collect_log_std)))

    @torch.no_grad()
    def collect(params_s, stats_s, params_d, stats_d, params_l, stats_l, es, generator):
        def act(t, obs):
            mean_s = params_s(lander._norm(obs, stats_s))[0]
            noise = torch.randn(mean_s.shape, generator=generator, device=dev)
            executed = torch.clamp(lander.act_bias + mean_s + noise_std * noise,
                                   -1.0, 1.0)
            return executed, blend_label(obs, lander, params_l, stats_l, desc,
                                         params_d, stats_d, args.switch_agl,
                                         args.blend_width)
        # each env's first end is latched: without auto-reset the env keeps
        # integrating past it, and post-crash / post-success states must not
        # enter the dataset
        r = rollout(env, es, act, steps, generator, keep_obs=True)
        return r["obs"], r["extra"], r["alive"]

    fitter = make_bc_fitter(lander, lr=args.bc_lr, minibatch=args.minibatch)
    evaluator = make_evaluator(env, lander, episodes=args.eval_episodes,
                               steps=steps, cond_sampler=grid)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    def evaluate(ts):
        return evaluator(ts, torch.Generator(device=dev).manual_seed(1234))

    r0 = evaluate(ts_s)
    print(f"round 0 (lander): det band success={r0['success_frac']:.3f} "
          f"fail={r0['fail_frac']:.3f}", flush=True)
    best, history = r0["success_frac"], [{"round": 0, **r0}]
    lander.save(args.out + ".best.npz", ts_s)

    stats_l = ts_land.obs_stats
    stats_d = ts_desc.obs_stats
    for rnd in range(1, args.rounds + 1):
        es0, _ = venv.reset_randomized(generator, band)
        with _fp32_matmuls():
            o, lbl, alive = collect(ts_s.params, ts_s.obs_stats, ts_desc.params,
                                    stats_d, ts_land.params, stats_l, es0, generator)
        o, lbl, w_fit = mask_non_finite(o, lbl, alive)
        print(f"  kept {int(w_fit.sum())}/{w_fit.numel()} finite samples", flush=True)
        ts_s, loss = fitter(ts_s, o, lbl, w_fit, epochs=args.epochs, generator=generator)
        r = evaluate(ts_s)
        print(f"round {rnd}: bc_loss={loss:.5f} det band "
              f"success={r['success_frac']:.3f} fail={r['fail_frac']:.3f}",
              flush=True)
        history.append({"round": rnd, "bc_loss": loss, **r})
        if r["success_frac"] > best:
            best = r["success_frac"]
            lander.save(args.out + ".best.npz", ts_s)
            print(f"  saved best ({best:.3f})", flush=True)

    lander.save(args.out, ts_s)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"config": vars(args), "history": history}, f, indent=1)
    print(f"final best det band success={best:.3f} -> {args.out}.best.npz")
    return history


if __name__ == "__main__":
    main()
