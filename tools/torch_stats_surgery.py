#!/usr/bin/env python3
"""Observation-stats surgery on the PyTorch port: re-span one normalized
obs channel's affine map. The port's counterpart of tools/stats_surgery.py,
with its flags (and --cpu); it reads and writes the flat-npz checkpoints
both packages read.

    python tools/torch_stats_surgery.py --checkpoint land25.npz --out statfix.npz \\
        --task landing --target touch_alt=ground --train-num-envs 1024 \\
        --anchor-alt 6 --top-alt 120 --top-z 9

Normalized observations are clipped to +-10 (`PPOLearner._norm`). Under
statistics learned at a 25-ft start, obs[16] (CG altitude above ground)
hits the clip at ~32 ft, so the policy is altitude-blind above it. The
surgery rewrites the mean and variance of ONE channel as the affine map
through two anchors: z(anchor_alt) keeps its OLD normalized value (the
settle-region input the trained policy depends on), z(top_alt) maps to
`top_z`. The channel above the anchor re-fits in the next training stage
(run it with --freeze-obs-stats so the new map sticks). Runs on the CUDA
card unless --cpu is given.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from heligym_tpu_torch.envs import HeliEnv  # noqa: E402
from heligym_tpu_torch.learner import PPOConfig, PPOLearner  # noqa: E402
from heligym_tpu_torch.learner.ppo import ObsStats  # noqa: E402
from heligym_tpu_torch.learner.train import TASKS, _parse_target  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", default="landing")
    ap.add_argument("--target", default="touch_alt=ground")
    ap.add_argument("--train-num-envs", type=int, required=True,
                    help="the checkpoint's training num_envs (its farm size)")
    ap.add_argument("--obs-index", type=int, default=16,
                    help="channel to re-span (16 = altitude above ground)")
    ap.add_argument("--anchor-alt", type=float, default=6.0,
                    help="start altitude [ft AGL] whose normalized value is "
                         "PRESERVED (the trained competence anchor)")
    ap.add_argument("--top-alt", type=float, default=120.0,
                    help="start altitude [ft AGL] mapped to --top-z")
    ap.add_argument("--top-z", type=float, default=9.0,
                    help="normalized value at --top-alt (inside the +-10 "
                         "clip with headroom)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = HeliEnv.build("aw109", task=TASKS[args.task](),
                        device="cpu" if args.cpu else None)
    if args.target:
        env = env.replace(task=env.task.with_target(**_parse_target(args.target, env)))
    learner = PPOLearner(env, PPOConfig(num_envs=args.train_num_envs))
    ts = learner.restore(args.checkpoint, farm_size=args.train_num_envs, with_farm=True)

    i = args.obs_index

    def scaled(alt: float) -> float:
        """The scaled obs channel (before standardization) at a fresh trim
        reset `alt` ft above ground."""
        _, obs = env.reset({"gr_alt": alt})
        return float((obs / learner._scales)[i])

    x_lo, x_hi = scaled(args.anchor_alt), scaled(args.top_alt)
    st = ts.obs_stats
    m, v = st.mean.cpu().numpy().copy(), st.var.cpu().numpy().copy()
    z_lo_old = (x_lo - m[i]) / np.sqrt(v[i] + 1e-8)
    # new affine through (x_lo, z_lo_old) and (x_hi, top_z)
    s_new = (x_hi - x_lo) / (args.top_z - z_lo_old)
    if not s_new > 0:
        raise SystemExit(
            f"requested anchors imply a non-positive scale (s_new="
            f"{s_new:.4g}): need top_z ({args.top_z:g}) > z(anchor_alt) "
            f"({z_lo_old:.3f}) when top_alt > anchor_alt — v = s**2 would "
            f"silently drop the sign and the saved stats would not pass "
            f"through the requested anchor points")
    m[i] = x_lo - z_lo_old * s_new
    v[i] = s_new ** 2
    dev = st.mean.device
    ts = ts.replace(obs_stats=ObsStats(mean=torch.from_numpy(m).to(dev),
                                       var=torch.from_numpy(v).to(dev), count=st.count))
    learner.save(args.out, ts)

    print(f"channel {i}: z({args.anchor_alt:g} ft) = {z_lo_old:+.3f} "
          f"(preserved), z({args.top_alt:g} ft) = {args.top_z:+.3f}")
    for alt in (args.anchor_alt, 15, 25, 35, 50, 80, args.top_alt):
        _, obs = env.reset({"gr_alt": float(alt)})
        x = learner._norm(obs, ts.obs_stats).cpu().numpy()
        print(f"  alt {alt:6.1f} ft: normalized obs[{i}] = {x[i]:+7.3f}")
    print(f"saved {args.out} (resume it with --freeze-obs-stats)")
    return {"x_lo": x_lo, "x_hi": x_hi, "z_lo_old": float(z_lo_old), "state": ts}


if __name__ == "__main__":
    main()
