#!/usr/bin/env python3
"""Re-span normalized obs channels WITH exact input-layer compensation, on
the PyTorch port. The port's counterpart of tools/respan_stats.py, with its
flags (and --cpu); it reads and writes the flat-npz checkpoints both
packages read.

    python tools/torch_respan_stats.py --checkpoint fwd.npz --task oblique \\
        --target sea_alt=start,vel=60 --train-num-envs 512 \\
        --respan 9:0:1.0:3 --respan 5:0:1.8:3 --out respanned.npz

Each --respan entry is `index:anchor:top:top_z` in SCALED units (after the
fixed physical normalizers, `networks.obs_scales`): the channel's affine map
is rewritten to pass through (anchor, z_old(anchor)) and (top, top_z). The
input layers (the actor torso's first, flax Dense_0, and the critic
torso's, Dense_{L+1}) are EXACTLY compensated for the affine change, so
the checkpoint computes the same function wherever the +-10 normalization
clip was inactive: no transplant shock, and the policy gains sight of
regions the old statistics clipped. The tool checks that identity on
in-distribution observations (atol 2e-5), as the JAX tool does, before it
saves. Runs on the CUDA card unless --cpu is given.
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
    ap.add_argument("--task", required=True)
    ap.add_argument("--target", default=None)
    ap.add_argument("--train-num-envs", type=int, required=True)
    ap.add_argument("--respan", action="append", required=True,
                    metavar="IDX:ANCHOR:TOP:TOPZ",
                    help="channel re-span in scaled units (repeatable)")
    ap.add_argument("--out", required=True)
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

    m = ts.obs_stats.mean.cpu().numpy().copy()
    v = ts.obs_stats.var.cpu().numpy().copy()
    s_old = np.sqrt(v + 1e-8)
    m_old, v_old = m.copy(), v.copy()

    for spec in args.respan:
        i_s, anchor_s, top_s, topz_s = spec.split(":")
        i, anchor, top, top_z = (int(i_s), float(anchor_s), float(top_s),
                                 float(topz_s))
        z_anchor_old = (anchor - m_old[i]) / s_old[i]
        s_new = (top - anchor) / (top_z - z_anchor_old)
        if not s_new > 0:
            raise SystemExit(
                f"channel {i}: anchors imply a non-positive scale (s_new="
                f"{s_new:.4g}): need top_z ({top_z:g}) > z(anchor) "
                f"({z_anchor_old:.3f}) when top > anchor — v = s**2 would "
                f"silently drop the sign (the input-layer compensation "
                f"stays self-consistent, so the mistake would be invisible)")
        m[i] = anchor - z_anchor_old * s_new
        v[i] = s_new ** 2
        print(f"channel {i}: z({anchor:g}) = {z_anchor_old:+.3f} "
              f"(preserved), z({top:g}) = {top_z:+.3f} "
              f"(was {(top - m_old[i]) / s_old[i]:+.1f})")

    # exact compensation: z_old = a * z_new + d per channel
    s_new_all = np.sqrt(v + 1e-8)
    a = (s_new_all / s_old).astype(np.float32)
    d = ((m - m_old) / s_old).astype(np.float32)
    n_obs = a.shape[0]
    old = PPOLearner(env, PPOConfig(num_envs=args.train_num_envs))
    ts_old = old.restore(args.checkpoint, farm_size=args.train_num_envs)
    with torch.no_grad():
        for lin in (ts.params.actor[0], ts.params.critic[0]):
            k_src = np.ascontiguousarray(lin.weight.cpu().numpy().T)  # flax (in, out)
            k_new = k_src.copy()
            k_new[:n_obs] = k_src[:n_obs] * a[:, None]   # one-hot rows untouched
            b_new = lin.bias.cpu().numpy() + k_src[:n_obs].T @ d
            lin.weight.copy_(torch.from_numpy(k_new.T.copy()))
            lin.bias.copy_(torch.from_numpy(b_new))
    dev = ts.obs_stats.mean.device
    ts = ts.replace(obs_stats=ObsStats(mean=torch.from_numpy(m).to(dev),
                                       var=torch.from_numpy(v).to(dev),
                                       count=ts.obs_stats.count))

    # identity probe on in-distribution states (trim reset + old-stats noise)
    _, obs0 = env.reset()
    rng = np.random.default_rng(0)
    sig = s_old * learner._scales.cpu().numpy()
    obs_probe = (obs0.cpu().numpy()[None, :]
                 + rng.normal(size=(8, m.shape[0])).astype(np.float32) * sig
                 ).astype(np.float32)
    obs_probe = torch.from_numpy(obs_probe).to(env.device)
    toh = (learner._task_oh(torch.zeros(8, dtype=torch.int32, device=env.device))
           if learner.task_dim else None)
    with torch.no_grad():
        a_old = old.policy(ts_old.params, obs_probe, obs_stats=ts_old.obs_stats,
                           task_oh=toh)
        a_new = learner.policy(ts.params, obs_probe, obs_stats=ts.obs_stats, task_oh=toh)
    np.testing.assert_allclose(a_old.cpu().numpy(), a_new.cpu().numpy(), atol=2e-5)
    learner.save(args.out, ts)
    print(f"saved {args.out}; in-distribution behavior identity verified "
          f"(atol 2e-5)")
    return ts


if __name__ == "__main__":
    main()
