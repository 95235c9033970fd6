#!/usr/bin/env python3
"""Widen a single-task checkpoint into a task-conditioned MixedTask one, on
the PyTorch port. The port's counterpart of tools/widen_checkpoint.py, with
its flags (and --cpu); it reads and writes the flat-npz checkpoints both
packages read.

    python tools/torch_widen_checkpoint.py --checkpoint hover.npz \\
        --task hover --train-num-envs 512 \\
        --tasks hover,forward --target sea_alt=start,vel=60 \\
        --out-num-envs 1024 --out mt_seed.npz

MixedTask learners append a K-wide task one-hot to the network input
(`PPOLearner._net_in`), so their input layers take obs_dim + K columns and
a single-task checkpoint cannot be restored into them directly. This
transplant:

  * copies every parameter, padding the two INPUT layers (the actor torso's
    first layer, flax Dense_0, and the critic torso's, Dense_{L+1}) with
    ZERO weights for the one-hot columns: the widened policy acts exactly
    as the source policy for EVERY task id, and training grows per-task
    behaviour out of the zero weights;
  * copies the observation statistics (they cover only the obs channels),
    or with --mix-stats-from mixes a second checkpoint's in (50/50 mixture
    mean and variance) and compensates the input layers exactly for the
    affine change, so that the policy is unchanged wherever the +-10
    normalization clip is inactive;
  * starts a fresh optimizer state and env farm (a new training regime).

It then checks the behaviour identity for every task id on in-distribution
observations (atol 1e-6), as the JAX tool does, and saves. Runs on the CUDA
card unless --cpu is given.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from heligym_tpu_torch.envs import HeliEnv, MixedTask  # noqa: E402
from heligym_tpu_torch.learner import PPOConfig, PPOLearner  # noqa: E402
from heligym_tpu_torch.learner.optim import adam_init  # noqa: E402
from heligym_tpu_torch.learner.ppo import ObsStats  # noqa: E402
from heligym_tpu_torch.learner.train import TASKS, _parse_target  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="single-task source checkpoint")
    ap.add_argument("--task", required=True,
                    help="the source checkpoint's task")
    ap.add_argument("--train-num-envs", type=int, required=True,
                    help="the source checkpoint's num_envs")
    ap.add_argument("--tasks", required=True,
                    help="comma list of target MixedTask sub-tasks")
    ap.add_argument("--target", default=None,
                    help="task target override 'k=v,...' (as in train.py)")
    ap.add_argument("--out-num-envs", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mix-stats-from", default=None,
                    help="second single-task checkpoint whose obs stats are "
                         "MIXED into the output stats (50/50 mixture "
                         "mean/var); the input layers are EXACTLY compensated "
                         "for the affine change, so the widened policy still "
                         "reproduces the source policy wherever the +-10 "
                         "normalization clip is inactive. Use with "
                         "--freeze-obs-stats in the following training stage.")
    ap.add_argument("--mix-stats-task", default=None,
                    help="the --mix-stats-from checkpoint's task")
    ap.add_argument("--mix-stats-num-envs", type=int, default=None,
                    help="the --mix-stats-from checkpoint's num_envs")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def input_layers(net):
    """The two input layers: the actor torso's first (flax Dense_0) and the
    critic torso's first (Dense_{L+1})."""
    return (net.actor[0], net.critic[0])


def kernel_of(lin) -> np.ndarray:
    """A layer's flax kernel (in, out), as the JAX package stores it."""
    return np.ascontiguousarray(_host(lin.weight).T)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    src_env = HeliEnv.build("aw109", task=TASKS[args.task](), device=device)
    names = [s.strip() for s in args.tasks.split(",") if s.strip()]
    dst_task = MixedTask(tasks=tuple(TASKS[n]() for n in names))
    dst_env = src_env.replace(task=dst_task)
    if args.target:
        updates = _parse_target(args.target, src_env)
        src_env = src_env.replace(task=src_env.task.with_target(
            **{k: v for k, v in updates.items() if k in src_env.task.target_dict()}))
        dst_env = dst_env.replace(task=MixedTask(tasks=tuple(
            t.with_target(**{k: v for k, v in updates.items() if k in t.target_dict()})
            for t in dst_task.tasks)))

    src = PPOLearner(src_env, PPOConfig(num_envs=args.train_num_envs))
    ts_src = src.restore(args.checkpoint, farm_size=args.train_num_envs)
    dst = PPOLearner(dst_env, PPOConfig(num_envs=args.out_num_envs))
    task_ids = np.arange(args.out_num_envs) % len(names)
    ts_dst = dst.init(torch.Generator().manual_seed(1), task_ids=task_ids)
    K = dst.task_dim

    # per-channel affine compensation (identity unless --mix-stats-from):
    # z_old = a * z_new + d  with  a = s_new/s_old, d = (m_new - m_old)/s_old
    m1, v1 = _host(ts_src.obs_stats.mean), _host(ts_src.obs_stats.var)
    n_obs = m1.shape[0]
    a = np.ones(n_obs, np.float32)
    d = np.zeros(n_obs, np.float32)
    out_stats = ts_src.obs_stats
    if args.mix_stats_from:
        if not (args.mix_stats_task and args.mix_stats_num_envs):
            ap.error("--mix-stats-from needs --mix-stats-task and "
                     "--mix-stats-num-envs")
        env2 = HeliEnv.build("aw109", task=TASKS[args.mix_stats_task](), device=device)
        l2 = PPOLearner(env2, PPOConfig(num_envs=args.mix_stats_num_envs))
        st2 = l2.restore(args.mix_stats_from, farm_size=args.mix_stats_num_envs).obs_stats
        m2, v2 = _host(st2.mean), _host(st2.var)
        # 50/50 mixture moments: spans both tasks' state distributions
        mm = 0.5 * (m1 + m2)
        vm = 0.5 * (v1 + v2) + 0.25 * (m1 - m2) ** 2
        s1, sm = np.sqrt(v1 + 1e-8), np.sqrt(vm + 1e-8)
        a = (sm / s1).astype(np.float32)
        d = ((mm - m1) / s1).astype(np.float32)
        dev = ts_src.obs_stats.mean.device
        out_stats = ObsStats(mean=torch.from_numpy(mm).to(dev),
                             var=torch.from_numpy(vm).to(dev),
                             count=ts_src.obs_stats.count)

    # every parameter copied; the input layers' kernels get zero rows for
    # the one-hot, the stats change folded in: row c scales by a_c, the
    # shift lands in the bias (w.z_old + b == (w*a).z_new + (b + w.d))
    net = dst.make_network()
    widen = {id(lin) for lin in input_layers(ts_src.params)}
    with torch.no_grad():
        for lin_src, lin_dst in zip(ts_src.params.dense_layers(), net.dense_layers()):
            if id(lin_src) in widen:
                k_src = kernel_of(lin_src)
                k_new = np.zeros((k_src.shape[0] + K, k_src.shape[1]), k_src.dtype)
                k_new[:k_src.shape[0]] = k_src * a[:, None]
                b_new = _host(lin_src.bias) + k_src.T @ d
                lin_dst.weight.copy_(torch.from_numpy(k_new.T.copy()))
                lin_dst.bias.copy_(torch.from_numpy(b_new))
            else:
                lin_dst.weight.copy_(lin_src.weight)
                lin_dst.bias.copy_(lin_src.bias)
        net.log_std.copy_(ts_src.params.log_std)
    ts_dst = ts_dst.replace(params=net, opt_state=adam_init(dst.param_list(net)),
                            obs_stats=out_stats)

    # sanity: the widened policy must reproduce the source policy for every
    # task id, probed with IN-DISTRIBUTION observations (the trim-reset obs
    # plus stats-scaled noise): under --mix-stats-from the identity holds
    # wherever the +-10 normalization clip is inactive
    _, obs0 = src_env.reset()
    rng = np.random.default_rng(0)
    sig = np.sqrt(v1) * _host(src._scales)
    obs = (_host(obs0)[None, :] + rng.normal(size=(4, n_obs)).astype(np.float32) * sig
           ).astype(np.float32)
    obs = torch.from_numpy(obs).to(src_env.device)
    with torch.no_grad():
        a_src = src.policy(ts_src.params, obs, obs_stats=ts_src.obs_stats)
        for tid in range(K):
            toh = dst._task_oh(torch.full((4,), tid, dtype=torch.int32,
                                          device=dst_env.device))
            a_dst = dst.policy(ts_dst.params, obs, obs_stats=ts_dst.obs_stats,
                               task_oh=toh)
            np.testing.assert_allclose(_host(a_src), _host(a_dst), atol=1e-6)
    dst.save(args.out, ts_dst)
    print(f"widened {args.checkpoint} ({args.task}, "
          f"{args.train_num_envs} envs) -> {args.out} "
          f"({'+'.join(names)}, {args.out_num_envs} envs); "
          f"behavior-identity verified for all {K} task ids")
    return ts_dst


if __name__ == "__main__":
    main()
