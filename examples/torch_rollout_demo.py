#!/usr/bin/env python
"""Minimal end-to-end demo on the PyTorch port: trim, batched rollout,
metrics. The port's counterpart of examples/rollout_demo.py.

    python examples/torch_rollout_demo.py [--num-envs 1024] [--steps 500] [--fused]
        [--heli aw109] [--cpu]

`--fused` runs the whole rollout in one launch of the fused step kernel
(`build_fused_rollout`; on the CPU its plain version); without it, one
eager PyTorch step per env step (`VectorHeliEnv.step`). `--heli` names any
airframe of the registry, including one added with
`heligym_tpu_torch.models.register_model_path`. Runs on the CUDA card unless
`--cpu` is given.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv  # noqa: E402
from heligym_tpu_torch.ops.cuda.fused_step import build_fused_rollout  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--heli", default="aw109")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the fused step's plain version)")
    return ap


def run(num_envs: int = 1024, steps: int = 500, fused: bool = False,
        heli: str = "aw109", device=None, generator=None) -> dict:
    """Hover at the trim action from the trim: the rollout's numbers, its
    final state and its per-step rewards and done flags."""
    env = HeliEnv.build(heli, task=HoverTask(), device=device)
    venv = VectorHeliEnv(env, num_envs)
    state, _ = venv.reset()
    actions = env.trim_result().action.to(env.device).expand(num_envs, 4).contiguous()
    gen = generator or torch.Generator(device=env.device).manual_seed(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        if fused:
            rollout = build_fused_rollout(env, num_envs, steps, collect=("reward", "done"))
            state, outs = rollout(state, actions, generator=gen)
            rewards, dones = outs["reward"], outs["done"]
        else:
            rewards, dones = [], []
            for _ in range(steps):
                state, out = venv.step(state, actions, gen)
                rewards.append(out.reward)
                dones.append(out.done)
            rewards, dones = torch.stack(rewards), torch.stack(dones)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    seconds = time.perf_counter() - t0
    total = num_envs * steps
    return {"env_steps": total, "seconds": seconds, "steps_per_s": total / seconds,
            "mean_reward": float(rewards.mean()), "terminations": int(dones.sum()),
            "alt_min": float(state.obs[:, 15].min()), "alt_max": float(state.obs[:, 15].max()),
            "device": str(env.device), "state": state, "rewards": rewards, "dones": dones}


def main(argv=None):
    args = build_parser().parse_args(argv)
    print("solving trim...")
    res = run(args.num_envs, args.steps, args.fused, args.heli,
              "cpu" if args.cpu else None)
    print(f"{res['env_steps']} env-steps in {res['seconds']:.2f}s -> "
          f"{res['steps_per_s']:,.0f} steps/s on {res['device']} (includes "
          f"first-call set-up; see tools/torch_bench.py for steady-state)")
    print(f"mean reward {res['mean_reward']:+.4f}   "
          f"episode terminations: {res['terminations']}")
    print(f"final altitude spread: {res['alt_min']:.0f}..{res['alt_max']:.0f} ft")
    return res


if __name__ == "__main__":
    main()
