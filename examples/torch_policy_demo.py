#!/usr/bin/env python
"""Roll out a trained PPO policy on the PyTorch port and render it with the
native rasterizer. The port's counterpart of examples/policy_demo.py.

    python examples/torch_policy_demo.py --checkpoint examples/hover_policy.npz \\
        --out hover_policy.gif --task hover --target sea_alt=start

--task/--target must match the checkpoint's training invocation so the
reported reward/success reflect the objective the policy was trained on (the
policy network itself is target-agnostic: targets live in the reward). The
checkpoint is the JAX package's flat-npz format, which both packages read
and write. The env steps on the CUDA card unless `--cpu` is given; the
Dryden noise and the policy's samples come from generators seeded with
`--seed` (the port's streams, not JAX's). `imageio` is imported only to
write the GIF.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from heligym_tpu_torch.envs import HeliEnv  # noqa: E402
from heligym_tpu_torch.learner import PPOConfig, PPOLearner  # noqa: E402
from heligym_tpu_torch.learner.train import TASKS, _parse_target  # noqa: E402
from heligym_tpu_torch.render import get_renderer  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="examples/hover_policy.npz")
    ap.add_argument("--out", default="examples/hover_policy.gif")
    ap.add_argument("--task", choices=sorted(TASKS), default="hover")
    ap.add_argument("--target", default=None,
                    help="task target override 'k=v,...' (match training)")
    ap.add_argument("--num-envs", type=int, default=2048,
                    help="must match the checkpoint's training config")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--every", type=int, default=8)
    ap.add_argument("--camera", choices=("chase", "orbit"), default="chase")
    ap.add_argument("--no-center-actions", action="store_true",
                    help="checkpoint was trained with absolute (uncentered) "
                         "actions — must match training")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--start-alt", type=float, default=None,
                    help="initial trim altitude above ground [ft] "
                         "(match training --start-alt)")
    ap.add_argument("--seed", type=int, default=42,
                    help="episode RNG seed (wind turbulence stream)")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample actions from the policy distribution "
                         "instead of taking the mean")
    return ap


def run_policy(args) -> dict:
    """One episode of the checkpoint's policy (or `args.steps` steps): its
    frames, rewards, end and touchdown numbers."""
    env = HeliEnv.build("aw109", task=TASKS[args.task](),
                        device="cpu" if args.cpu else None)
    if args.target:
        env = env.replace(task=env.task.with_target(**_parse_target(args.target, env)))
    learner = PPOLearner(env, PPOConfig(num_envs=args.num_envs,
                                        center_actions=not args.no_center_actions))
    ts = learner.restore(args.checkpoint, farm_size=args.num_envs)
    es, _ = env.reset({"gr_alt": args.start_alt} if args.start_alt is not None else None)
    stats = ts.obs_stats if learner.config.obs_norm else None
    wind_gen = torch.Generator(device=env.device).manual_seed(args.seed)
    act_gen = torch.Generator(device=env.device).manual_seed(args.seed + 10_000)

    renderer = get_renderer(env, camera_mode=args.camera,
                            orbit_frames=args.steps // args.every)
    frames, rewards, lines = [], [], []
    succ = failed = False
    # Gear legs hang LG.LOC z below the CG, so the skids reach the ground
    # when obs[16] (CG altitude above ground) <= leg reach.
    gear_h = max(leg[2] for leg in env.params.LG.LOC)
    contact_steps, min_agl, first_contact, end = 0, float("inf"), -1, None
    with torch.no_grad():
        for t in range(args.steps):
            act = learner.policy(ts.params, es.obs[None], act_gen, obs_stats=stats,
                                 stochastic=args.stochastic)[0]
            es, out = env.step(es, act, wind_gen)
            rewards.append(float(out.reward))
            agl = float(es.obs[16]) - gear_h
            min_agl = min(min_agl, agl)
            if agl <= 0.0:
                contact_steps += 1
                if first_contact < 0:
                    first_contact = t
            if t % args.every == 0:
                frames.append(np.asarray(renderer.render(es)))
            succ = succ or bool(out.successed)
            if bool(out.done) or bool(out.truncated):
                failed = bool(out.failed)
                end = t
                lines.append(f"episode ended at step {t} "
                             f"(successed={bool(out.successed)}, failed={failed}, "
                             f"time_up={bool(out.time_up)})")
                break
    renderer.close()
    return {"frames": frames, "rewards": rewards, "successed": succ, "failed": failed,
            "end_step": end, "success_s": float(es.successed_steps) * env.dt,
            "success_needed_s": env.success_duration, "final_alt": float(es.obs[15]),
            "first_contact": first_contact, "contact_steps": contact_steps,
            "min_skid_height": min_agl, "dt": env.dt, "lines": lines}


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = run_policy(args)
    for line in res["lines"]:
        print(line)
    import imageio.v2 as imageio
    imageio.mimsave(args.out, res["frames"], duration=0.12, loop=0)
    print(f"wrote {args.out}: {len(res['frames'])} frames; "
          f"mean reward {np.mean(res['rewards']):+.3f}; successed={res['successed']} "
          f"failed={res['failed']} "
          f"(accumulated success time {res['success_s']:.1f}s / "
          f"{res['success_needed_s']:.1f}s needed); "
          f"final alt {res['final_alt']:.0f} ft")
    if res["first_contact"] >= 0:
        print(f"touchdown: gear on ground from step {res['first_contact']} "
              f"({res['first_contact'] * res['dt']:.1f}s), {res['contact_steps']} "
              f"gear-contact steps, min skid height {res['min_skid_height']:+.2f} ft")
    else:
        print(f"no gear contact (min skid height {res['min_skid_height']:+.2f} ft)")
    return res


if __name__ == "__main__":
    main()
