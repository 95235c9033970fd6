#!/usr/bin/env python
"""Roll the scripted landing controller over a start-altitude grid.

    python tools/torch_tune_scripted.py --band 6:100 --envs 256 --seeds 0,1,2
    python tools/torch_tune_scripted.py --turb-level 2 --set vmax=7 k_gv=0.25

The port of the JAX package's `tools/tune_scripted.py`, the gain-tuning
harness behind `learner/scripted.py`'s defaults: it scores a gain set
(overridden with --set NAME=VALUE ...) on a deterministic altitude grid
(`make_alt_grid_sampler`, one env per altitude, batched Newton trim), with a
per-band success/fail breakdown and the end state of the first failures, and
prints the same lines and JSON as the JAX tool.

It runs on the CUDA card, each step one launch of `csrc/fused_step.cu`
(`fused_step(auto_reset=False)`, in `learner/evaluate.py`'s `rollout`)
after the law's elementwise tensor math, unless `--cpu` asks for the CPU
and the step's plain version. (The JAX tool
defaults to the CPU and takes `--tpu`.) Each seed seeds a `torch.Generator`
for the Dryden noise, so the streams differ from the JAX tool's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="6:100", metavar="LO:HI")
    ap.add_argument("--envs", type=int, default=128,
                    help="grid resolution (one env per altitude)")
    ap.add_argument("--seeds", default="0",
                    help="comma list; seeds vary turbulence + reset draws")
    ap.add_argument("--turb-level", type=int, default=None)
    ap.add_argument("--set", nargs="*", default=[], metavar="NAME=VALUE",
                    help="ApproachGains field overrides")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    ap.add_argument("--json-out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from heligym_tpu_torch.envs import HeliEnv, VectorHeliEnv
    from heligym_tpu_torch.learner.distill import with_turbulence
    from heligym_tpu_torch.learner.evaluate import rollout
    from heligym_tpu_torch.learner.scripted import ApproachGains, make_scripted_policy
    from heligym_tpu_torch.learner.train import (TASKS, _band, _parse_target,
                                                 make_alt_grid_sampler)

    over = {}
    for spec in args.set:
        k, v = spec.split("=")
        over[k] = float(v)
    gains = ApproachGains(**over)

    env = HeliEnv.build("aw109", task=TASKS["landing"](),
                        device="cpu" if args.cpu else None)
    env = env.replace(task=env.task.with_target(
        **_parse_target("touch_alt=ground", env)))
    env = with_turbulence(env, args.turb_level)
    dev = env.device
    N = args.envs
    venv = VectorHeliEnv(env, N, auto_reset=False)
    lo, hi = _band(args.band)
    grid = make_alt_grid_sampler(lo, hi)
    act_bias, _, law = make_scripted_policy(env, gains)
    steps = env.time_up_steps + 3

    @torch.no_grad()
    def roll(es, generator):
        act = lambda t, obs: (torch.clamp(act_bias + law(obs), -1.0, 1.0), None)
        r = rollout(env, es, act, steps, generator, keep_obs=True)
        # the observations right after each env's end (the last ones if it
        # never ended)
        after = torch.cat([r["obs"], r["last_obs"][None]])
        at = torch.where(r["end"] >= 0, r["end"] + 1, steps).long()
        r["endobs"] = after[at, torch.arange(N, device=dev)]
        return {k: r[k] for k in ("succ", "fail", "end", "endobs")}

    alts = np.linspace(lo, hi, N)
    out = {"gains": dataclasses.asdict(gains), "band": args.band,
           "turb_level": args.turb_level, "envs": N, "per_seed": []}
    for seed in (int(s) for s in args.seeds.split(",")):
        generator = torch.Generator(device=dev).manual_seed(seed)
        es0, _ = venv.reset_randomized(generator, grid)
        t0 = time.time()
        res = {k: v.cpu().numpy() for k, v in roll(es0, generator).items()}
        succ, fail, end, eo = res["succ"], res["fail"], res["end"], res["endobs"]
        print(f"seed {seed}: succ={succ.mean():.3f} fail={fail.mean():.3f} "
              f"timeout={(~succ & ~fail).mean():.3f}  "
              f"({time.time() - t0:.0f}s)")
        for blo, bhi in ((lo, 55.0), (55.0, hi)):
            m = (alts >= blo) & (alts <= bhi)
            if m.any():
                print(f"  band {blo:.0f}:{bhi:.0f}: "
                      f"succ={succ[m].mean():.3f} fail={fail[m].mean():.3f}")
        for i in np.where(~succ)[0][:8]:
            t_end = end[i] * env.dt if end[i] >= 0 else env.max_time
            print(f"  alt0={alts[i]:5.1f} "
                  f"{'FAIL ' if fail[i] else 'TIMEO'} t={t_end:5.1f}s "
                  f"agl={eo[i, 16]:6.1f} vd={eo[i, 6]:+6.2f} "
                  f"phi={eo[i, 7]:+.2f} th={eo[i, 8]:+.2f}")
        out["per_seed"].append({"seed": seed, "succ": float(succ.mean()),
                                "fail": float(fail.mean())})
    mean = float(np.mean([s["succ"] for s in out["per_seed"]]))
    out["mean_succ"] = mean
    print(json.dumps({"mean_succ": mean,
                      "mean_fail": float(np.mean(
                          [s["fail"] for s in out["per_seed"]]))}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
