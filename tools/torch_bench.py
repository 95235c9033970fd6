#!/usr/bin/env python
"""Benchmark the PyTorch/CUDA port: aggregate env-steps/s at 4096 lockstep envs.

The counterpart of the JAX package's `bench.py`, with its flags and its
output: ONE JSON line {"metric", "value", "unit", "vs_baseline"}, the
baseline the reference's best published single-env throughput of 500 env
steps/s. The measured program is the hover env step (aw109, real terrain,
Dryden turbulence drawn on the device, helicopter RK4, reward, termination,
auto-reset) with the trim action held: by default `build_fused_rollout`, one
T-step launch of `csrc/fused_step.cu` per chunk; `--unfused` steps the plain
PyTorch env (`VectorHeliEnv.step`) instead. One warm-up chunk, then
`--chunks` timed chunks of `--chunk-steps` steps, ending in a host sync.

    python3 tools/torch_bench.py [--num-envs 4096] [--chunk-steps 500]
        [--chunks 5] [--flat-terrain] [--unfused] [--device cpu]

It runs on the card unless `--device cpu` asks for the CPU, where the fused
rollout runs its plain version. Numbers are printed unrounded.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--chunk-steps", type=int, default=500)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--flat-terrain", action="store_true")
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)

    import torch

    from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv
    from heligym_tpu_torch.ops.cuda.fused_step import build_fused_rollout

    env = HeliEnv.build("aw109", task=HoverTask(), flat_ground=args.flat_terrain,
                        device=args.device)
    n, steps = args.num_envs, args.chunk_steps
    tr = env.trim_result()
    venv = VectorHeliEnv(env, n)
    es, _ = venv.reset_from_trim(tr)
    actions = tr.action.to(env.device).expand(n, 4).contiguous()
    generator = torch.Generator(device=env.device).manual_seed(0)

    if args.unfused:
        def run(es):
            with torch.no_grad():
                for _ in range(steps):
                    es, _ = venv.step(es, actions, generator=generator)
            return es
    else:
        roll = build_fused_rollout(env, n, steps, collect=())

        def run(es):
            with torch.no_grad():
                return roll(es, actions, generator=generator)[0]

    def sync(es):
        # a device-to-host scalar fetch waits for everything queued before it
        if not bool(torch.isfinite(es.heli.z[0])):
            raise RuntimeError("non-finite state after a chunk")

    es = run(es)               # warm-up (and, on the card, the kernel's load)
    sync(es)
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        es = run(es)
    sync(es)
    wall = time.perf_counter() - t0

    rate = n * steps * args.chunks / wall
    print(json.dumps({"metric": f"env_steps_per_sec@{n}envs", "value": rate,
                      "unit": "env-steps/s", "vs_baseline": rate / 500.0}))


if __name__ == "__main__":
    main()
