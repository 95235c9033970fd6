#!/usr/bin/env python3
"""The fused step kernel before and after each step of its redesign, on one
CUDA card, in turns.

Takes the source of an earlier version of csrc/fused_step.cu (one thread per
env, one launch per step, the constant and task tables read from device
memory), e.g. made with

    mkdir -p build/parent
    git show <commit>:heligym_tpu_torch/csrc/fused_step.cu > build/parent/fused_step.cu

and builds it beside this tree's source with the same nvcc flags. At 4096
and 16384 envs, for hover (from its trim) and the 4-task MixedTask, it times
on the device, in turns (earlier, this tree, this tree, earlier):
  before  the earlier kernel, one launch per step (128-thread blocks);
  step 1  this tree's one-step launch, 128-thread blocks (constants in the
          parameter block);
  step 2  this tree's T-step launch at the same configuration, per step;
  step 3  the T-step and one-step launches at every block size the kernel
          takes (`fused_step.BLOCK` set for the measurement).
It also prints each build's registers, spills and SASS load counts, and
checks that the earlier kernel and this tree's give the same bits over 30
steps. Prints one JSON line. Run from the repo root:

    python3 tools/torch_step_ab.py --parent build/parent/fused_step.cu
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heligym_tpu_torch.envs import HeliEnv, HoverTask, MixedTask, VectorHeliEnv  # noqa: E402
from heligym_tpu_torch.learner.evaluate import build_env  # noqa: E402
from heligym_tpu_torch.ops.cuda import build, fused_step as fs  # noqa: E402
from heligym_tpu_torch.utils.profiling import device_time_ms, event_time_ms  # noqa: E402

ENVS = (4096, 16384)
STEPS = 200                     # steps of one T-step launch
BLOCKS = (32, 64, 128)


def parent_fn(src):
    lib = build.load(fs.KERNEL, build.NVCC_FLAGS, src)
    fn = lib.heligym_fused_step
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    fn.restype = ci
    return fn


def summary(src=None):
    path = build.library_path(fs.KERNEL, build.NVCC_FLAGS, src)
    return {"ptxas": build.ptxas_summary(build.BUILD_LOG.get(path, "")),
            "sass": build.sass_counts(path)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an earlier csrc/fused_step.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    old = parent_fn(args.parent)
    fs.kernel_fn()
    out = {"card": card, "builds": {"earlier": summary(args.parent), "this": summary()},
           "rows": []}
    dev = torch.device("cuda")
    hover = HeliEnv.build("aw109", task=HoverTask())
    mixed, n_sub = build_env("hover", "hover,forward,turning,oblique",
                             "sea_alt=start,vel=60")
    for n in ENVS:
        for name, env in (("hover", hover), ("mixed4", mixed)):
            venv = VectorHeliEnv(env, n)
            tr = env.trim_result()
            es, _ = venv.reset_from_trim(tr)
            if isinstance(env.task, MixedTask):
                es = venv.assign_tasks(es, np.arange(n) % n_sub)
            carry0, init = fs.pack(es)
            act = tr.action.to(dev).expand(n, 4).contiguous()
            eta = torch.randn((3, n), device=dev) * 50.0 ** 0.5
            eta_seq = torch.randn((STEPS, 3, n), device=dev) * 50.0 ** 0.5
            xbuf = torch.empty((fs.XROWS, n), device=dev)
            xseq = torch.empty((STEPS, fs.XROWS, n), device=dev)
            consts, tasks = (torch.from_numpy(t).to(dev) for t in fs._tables(env))
            map_h, map_w = env.terrain.hmap.shape
            c = carry0.clone()

            def earlier():
                err = old(c.data_ptr(), c.data_ptr(), init.data_ptr(), act.data_ptr(),
                          eta.data_ptr(), env.terrain.packed.data_ptr(),
                          consts.data_ptr(), tasks.data_ptr(), xbuf.data_ptr(), n, 1,
                          map_h, map_w, tasks.shape[0],
                          int(isinstance(env.task, MixedTask)),
                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"earlier kernel: cudaError {err}")

            def with_block(block, fn):
                def run():
                    kept, fs.BLOCK = fs.BLOCK, block
                    try:
                        fn()
                    finally:
                        fs.BLOCK = kept
                return run

            def step(block=128):
                return with_block(block, lambda: fs.fused_step(
                    env, c, init, act, eta, carry_out=c, collect_out=xbuf))

            def rollout(block=128):
                return with_block(block, lambda: fs.fused_rollout(
                    env, c, init, act, eta_seq, carry_out=c, collect_out=xseq))

            row = {"envs": n, "task": name, "before_us": [], "step1_us": []}
            for which in ("before", "step1", "step1", "before"):
                if which == "before":
                    row["before_us"].append(device_time_ms(earlier, 100) * 1e3)
                else:
                    row["step1_us"].append(
                        device_time_ms(step(), 100, "fused_step_kernel") * 1e3)
            row["step2_us_per_step"] = event_time_ms(rollout(), 5, warmup=1) / STEPS * 1e3
            row["step3"] = [{"block": b,
                             "step_us": device_time_ms(step(b), 50,
                                                       "fused_step_kernel") * 1e3,
                             "rollout_us_per_step":
                                 event_time_ms(rollout(b), 5, warmup=1) / STEPS * 1e3}
                            for b in BLOCKS]
            # the same bits from the earlier kernel and this tree's, 30 steps
            c_old, c_new = carry0.clone(), carry0.clone()
            x_new = torch.empty_like(xbuf)
            for _ in range(30):
                c = c_old
                earlier()
                fs.fused_step(env, c_new, init, act, eta, carry_out=c_new,
                              collect_out=x_new)
            torch.cuda.synchronize()
            row["bits_differing"] = int(
                (c_old.view(torch.int32) != c_new.view(torch.int32)).sum()
                + (xbuf.view(torch.int32) != x_new.view(torch.int32)).sum())
            out["rows"].append(row)
            print(f"[ab] {n} envs {name}: before {row['before_us']} us, step 1 "
                  f"{row['step1_us']} us, step 2 {row['step2_us_per_step']:.3f} us/step, "
                  f"step 3 " + ", ".join(
                      f"{r['block']}: {r['step_us']:.2f} | "
                      f"{r['rollout_us_per_step']:.3f}" for r in row["step3"])
                  + f"; bits differing {row['bits_differing']}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
