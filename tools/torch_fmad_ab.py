#!/usr/bin/env python3
"""What `-fmad=false` costs the port's fused_step CUDA kernel, on one card.

Builds csrc/fused_step.cu twice — with the port's flags (-fmad=false) and
with -fmad=true — and, at the main path's shape (4096 envs, aw109 hover trim,
real terrain, perturbed actions, injected noise):
  * times each build's kernel on the device with torch.profiler, in turns
    (false, true, true, false);
  * runs each build 30 steps and a 300-step dive from the same state and
    inputs, and compares with the plain PyTorch version (max |diff| of the
    carry, and mismatched done flags).
Prints one JSON line. Run from the repo root: python3 tools/torch_fmad_ab.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv  # noqa: E402
from heligym_tpu_torch.ops.cuda import build, fused_step as fs  # noqa: E402

N = 4096


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    flags = {"fmad_false": build.NVCC_FLAGS,
             "fmad_true": tuple("-fmad=true" if f == "-fmad=false" else f
                                for f in build.NVCC_FLAGS)}
    fns = {k: fs.kernel_fn(v) for k, v in flags.items()}
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, N).reset_from_trim(tr)
    carry0, init = fs.pack(es)
    rng = np.random.default_rng(0)

    def inputs(steps, dive):
        act = np.tile(tr.action.numpy(), (steps, N, 1))
        act = (act + 0.02 * rng.standard_normal(act.shape)).astype(np.float32)
        if dive:
            act[..., 0] = -1.0
        eta = (rng.standard_normal((steps, 3, N)) * 50 ** 0.5).astype(np.float32)
        return torch.from_numpy(act).cuda(), torch.from_numpy(eta).cuda()

    def run(fn, carry, act, eta):
        x = torch.empty((fs.XROWS, N), device="cuda")
        err = fn(*fs.launch_args(env, carry, init, act, eta, True, carry, x))
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return x

    def kernel_us(fn, act, eta):
        carry = carry0.clone()
        run(fn, carry, act[0], eta[0])
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                run(fn, carry, act[0], eta[0])
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "fused_step_kernel" in e.key][0]
        total = getattr(ev, "device_time_total", None)
        total = ev.cuda_time_total if total is None else total
        return total / ev.count

    act, eta = inputs(1, False)
    times = {k: [] for k in fns}
    for k in ("fmad_false", "fmad_true", "fmad_true", "fmad_false"):
        times[k].append(kernel_us(fns[k], act, eta))

    parity = {}
    for name, steps, dive in (("nominal_30", 30, False), ("dive_300", 300, True)):
        act, eta = inputs(steps, dive)
        carries = {k: carry0.clone() for k in fns}
        cp = carry0.clone()
        dones = {k: [] for k in fns}
        dp = []
        with torch.no_grad():
            for t in range(steps):
                for k, fn in fns.items():
                    dones[k].append(run(fn, carries[k], act[t], eta[t])[fs.CDONE])
                cp, xp = fs.fused_step_plain(env, cp, init, act[t], eta[t])
                dp.append(xp[fs.CDONE])
        dp = torch.stack(dp)
        parity[name] = {k: {"max_abs_diff_vs_plain": float((carries[k][:fs.SROWS]
                                                           - cp[:fs.SROWS]).abs().max()),
                            "done_mismatch": int((torch.stack(dones[k]) != dp).sum())}
                        for k in fns}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "kernel_us": times, "parity": parity}))


if __name__ == "__main__":
    main()
