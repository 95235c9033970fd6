#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heligym_tpu_torch) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, any
failure exits non-zero:
  1. build every kernel of the main path from csrc/ (nvcc, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (4096 envs, real terrain, hover trim, perturbed
     actions, injected noise): 1 and 30 steps nominal, 300 steps of a dive
     that crashes and auto-resets;
  3. the slice end to end, as bench.py drives the JAX package: build the env
     on "cuda", trim, reset 4096 envs, one warm-up chunk and 5 timed chunks
     of 500 steps of `build_fused_rollout(eta_mode="batch")` with the trim
     action; the kernel's launch counter must show every step went through
     it, and every output must be finite;
  4. numbers: env-steps/s of the kernel path and of the plain path, the
     kernel's time per launch beside its bound, the card's name and power
     limit, and one JSON line describing each kernel.
The last line is {"ok": true, "device": {...}}; the line starting
"[report]" holds every measured number as JSON.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ENVS = 4096
CHUNK = 500
CHUNKS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = {"reward_atol": 2e-5, "state_rtol": 2e-4, "state_atol": 2e-4,
       "obs_rtol": 1e-4, "obs_atol": 2e-3}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def count_elementwise_ops(fn):
    """Elementwise float operations `fn` executes, per output element summed
    over its ATen calls (data movement excluded)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    movement = {"cat", "stack", "select", "slice", "view", "t", "transpose",
                "permute", "expand", "unsqueeze", "index", "_to_copy", "copy_",
                "clone", "full_like", "zeros_like", "empty_like", "lift_fresh",
                "alias", "detach", "unbind", "_unsafe_view", "reshape", "full",
                "zeros", "empty", "scalar_tensor", "lift_fresh_copy", "squeeze",
                "split", "contiguous", "as_strided", "new_empty", "fill_"}

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if name not in movement and isinstance(out, torch.Tensor):
                Counter.n += out.numel()
            return out

    with Counter():
        fn()
    return Counter.n


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv
        from heligym_tpu_torch.ops.cuda import build, fused_step as fs
    except ImportError as e:
        fail(f"the port is not beside this script ({e}); run it from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    dev = torch.device("cuda")

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build([fs.KERNEL])
    report["build_s"] = time.perf_counter() - t0
    log = build.BUILD_LOG[fs.KERNEL]
    print(f"[build] {fs.KERNEL}: {report['build_s']:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    fs.kernel_fn()

    # ---- 2. kernel against its plain version on the card ---------------------
    env = HeliEnv.build("aw109", task=HoverTask(), device=dev)
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, N_ENVS).reset_from_trim(tr)
    rng = np.random.default_rng(0)

    def inputs(steps, dive):
        act = np.tile(tr.action.cpu().numpy(), (steps, N_ENVS, 1))
        act = (act + 0.02 * rng.standard_normal(act.shape)).astype(np.float32)
        if dive:
            act[..., 0] = -1.0
        eta = (rng.standard_normal((steps, 3, N_ENVS)) * (1.0 / env.dt) ** 0.5
               ).astype(np.float32)
        return torch.from_numpy(act).to(dev), torch.from_numpy(eta).to(dev)

    def compare(steps, dive):
        act, eta = inputs(steps, dive)
        ck, init = fs.pack(es)
        cp = ck.clone()
        err = {"reward": 0.0, "obs": 0.0, "state": 0.0, "one_launch": 0.0}
        dones_k, dones_p = [], []
        with torch.no_grad():
            for t in range(steps):
                ck, xk = fs.fused_step(env, ck, init, act[t], eta[t])
                cp, xp = fs.fused_step_plain(env, cp, init, act[t], eta[t])
                if t == 0:
                    err["one_launch"] = max(float((ck - cp).abs().max()),
                                            float((xk - xp).abs().max()))
                err["reward"] = max(err["reward"], float(
                    (xk[fs.CREW] - xp[fs.CREW]).abs().max()))
                if not dive:
                    torch.testing.assert_close(
                        xk[fs.CREW], xp[fs.CREW], rtol=0, atol=TOL["reward_atol"])
                    torch.testing.assert_close(
                        xk[fs.COBS0:fs.CSUCC], xp[fs.COBS0:fs.CSUCC],
                        rtol=TOL["obs_rtol"], atol=TOL["obs_atol"])
                    if not torch.equal(xk[fs.CDONE:fs.COBS0], xp[fs.CDONE:fs.COBS0]):
                        fail(f"flags differ at step {t}")
                dones_k.append(xk[fs.CDONE].clone())
                dones_p.append(xp[fs.CDONE].clone())
                if steps in (1, 30) and t + 1 in (1, 30) and not dive:
                    torch.testing.assert_close(
                        ck[:fs.SROWS], cp[:fs.SROWS], rtol=TOL["state_rtol"],
                        atol=TOL["state_atol"])
                    if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
                        fail(f"counters differ after {t + 1} steps")
        torch.cuda.synchronize()
        err["obs"] = float((xk[fs.COBS0:fs.CSUCC] - xp[fs.COBS0:fs.CSUCC]).abs().max())
        err["state"] = float((ck[:fs.SROWS] - cp[:fs.SROWS]).abs().max())
        dk, dp = torch.stack(dones_k), torch.stack(dones_p)
        return err, dk, dp, ck, cp

    for steps in (1, 30):
        err, _, _, _, _ = compare(steps, dive=False)
        report[f"nominal_{steps}"] = err
        print(f"[check] kernel vs plain, {steps} step(s) at {N_ENVS} envs: "
              f"max |err| reward {err['reward']:.3e} obs {err['obs']:.3e} "
              f"state {err['state']:.3e}")
    max_abs_err = report["nominal_1"]["one_launch"]

    err, dk, dp, ck, cp = compare(300, dive=True)
    mismatch = int((dk != dp).sum())
    report["dive_300"] = {**err, "done_frac": float(dk.mean()),
                          "done_mismatch": mismatch}
    print(f"[check] dive 300 steps: done fraction {float(dk.mean()):.4f}, "
          f"mismatched done flags {mismatch}")
    if not bool(dk.any()):
        fail("the dive never terminated")
    if mismatch:
        fail(f"{mismatch} done flags differ between kernel and plain in the dive")
    if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
        fail("dive counters differ between kernel and plain")
    if not bool((ck[fs.STEPS] < 300).all()):
        fail("dive counters did not reset")

    # ---- 3. the slice end to end ---------------------------------------------
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    venv = VectorHeliEnv(env, N_ENVS)
    es, _ = venv.reset_from_trim(tr)
    actions = tr.action.to(env.device).expand(N_ENVS, 4).contiguous()
    roll = fs.build_fused_rollout(env, N_ENVS, CHUNK, collect=("reward", "done"),
                                  eta_mode="batch")
    gen = torch.Generator(device=env.device).manual_seed(0)
    fs.launches = 0
    es, outs = roll(es, actions, generator=gen)          # warm-up
    torch.cuda.synchronize()
    ended = 0
    t0 = time.perf_counter()
    for _ in range(CHUNKS):
        es, outs = roll(es, actions, generator=gen)
        ended += int((outs["done"] | outs["truncated"]).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fs.launches
    if launches != CHUNK * (CHUNKS + 1):
        fail(f"kernel launched {launches} times, expected {CHUNK * (CHUNKS + 1)}")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (outs["reward"], es.heli.flatten(), es.obs, es.wind.flatten()))
    if not finite or outs["reward"].shape != (CHUNK, N_ENVS):
        fail("non-finite or misshapen rollout outputs")
    rate = N_ENVS * CHUNK * CHUNKS / wall
    ended_frac = ended / (N_ENVS * CHUNK * CHUNKS)
    report["main_path"] = {"env_steps_per_s": rate, "wall_s": wall,
                           "launches": launches, "ended_frac": ended_frac}
    print(f"[slice] {CHUNKS} x {CHUNK} steps at {N_ENVS} envs: {rate:.1f} "
          f"env-steps/s, {launches} kernel launches, ended fraction {ended_frac:.5f}")

    # ---- 4. numbers -----------------------------------------------------------
    carry, init = fs.pack(es)
    eta = torch.randn((3, N_ENVS), device=dev, generator=gen) * (1.0 / env.dt) ** 0.5
    xbuf = torch.empty((fs.XROWS, N_ENVS), device=dev)

    def time_events(fn, n):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    saved = fs.launches
    kernel = lambda: fs.fused_step(env, carry, init, actions, eta,
                                   carry_out=carry, collect_out=xbuf)
    step_ms = time_events(kernel, 500)
    # Device time of the kernel alone; a launch loop is paced by the host.
    # Where the profiler sees no device time, the loop's events stand in.
    from torch.profiler import ProfilerActivity, profile
    kernel_ms = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            kernel()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "fused_step_kernel" in ev.key:
            total = getattr(ev, "device_time_total", None)
            total = getattr(ev, "cuda_time_total", 0.0) if total is None else total
            if total and ev.count:
                kernel_ms = total / ev.count / 1e3
    fs.launches = saved
    ms = kernel_ms if kernel_ms else step_ms

    with torch.no_grad():
        plain = lambda: fs.fused_step_plain(env, carry, init, actions, eta)
        plain_ms = time_events(plain, 20)
        t0 = time.perf_counter()
        c = carry.clone()
        for _ in range(50):
            c, _ = fs.fused_step_plain(env, c, init, actions, eta)
        torch.cuda.synchronize()
        plain_rate = N_ENVS * 50 / (time.perf_counter() - t0)
        ops_per_env = count_elementwise_ops(plain) / N_ENVS

    bytes_step = N_ENVS * (fs.BYTES_PER_ENV_STEP + fs.BYTES_COLLECT
                           + ended_frac * fs.BYTES_RESET)
    t_bytes = bytes_step / HBM_BYTES_PER_S * 1e3
    t_ops = N_ENVS * ops_per_env / FP32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    report["numbers"] = {"kernel_ms": ms, "kernel_ms_source":
                         "profiler" if kernel_ms else "cuda events",
                         "step_ms_events": step_ms, "plain_ms": plain_ms,
                         "plain_env_steps_per_s": plain_rate,
                         "bytes_per_step": bytes_step,
                         "elementwise_ops_per_env_step": ops_per_env,
                         "bound_ms_bytes": t_bytes, "bound_ms_ops": t_ops}
    print(f"[time] kernel {ms * 1e3:.2f} us/launch ({report['numbers']['kernel_ms_source']}),"
          f" {step_ms * 1e3:.2f} us per step in a launch loop, bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}: {bytes_step:.0f} B, "
          f"{ops_per_env:.0f} elementwise ops/env), plain {plain_ms:.3f} ms/step")
    print(f"[time] plain path {plain_rate:.1f} env-steps/s at {N_ENVS} envs x 50 steps;"
          f" kernel path {rate:.1f} env-steps/s")
    kernels = [{"name": fs.KERNEL, "route": "cuda",
                "source": "heligym_tpu_torch/csrc/fused_step.cu",
                "replaces": fs.REPLACES, "launches": launches,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "us": ms * 1e3, "bound_us": bound_ms * 1e3}]
    print("[report] " + json.dumps(report))
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
