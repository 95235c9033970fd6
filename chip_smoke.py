#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heligym_tpu_torch) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, any
failure exits non-zero:
  1. build every kernel from csrc/ (nvcc, one process per source, in
     parallel): the fused env step and the two gather probe kernels;
  2. hold the fused step against its plain PyTorch version on the card at
     the main path's shapes (4096 envs, real terrain, perturbed actions,
     injected noise): hover from its trim for 1 and 30 steps nominal and a
     300-step dive that crashes and auto-resets; then each of the six tasks
     and the 4-task MixedTask from a 60 ft/s trim, 30 steps and the dive;
  3. the hover rollout end to end, as bench.py drives the JAX package:
     one warm-up chunk and 2 timed chunks of 500 steps of
     `build_fused_rollout(eta_mode="batch")` with the trim action;
  4. the gather probe (tools/torch_exp_gather.py): each kernel against
     np.take_along_axis and its plain version at every probe size, with its
     device time beside torch.gather's and the bound;
  5. the collector: the committed 4-task policy in the loop of 4096 envs,
     one warm-up and 5 rollouts of 64 steps through `PPOLearner.collect`;
  6. the evaluator: `multi_seed_evaluate` of the committed multitask4 and
     hover4k policies beside their committed scores;
  7. numbers: the step kernel's device time per launch beside its bound and
     its plain version, and one JSON line describing each kernel.
Before each path (3, 4, 5, 6) every kernel's launch count is set to 0, and
read just after; a path whose kernel was never launched fails the script.
The last line is {"ok": true, "device": {...}}; the line starting
"[report]" holds every measured number as JSON.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ENVS = 4096
CHUNK = 500
CHUNKS = 2
ROLLOUT_STEPS = 64
ROLLOUTS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = {"reward_atol": 2e-5, "state_rtol": 2e-4, "state_atol": 2e-4,
       "obs_rtol": 1e-4, "obs_atol": 2e-3}
EVAL_MARGIN = 0.03             # a per-head success mean may lie this far below
MIXED4 = ("hover", "forward", "turning", "oblique")
EVALS = {
    "multitask4": dict(tasks=",".join(MIXED4), task="hover",
                       target="sea_alt=start,vel=60", episodes=512),
    "hover4k": dict(tasks=None, task="hover", target="sea_alt=start",
                    episodes=256),
}


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
        from heligym_tpu_torch.envs import (ForwardFlightTask, HeliEnv, HoverTask,
                                            LandingTask, MixedTask,
                                            ObliqueFlightTask, SlalomTask,
                                            TurningFlightTask, VectorHeliEnv)
        from heligym_tpu_torch.learner import PPOConfig, PPOLearner
        from heligym_tpu_torch.learner.evaluate import build_env, multi_seed_evaluate
        from heligym_tpu_torch.ops.cuda import build, fused_step as fs, gather
        from heligym_tpu_torch.utils.profiling import (device_time_ms, event_time_ms,
                                                       kernel_times_ms)
        spec = importlib.util.spec_from_file_location(
            "torch_exp_gather", os.path.join(here, "tools", "torch_exp_gather.py"))
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
    except (ImportError, OSError) as e:
        fail(f"the port is not beside this script ({e}); run it from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    dev = torch.device("cuda")

    def zero_counts():
        fs.launches = 0
        for k in gather.launches:
            gather.launches[k] = 0

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build([fs.KERNEL, gather.KERNEL])
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {fs.KERNEL}, {gather.KERNEL}: {report['build_s']:.1f} s")
    for name in (fs.KERNEL, gather.KERNEL):
        for line in build.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    fs.kernel_fn()
    gather.kernel_fns()

    # ---- 2. kernel against its plain version on the card ---------------------
    rng = np.random.default_rng(0)

    def inputs(tr, steps, dive):
        act = np.tile(tr.action.cpu().numpy(), (steps, N_ENVS, 1))
        act = (act + 0.02 * rng.standard_normal(act.shape)).astype(np.float32)
        if dive:
            act[..., 0] = -1.0
        eta = (rng.standard_normal((steps, 3, N_ENVS)) * 50.0 ** 0.5
               ).astype(np.float32)
        return torch.from_numpy(act).to(dev), torch.from_numpy(eta).to(dev)

    def compare(env, es, tr, steps, dive):
        """Kernel and plain version side by side from `es`; the nominal run
        asserts the parity tolerances at every step, the dive only compares
        the discrete streams (a NaN reward equals a NaN reward)."""
        act, eta = inputs(tr, steps, dive)
        ck, init = fs.pack(es)
        cp = ck.clone()
        err = {"reward": 0.0, "obs": 0.0, "state": 0.0, "one_launch": 0.0}

        def diff(a, b):
            """max |a - b|; equal values (infinities too) and a NaN facing a
            NaN count 0, a NaN facing a number counts inf."""
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            d = torch.where(same, torch.zeros_like(a), (a - b).abs())
            return float(torch.nan_to_num(d, nan=float("inf")).max())

        close = lambda a, b, rtol, atol: torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol, equal_nan=True)
        dones_k, dones_p = [], []
        with torch.no_grad():
            for t in range(steps):
                ck, xk = fs.fused_step(env, ck, init, act[t], eta[t])
                cp, xp = fs.fused_step_plain(env, cp, init, act[t], eta[t])
                if t == 0:
                    err["one_launch"] = max(diff(ck, cp), diff(xk, xp))
                    if not torch.equal(torch.isnan(xk), torch.isnan(xp)):
                        fail("NaN patterns differ after one launch")
                err["reward"] = max(err["reward"], diff(xk[fs.CREW], xp[fs.CREW]))
                err["obs"] = max(err["obs"],
                                 diff(xk[fs.COBS0:fs.CSUCC], xp[fs.COBS0:fs.CSUCC]),
                                 diff(xk[fs.CFINAL0:], xp[fs.CFINAL0:]))
                err["state"] = max(err["state"], diff(ck[:fs.SROWS], cp[:fs.SROWS]))
                if not dive:
                    close(xk[fs.CREW], xp[fs.CREW], 0, TOL["reward_atol"])
                    for lo, hi in ((fs.COBS0, fs.CSUCC), (fs.CFINAL0, fs.XROWS)):
                        close(xk[lo:hi], xp[lo:hi], TOL["obs_rtol"], TOL["obs_atol"])
                    if not (torch.equal(xk[fs.CDONE:fs.COBS0], xp[fs.CDONE:fs.COBS0])
                            and torch.equal(xk[fs.CSUCC], xp[fs.CSUCC])):
                        fail(f"flags differ at step {t}")
                dones_k.append(xk[fs.CDONE].clone())
                dones_p.append(xp[fs.CDONE].clone())
            if not dive:
                close(ck[:fs.SROWS], cp[:fs.SROWS], TOL["state_rtol"],
                      TOL["state_atol"])
                if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
                    fail(f"counters differ after {steps} steps")
        torch.cuda.synchronize()
        return err, torch.stack(dones_k), torch.stack(dones_p), ck, cp

    def check_task(label, env, es, tr, nominal):
        """Nominal runs of each length in `nominal`, then the 300-step dive."""
        out = {}
        for steps in nominal:
            err, _, _, _, _ = compare(env, es, tr, steps, dive=False)
            out[f"nominal_{steps}"] = err
            print(f"[check] {label}: kernel vs plain, {steps} step(s) at {N_ENVS} "
                  f"envs: max |err| reward {err['reward']:.3e} obs {err['obs']:.3e} "
                  f"state {err['state']:.3e}")
        err, dk, dp, ck, cp = compare(env, es, tr, 300, dive=True)
        mismatch = int((dk != dp).sum())
        out["dive_300"] = {**err, "done_frac": float(dk.mean()),
                           "done_mismatch": mismatch}
        print(f"[check] {label}: dive 300 steps: done fraction "
              f"{float(dk.mean()):.4f}, mismatched done flags {mismatch}")
        if not bool(dk.any()):
            fail(f"{label}: the dive never terminated")
        if mismatch:
            fail(f"{label}: {mismatch} done flags differ between kernel and plain")
        if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
            fail(f"{label}: dive counters differ between kernel and plain")
        if not bool((ck[fs.STEPS] < 300).all()):
            fail(f"{label}: dive counters did not reset")
        return out

    env = HeliEnv.build("aw109", task=HoverTask(), device=dev)
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, N_ENVS).reset_from_trim(tr)
    report["hover"] = check_task("hover (trim)", env, es, tr, (1, 30))
    max_abs_err = max(report["hover"]["nominal_1"]["one_launch"],
                      *(report["hover"]["nominal_30"][k]
                        for k in ("reward", "obs", "state")))

    tr60 = env.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
    alt = float(-tr60.state.z)
    singles = {"hover": HoverTask(sea_alt=alt),
               "forward": ForwardFlightTask(sea_alt=alt, vel=60.0),
               "turning": TurningFlightTask(sea_alt=alt),
               "slalom": SlalomTask(sea_alt=alt, vel=60.0),
               "landing": LandingTask(touch_alt=alt - 100.0),
               "oblique": ObliqueFlightTask(sea_alt=alt, vel=60.0)}
    all_tasks = {**singles, "mixed4": MixedTask(tasks=tuple(singles[k] for k in MIXED4))}
    report["tasks"] = {}
    for name, task in all_tasks.items():
        env_t = env.replace(task=task)
        venv_t = VectorHeliEnv(env_t, N_ENVS)
        es_t, _ = venv_t.reset_from_trim(tr60)
        if name == "mixed4":
            es_t = venv_t.assign_tasks(es_t, np.arange(N_ENVS) % len(MIXED4))
        res = check_task(name, env_t, es_t, tr60, (30,))
        report["tasks"][name] = res
        max_abs_err = max(max_abs_err, res["nominal_30"]["reward"],
                          res["nominal_30"]["state"], res["nominal_30"]["obs"])

    # ---- 3. the hover rollout end to end --------------------------------------
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    venv = VectorHeliEnv(env, N_ENVS)
    es, _ = venv.reset_from_trim(tr)
    actions = tr.action.to(env.device).expand(N_ENVS, 4).contiguous()
    roll = fs.build_fused_rollout(env, N_ENVS, CHUNK, eta_mode="batch",
                                  collect=("reward", "done", "failed"))
    gen = torch.Generator(device=env.device).manual_seed(0)
    zero_counts()
    es, outs = roll(es, actions, generator=gen)          # warm-up
    torch.cuda.synchronize()
    ended = 0
    t0 = time.perf_counter()
    for _ in range(CHUNKS):
        es, outs = roll(es, actions, generator=gen)
        ended += int((outs["done"] | outs["truncated"]).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hover_launches = fs.launches
    if hover_launches != CHUNK * (CHUNKS + 1):
        fail(f"kernel launched {hover_launches} times, expected {CHUNK * (CHUNKS + 1)}")
    # a blown-up env may emit one non-finite reward on the very step its
    # non-finite failsafe ends it; everywhere else the reward is finite, and
    # the state is finite always (a failed env is reset)
    checks = {"reward": torch.isfinite(outs["reward"]) | outs["failed"],
              "heli": torch.isfinite(es.heli.flatten()),
              "obs": torch.isfinite(es.obs), "wind": torch.isfinite(es.wind.flatten())}
    for name, ok in checks.items():
        if not bool(ok.all()):
            fail(f"hover rollout: {int((~ok).sum())} non-finite values in {name}")
    if outs["reward"].shape != (CHUNK, N_ENVS):
        fail(f"hover rollout: reward has shape {tuple(outs['reward'].shape)}")
    rate = N_ENVS * CHUNK * CHUNKS / wall
    hover_ended_frac = ended / (N_ENVS * CHUNK * CHUNKS)
    report["hover_path"] = {"env_steps_per_s": rate, "wall_s": wall,
                            "launches": hover_launches,
                            "ended_frac": hover_ended_frac}
    print(f"[hover] {CHUNKS} x {CHUNK} steps at {N_ENVS} envs: {rate:.1f} "
          f"env-steps/s, {hover_launches} kernel launches, ended fraction "
          f"{hover_ended_frac:.5f}")
    hover_env, hover_es, hover_actions = env, es, actions

    # ---- 4. the gather probe ---------------------------------------------------
    zero_counts()
    rows = probe.run_probe()
    gather_launches = dict(gather.launches)
    report["gather"] = rows
    for r in rows:
        if not r["correct"] or r["max_abs_err"] != 0.0:
            fail(f"{r['name']} at ({r['S']}, {r['L']}) disagrees with its plain version")
    for name, n in gather_launches.items():
        if n == 0:
            fail(f"{name} was never launched by the probe")

    # ---- 5. the collector -------------------------------------------------------
    cfg = EVALS["multitask4"]
    env, n_tasks = build_env(cfg["task"], cfg["tasks"], cfg["target"])
    learner = PPOLearner(env, PPOConfig(num_envs=N_ENVS, rollout_steps=ROLLOUT_STEPS))
    ckpt = os.path.join(here, "examples", "multitask4_policy.npz")
    task_ids = np.arange(N_ENVS) % n_tasks
    ts = learner.restore(ckpt, learner.init(task_ids=task_ids))
    gen = torch.Generator(device=env.device).manual_seed(0)
    zero_counts()
    ts, traj = learner.collect(ts, gen)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ended = 0.0
    for _ in range(ROLLOUTS):
        ts, traj = learner.collect(ts, gen)
        ended += float((traj.terminated + traj.truncated).clamp(max=1.0).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fs.launches
    if launches != ROLLOUT_STEPS * (ROLLOUTS + 1):
        fail(f"collector: kernel launched {launches} times, expected "
             f"{ROLLOUT_STEPS * (ROLLOUTS + 1)}")
    shapes = {"obs": (17,), "action": (4,), "task_oh": (n_tasks,)}
    for f in ("obs", "action", "log_prob", "value", "reward", "terminated",
              "truncated", "v_boot", "failed", "succ_step", "task_oh"):
        v = getattr(traj, f)
        if v.shape != (ROLLOUT_STEPS, N_ENVS) + shapes.get(f, ()):
            fail(f"collector: {f} has shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            fail(f"collector: {int((~torch.isfinite(v)).sum())} non-finite values "
                 f"in {f}")
    task_reward = [float(traj.reward[:, i::n_tasks].mean()) for i in range(n_tasks)]
    if len({round(r, 7) for r in task_reward}) != n_tasks:
        fail(f"collector: task populations share a mean reward: {task_reward}")
    coll_rate = N_ENVS * ROLLOUT_STEPS * ROLLOUTS / wall
    step_us = wall / (ROLLOUT_STEPS * ROLLOUTS) * 1e6
    coll_ended_frac = ended / (N_ENVS * ROLLOUT_STEPS * ROLLOUTS)
    # how one step splits: device time of the step kernel and of everything
    # else (the policy's kernels, copies), from one profiled rollout
    state = {"ts": ts}

    def one_rollout():
        state["ts"], _ = learner.collect(state["ts"], gen)
    saved = fs.launches
    times = kernel_times_ms(one_rollout, 1, warmup=0)
    fs.launches = saved
    is_step = lambda name: "fused_step_kernel" in name
    kern_us = sum(r["ms"] for k, r in times.items() if is_step(k)) / ROLLOUT_STEPS * 1e3
    other_us = sum(r["ms"] for k, r in times.items() if not is_step(k)
                   ) / ROLLOUT_STEPS * 1e3
    other_launches = sum(r["count"] for k, r in times.items() if not is_step(k)
                         ) / ROLLOUT_STEPS
    report["collector"] = {
        "env_steps_per_s": coll_rate, "wall_s": wall, "us_per_step": step_us,
        "launches": launches, "ended_frac": coll_ended_frac,
        "task_mean_reward": task_reward,
        "succ_step_frac": float(traj.succ_step.mean()),
        "device_us_per_step": {"step_kernel": kern_us, "policy_and_copies": other_us},
        "other_device_launches_per_step": other_launches,
        "host_us_per_step": step_us - kern_us - other_us}
    print(f"[collector] {ROLLOUTS} x {ROLLOUT_STEPS} steps at {N_ENVS} envs: "
          f"{coll_rate:.1f} env-steps/s, {step_us:.1f} us per step = step kernel "
          f"{kern_us:.2f} us + policy and copies {other_us:.2f} us in "
          f"{other_launches:.1f} launches on the device + "
          f"{step_us - kern_us - other_us:.1f} us of host-paced idle; {launches} "
          f"kernel launches; mean reward by task {task_reward}")
    mixed_env, mixed_ts = env, ts

    # ---- 6. the evaluator ---------------------------------------------------------
    report["evaluation"] = {}
    eval_launches = 0
    for name, cfg in EVALS.items():
        env, n_tasks = build_env(cfg["task"], cfg["tasks"], cfg["target"])
        learner_e = PPOLearner(env, PPOConfig(num_envs=N_ENVS))
        ts_e = learner_e.restore(os.path.join(here, "examples", f"{name}_policy.npz"))
        steps = env.time_up_steps + 3
        ids = np.arange(cfg["episodes"]) % n_tasks if n_tasks else None
        zero_counts()
        t0 = time.perf_counter()
        res = multi_seed_evaluate(env, learner_e, ts_e, episodes=cfg["episodes"],
                                  steps=steps, seeds=(0, 1, 2), task_ids=ids)
        wall = time.perf_counter() - t0
        if fs.launches != 6 * steps:
            fail(f"evaluation {name}: kernel launched {fs.launches} times, "
                 f"expected {6 * steps}")
        eval_launches += fs.launches
        with open(os.path.join(here, "examples", f"{name}_eval.json")) as f:
            committed = json.load(f)["aggregate"]
        pairs = {}
        for policy in ("mean", "stochastic"):
            for k, v in res["aggregate"][policy].items():
                if k.startswith("success_frac"):
                    pairs[f"{policy}.{k}"] = (v["mean"], committed[policy][k]["mean"])
        report["evaluation"][name] = {
            "wall_s": wall, "launches": fs.launches, "aggregate": res["aggregate"],
            "success_mean_vs_committed": pairs}
        print(f"[eval] {name}: 2 policies x seeds 0,1,2 x {cfg['episodes']} episodes "
              f"x {steps} steps in {wall:.1f} s; success_frac mean (this run, committed):")
        for k, (got, want) in pairs.items():
            print(f"[eval]   {k}: {got:.4f}  {want:.4f}")
            if k.startswith("mean.") and got < want - EVAL_MARGIN:
                fail(f"evaluation {name}: {k} {got:.4f} lies more than "
                     f"{EVAL_MARGIN} below the committed {want:.4f}")

    # ---- 7. numbers -------------------------------------------------------------
    def step_numbers(env, es, actions, ended_frac, mixed):
        """Device time, launch-loop time, plain time and bound of one step."""
        carry, init = fs.pack(es)
        eta = torch.randn((3, N_ENVS), device=dev) * 50.0 ** 0.5
        xbuf = torch.empty((fs.XROWS, N_ENVS), device=dev)
        kernel = lambda: fs.fused_step(env, carry, init, actions, eta,
                                       carry_out=carry, collect_out=xbuf)
        saved = fs.launches
        loop_ms = event_time_ms(kernel, 500)
        kernel_ms = device_time_ms(kernel, 100, "fused_step_kernel")
        fs.launches = saved
        with torch.no_grad():
            plain = lambda: fs.fused_step_plain(env, carry, init, actions, eta)
            plain_ms = event_time_ms(plain, 10, warmup=1)
            ops_per_env = count_elementwise_ops(plain) / N_ENVS
        bytes_step = N_ENVS * (fs.BYTES_PER_ENV_STEP + fs.BYTES_COLLECT
                               + (fs.BYTES_TASK_ID if mixed else 0)
                               + ended_frac * fs.BYTES_RESET)
        t_bytes = bytes_step / HBM_BYTES_PER_S * 1e3
        t_ops = N_ENVS * ops_per_env / FP32_OPS_PER_S * 1e3
        return {"kernel_ms": kernel_ms if kernel_ms else loop_ms,
                "kernel_ms_source": "profiler" if kernel_ms else "cuda events",
                "loop_ms": loop_ms, "plain_ms": plain_ms,
                "bytes_per_step": bytes_step,
                "elementwise_ops_per_env_step": ops_per_env,
                "bound_ms_bytes": t_bytes, "bound_ms_ops": t_ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    mixed_actions = learner.act_bias.expand(N_ENVS, 4).contiguous()
    report["numbers"] = {
        "hover": step_numbers(hover_env, hover_es, hover_actions,
                              hover_ended_frac, mixed=False),
        "mixed4": step_numbers(mixed_env, mixed_ts.env_state, mixed_actions,
                               coll_ended_frac, mixed=True)}
    for name, nb in report["numbers"].items():
        print(f"[time] {name}: kernel {nb['kernel_ms'] * 1e3:.2f} us/launch "
              f"({nb['kernel_ms_source']}), {nb['loop_ms'] * 1e3:.2f} us per step in a "
              f"launch loop, bound {nb['bound_ms'] * 1e3:.3f} us ({nb['bound_by']}: "
              f"{nb['bytes_per_step']:.0f} B, {nb['elementwise_ops_per_env_step']:.0f} "
              f"elementwise ops/env), plain {nb['plain_ms']:.3f} ms/step")
    print(f"[time] hover rollout {rate:.1f} env-steps/s; collector "
          f"{coll_rate:.1f} env-steps/s")

    nb = report["numbers"]["mixed4"]
    kernels = [{"name": fs.KERNEL, "route": "cuda",
                "source": "heligym_tpu_torch/csrc/fused_step.cu",
                "replaces": fs.REPLACES, "launches": launches,
                "launches_by_path": {"hover_rollout": hover_launches,
                                     "collector": launches,
                                     "evaluation": eval_launches},
                "max_abs_err": max_abs_err, "ms": nb["kernel_ms"],
                "plain_ms": nb["plain_ms"], "bound_ms": nb["bound_ms"],
                "bound_by": nb["bound_by"], "library_ms": None,
                "hover_ms": report["numbers"]["hover"]["kernel_ms"],
                "hover_bound_ms": report["numbers"]["hover"]["bound_ms"]}]
    for name in ("gather_axis0", "gather_axis1"):
        big = [r for r in rows_of(report["gather"], name)][-1]    # (1024, 1024)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "heligym_tpu_torch/csrc/gather.cu",
            "replaces": gather.REPLACES[name], "launches": gather_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows_of(report["gather"], name)),
            "shape": [big["S"], big["L"]],
            "ms": big["us"] / 1e3, "plain_ms": big["plain_us"] / 1e3,
            "bound_ms": big["bound_us"] / 1e3, "bound_by": "bytes",
            "library_ms": big["library_us"] / 1e3})
    print("[report] " + json.dumps(report))
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def rows_of(rows, name):
    return [r for r in rows if r["name"] == name]


if __name__ == "__main__":
    main()
