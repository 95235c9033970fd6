#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (heligym_tpu_torch) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, any
failure exits non-zero:
  1. build every kernel from csrc/ (nvcc, one process per source, in
     parallel): the fused env step and the two gather probe kernels; print
     each kernel's registers and spills (`-Xptxas -v`) and its global and
     constant load counts (`cuobjdump -sass`);
  2. hold the fused step against its plain PyTorch version on the card at
     the main path's shapes (4096 envs, real terrain, perturbed actions,
     injected noise): hover from its trim for 1 and 30 steps nominal and a
     300-step dive that crashes and auto-resets; then each of the six tasks
     and the 4-task MixedTask from a 60 ft/s trim, 30 steps and the dive.
     Every run also goes through one T-step launch, held bit for bit
     against the one-step launches;
  3. the hover rollout end to end, as bench.py drives the JAX package:
     one warm-up chunk and 2 timed chunks of 500 steps of
     `build_fused_rollout(eta_mode="batch")` with the trim action, one
     T-step launch per chunk; a loop of one `fused_step` launch per step
     over the same inputs timed beside it and held equal to it;
  4. the gather probe (tools/torch_exp_gather.py): each kernel against
     np.take_along_axis and its plain version at every probe size, with its
     device time beside torch.gather's and the bound;
  5. the collector: the committed 4-task policy in the loop of 4096 envs,
     one warm-up and 5 rollouts of 64 steps through `PPOLearner.collect`,
     each one CUDA graph replay; the eager loop timed beside it and held
     equal to it bit for bit;
  6. the evaluator: `multi_seed_evaluate` of the committed multitask4 and
     hover4k policies beside their committed scores;
  7. numbers: the step kernel's device time per step, one-step and T-step
     launches, beside their bounds and the plain version; the block sizes
     at 4096 and 16384 envs; one JSON line describing each kernel.
Before each path (3, 4, 5, 6) every kernel's counts are set to 0, and read
just after; a path whose kernel never ran fails the script. The step
kernel's count is of env steps it ran: a T-step launch or a graph replay of
T steps counts T, a graph capture 1 (its warm-up launch); the profiled
collector rollout must show exactly T step-kernel executions. The last
line is {"ok": true, "device": {...}}; the line
starting "[report]" holds every measured number as JSON.
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
SWEEP_ENVS = (4096, 16384)
SWEEP_BLOCKS = (32, 64, 128)
SWEEP_STEPS = 200
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
              "cuda": torch.version.cuda, "block": fs.BLOCK}
    dev = torch.device("cuda")

    def zero_counts():
        fs.launches = 0
        for k in fs.calls:
            fs.calls[k] = 0
        for k in gather.launches:
            gather.launches[k] = 0

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build([fs.KERNEL, gather.KERNEL])
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {fs.KERNEL}, {gather.KERNEL}: {report['build_s']:.1f} s")
    report["ptxas"], report["sass"] = {}, {}
    for name in (fs.KERNEL, gather.KERNEL):
        path = build.library_path(name)
        for fn, info in build.ptxas_summary(build.BUILD_LOG.get(path, "")).items():
            report["ptxas"][fn] = info
            print(f"[build] {name}: {fn}: {info.get('registers')} registers, "
                  f"{info.get('spill_stores', 0)} B spill stores, "
                  f"{info.get('spill_loads', 0)} B spill loads, "
                  f"{info.get('stack', 0)} B stack")
        for fn, counts in build.sass_counts(path).items():
            report["sass"][fn] = counts
            print(f"[build] {name}: {fn}: SASS " +
                  ", ".join(f"{op} {c}" for op, c in counts.items()))
    fs.kernel_fn()
    fs.rollout_kernel_fn()
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

    def diff(a, b):
        """max |a - b|; equal values (infinities too) and a NaN facing a
        NaN count 0, a NaN facing a number counts inf."""
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())

    def bit_mismatches(a, b):
        return int((a.contiguous().view(torch.int32)
                    != b.contiguous().view(torch.int32)).sum())

    def compare(env, es, tr, steps, dive):
        """Kernel and plain version side by side from `es`; the nominal run
        asserts the parity tolerances at every step, the dive only compares
        the discrete streams (a NaN reward equals a NaN reward). Then the
        same inputs through one T-step launch, against the one-step
        launches."""
        act, eta = inputs(tr, steps, dive)
        ck, init = fs.pack(es)
        c0, cp = ck.clone(), ck.clone()
        err = {"reward": 0.0, "obs": 0.0, "state": 0.0, "one_launch": 0.0}
        close = lambda a, b, rtol, atol: torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol, equal_nan=True)
        xs_k, dones_p = [], []
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
                xs_k.append(xk)
                dones_p.append(xp[fs.CDONE].clone())
            if not dive:
                close(ck[:fs.SROWS], cp[:fs.SROWS], TOL["state_rtol"],
                      TOL["state_atol"])
                if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
                    fail(f"counters differ after {steps} steps")
            xs_k = torch.stack(xs_k)
            c, x = fs.fused_rollout(env, c0.clone(), init, act, eta)
            forms = {"rollout": {
                "max_abs_err": max(diff(c, ck), diff(x, xs_k)),
                "bits_differing": bit_mismatches(c, ck) + bit_mismatches(x, xs_k),
                "done_mismatch": int((x[:, fs.CDONE] != xs_k[:, fs.CDONE]).sum())}}
        torch.cuda.synchronize()
        return err, xs_k[:, fs.CDONE], torch.stack(dones_p), ck, cp, forms

    def check_forms(label, steps, forms):
        for form, f in forms.items():
            print(f"[check] {label}: {form} launch vs one-step launches, {steps} "
                  f"step(s): max |err| {f['max_abs_err']:.3e}, bits differing "
                  f"{f['bits_differing']}, mismatched done flags {f['done_mismatch']}")
            if f["max_abs_err"] != 0.0 or f["bits_differing"] or f["done_mismatch"]:
                fail(f"{label}: the {form} launch differs from the one-step launches")

    def check_task(label, env, es, tr, nominal):
        """Nominal runs of each length in `nominal`, then the 300-step dive."""
        out = {}
        for steps in nominal:
            err, _, _, _, _, forms = compare(env, es, tr, steps, dive=False)
            out[f"nominal_{steps}"] = {**err, "forms": forms}
            print(f"[check] {label}: kernel vs plain, {steps} step(s) at {N_ENVS} "
                  f"envs: max |err| reward {err['reward']:.3e} obs {err['obs']:.3e} "
                  f"state {err['state']:.3e}")
            check_forms(label, steps, forms)
        err, dk, dp, ck, cp, forms = compare(env, es, tr, 300, dive=True)
        mismatch = int((dk != dp).sum())
        out["dive_300"] = {**err, "done_frac": float(dk.mean()),
                           "done_mismatch": mismatch, "forms": forms}
        print(f"[check] {label}: dive 300 steps: done fraction "
              f"{float(dk.mean()):.4f}, mismatched done flags {mismatch}")
        check_forms(label + " dive", 300, forms)
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
    collect = ("reward", "done", "failed")
    roll = fs.build_fused_rollout(env, N_ENVS, CHUNK, eta_mode="batch", collect=collect)

    def roll_1(es, actions, generator):
        """The same rollout in one `fused_step` launch per step, the noise
        drawn as `build_fused_rollout` draws it."""
        eta_seq = torch.randn((CHUNK, 3, N_ENVS), generator=generator,
                              device=env.device) * (1.0 / env.dt) ** 0.5
        carry, init = fs.pack(es)
        xbuf = torch.empty((CHUNK, fs.XROWS, N_ENVS), device=env.device)
        for t in range(CHUNK):
            fs.fused_step(env, carry, init, actions, eta_seq[t], carry_out=carry,
                          collect_out=xbuf[t])
        return fs.unpack(es, carry), {
            "reward": xbuf[:, fs.CREW], "done": xbuf[:, fs.CDONE] != 0,
            "truncated": xbuf[:, fs.CTRUNC] != 0, "failed": xbuf[:, fs.CFAIL] != 0}
    # the T-step launch with a held action equals one launch per step
    es_a, outs_a = roll(es, actions, generator=torch.Generator(dev).manual_seed(9))
    es_b, outs_b = roll_1(es, actions, generator=torch.Generator(dev).manual_seed(9))
    bits = bit_mismatches(fs.pack(es_a)[0], fs.pack(es_b)[0]) + sum(
        int((outs_a[k] != outs_b[k]).sum()) for k in outs_a
        if outs_a[k].dtype == torch.bool) + bit_mismatches(outs_a["reward"],
                                                          outs_b["reward"])
    print(f"[check] hover rollout: one T-step launch vs {CHUNK} one-step launches, "
          f"held action: values and flags differing {bits}")
    if bits:
        fail("the hover rollout's T-step launch differs from one launch per step")

    def timed_rollouts(rollout, es):
        gen = torch.Generator(device=env.device).manual_seed(0)
        zero_counts()
        es, outs = rollout(es, actions, generator=gen)          # warm-up
        torch.cuda.synchronize()
        ended = 0
        t0 = time.perf_counter()
        for _ in range(CHUNKS):
            es, outs = rollout(es, actions, generator=gen)
            ended += int((outs["done"] | outs["truncated"]).sum())
        torch.cuda.synchronize()
        return es, outs, time.perf_counter() - t0, ended, fs.launches, dict(fs.calls)

    es_h, outs, wall, ended, hover_launches, calls = timed_rollouts(roll, es)
    if hover_launches != CHUNK * (CHUNKS + 1) or calls["rollout"] != CHUNKS + 1 \
            or calls["step"]:
        fail(f"hover rollout: the kernel ran {hover_launches} steps in {calls}, "
             f"expected {CHUNK * (CHUNKS + 1)} steps in {CHUNKS + 1} T-step launches")
    # a blown-up env may emit one non-finite reward on the very step its
    # non-finite failsafe ends it; everywhere else the reward is finite, and
    # the state is finite always (a failed env is reset)
    checks = {"reward": torch.isfinite(outs["reward"]) | outs["failed"],
              "heli": torch.isfinite(es_h.heli.flatten()),
              "obs": torch.isfinite(es_h.obs), "wind": torch.isfinite(es_h.wind.flatten())}
    for name, ok in checks.items():
        if not bool(ok.all()):
            fail(f"hover rollout: {int((~ok).sum())} non-finite values in {name}")
    if outs["reward"].shape != (CHUNK, N_ENVS):
        fail(f"hover rollout: reward has shape {tuple(outs['reward'].shape)}")
    rate = N_ENVS * CHUNK * CHUNKS / wall
    hover_ended_frac = ended / (N_ENVS * CHUNK * CHUNKS)
    _, _, wall_1, _, launches_1, calls_1 = timed_rollouts(roll_1, es)
    if launches_1 != CHUNK * (CHUNKS + 1) or calls_1["step"] != launches_1:
        fail(f"hover, one launch per step: {launches_1} steps in {calls_1}")
    rate_1 = N_ENVS * CHUNK * CHUNKS / wall_1
    report["hover_path"] = {"env_steps_per_s": rate, "wall_s": wall,
                            "launches": hover_launches, "calls": calls,
                            "ended_frac": hover_ended_frac,
                            "one_launch_per_step": {"env_steps_per_s": rate_1,
                                                    "wall_s": wall_1}}
    print(f"[hover] {CHUNKS} x {CHUNK} steps at {N_ENVS} envs: {rate:.1f} "
          f"env-steps/s in {calls['rollout']} T-step launches ({hover_launches} "
          f"kernel steps); one launch per step: {rate_1:.1f} env-steps/s; ended "
          f"fraction {hover_ended_frac:.5f}")
    hover_env, hover_es, hover_actions = env, es_h, actions

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
    ts0 = learner.restore(ckpt, learner.init(task_ids=task_ids))
    # the graph replay against the eager loop, bit for bit, over two rollouts
    outs = {}
    for graphed in (True, False):
        gen = torch.Generator(device=env.device).manual_seed(1)
        ts, trajs = ts0, []
        for _ in range(2):
            ts, traj = learner.collect(ts, gen, graphed=graphed)
            trajs.append(traj)
        outs[graphed] = (fs.pack(ts.env_state)[0], trajs, gen.get_state())
    fields = ("obs", "action", "log_prob", "value", "reward", "terminated",
              "truncated", "v_boot", "failed", "succ_step", "task_oh")
    bits = bit_mismatches(outs[True][0], outs[False][0]) + sum(
        bit_mismatches(getattr(a, f), getattr(b, f))
        for a, b in zip(outs[True][1], outs[False][1]) for f in fields)
    same_gen = torch.equal(outs[True][2], outs[False][2])
    print(f"[check] collector: graph replay vs eager loop, 2 x {ROLLOUT_STEPS} steps "
          f"at {N_ENVS} envs: values differing {bits}, generator states equal "
          f"{same_gen}")
    if bits or not same_gen:
        fail("the graphed collector differs from the eager loop")

    def timed_collect(graphed):
        gen = torch.Generator(device=env.device).manual_seed(0)
        zero_counts()
        ts, traj = learner.collect(ts0, gen, graphed=graphed)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ended = 0.0
        for _ in range(ROLLOUTS):
            ts, traj = learner.collect(ts, gen, graphed=graphed)
            ended += float((traj.terminated + traj.truncated).clamp(max=1.0).sum())
        torch.cuda.synchronize()
        return ts, traj, time.perf_counter() - t0, ended, fs.launches, dict(fs.calls)

    def split(ts, graphed):
        """Device time per step of the step kernel and of everything else
        (the policy's kernels, copies), from one profiled rollout, which
        must have run the step kernel exactly ROLLOUT_STEPS times."""
        state = {"ts": ts}
        gen = torch.Generator(device=env.device).manual_seed(5)

        def one_rollout():
            state["ts"], _ = learner.collect(state["ts"], gen, graphed=graphed)
        saved, saved_calls = fs.launches, dict(fs.calls)
        times = kernel_times_ms(one_rollout, 1, warmup=1)
        fs.launches = saved
        fs.calls.update(saved_calls)
        is_step = lambda name: "fused_step_kernel" in name
        runs = sum(r["count"] for k, r in times.items() if is_step(k))
        print(f"[check] collector (graphed {graphed}): profiled rollout ran the step "
              f"kernel {runs:g} times, {ROLLOUT_STEPS} steps")
        if runs != ROLLOUT_STEPS:
            fail(f"collector (graphed {graphed}): one profiled rollout ran the step "
                 f"kernel {runs:g} times, not {ROLLOUT_STEPS}")
        kern = sum(r["ms"] for k, r in times.items() if is_step(k)) / ROLLOUT_STEPS * 1e3
        other = sum(r["ms"] for k, r in times.items() if not is_step(k)) / ROLLOUT_STEPS * 1e3
        n_other = sum(r["count"] for k, r in times.items() if not is_step(k)) / ROLLOUT_STEPS
        return kern, other, n_other

    report["collector"] = {}
    for graphed in (False, True):
        ts, traj, wall, ended, launches, calls = timed_collect(graphed)
        # graphed: one capture (a new generator), whose warm-up runs one step
        want = {"replay": ROLLOUTS + 1, "step": 0, "capture": 1} if graphed else \
            {"replay": 0, "step": ROLLOUT_STEPS * (ROLLOUTS + 1), "capture": 0}
        want_steps = ROLLOUT_STEPS * (ROLLOUTS + 1) + want["capture"]
        if launches != want_steps or any(calls[k] != v for k, v in want.items()):
            fail(f"collector (graphed {graphed}): the kernel ran {launches} steps in "
                 f"{calls}, expected {want_steps} steps, {want}")
        shapes = {"obs": (17,), "action": (4,), "task_oh": (n_tasks,)}
        for f in fields:
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
        kern_us, other_us, other_launches = split(ts, graphed)
        key = "graphed" if graphed else "eager"
        report["collector"][key] = {
            "env_steps_per_s": coll_rate, "wall_s": wall, "us_per_step": step_us,
            "launches": launches, "calls": calls, "ended_frac": coll_ended_frac,
            "task_mean_reward": task_reward,
            "succ_step_frac": float(traj.succ_step.mean()),
            "device_us_per_step": {"step_kernel": kern_us, "policy_and_copies": other_us},
            "other_device_launches_per_step": other_launches,
            "device_busy_frac": (kern_us + other_us) / step_us}
        print(f"[collector] {key}: {ROLLOUTS} x {ROLLOUT_STEPS} steps at {N_ENVS} envs: "
              f"{coll_rate:.1f} env-steps/s, {step_us:.1f} us per step = step kernel "
              f"{kern_us:.2f} us + policy and copies {other_us:.2f} us in "
              f"{other_launches:.1f} launches on the device (busy "
              f"{(kern_us + other_us) / step_us:.3f}); {launches} kernel steps in "
              f"{calls}; mean reward by task {task_reward}")
    coll_launches = report["collector"]["graphed"]["launches"]
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
        if fs.launches != 6 * steps or fs.calls["step"] != 6 * steps:
            fail(f"evaluation {name}: the kernel ran {fs.launches} steps in "
                 f"{fs.calls}, expected {6 * steps} one-step launches")
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
    def bound(n, ops_per_env, steps, ended_frac, mixed, held):
        """Least time per step of `steps` env steps of `n` envs in one launch:
        the carry in and out once, the held action and the task id once,
        per step the noise, two texel rows and the collect block, the init
        rows in the share of lanes that reset; or the elementwise
        operations at the fp32 peak, whichever is larger."""
        once = 2 * fs.CROWS * 4 + (fs.BYTES_TASK_ID if mixed else 0) + (16 if held else 0)
        per_step = (3 + 2 * 3) * 4 + (0 if held else 16) + fs.BYTES_COLLECT \
            + ended_frac * fs.BYTES_RESET
        bytes_step = n * (once / steps + per_step)
        t_bytes = bytes_step / HBM_BYTES_PER_S * 1e3
        t_ops = n * ops_per_env / FP32_OPS_PER_S * 1e3
        return {"bytes_per_step": bytes_step, "bound_ms_bytes": t_bytes,
                "bound_ms_ops": t_ops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def step_numbers(env, es, actions, ended_frac, mixed):
        """Device time, launch-loop time, plain time and bound of one-step
        launches; device time and bound per step of one T-step launch."""
        carry, init = fs.pack(es)
        eta = torch.randn((3, N_ENVS), device=dev) * 50.0 ** 0.5
        xbuf = torch.empty((fs.XROWS, N_ENVS), device=dev)
        kernel = lambda: fs.fused_step(env, carry, init, actions, eta,
                                       carry_out=carry, collect_out=xbuf)
        saved, saved_calls = fs.launches, dict(fs.calls)
        loop_ms = event_time_ms(kernel, 500)
        kernel_ms = device_time_ms(kernel, 100, "fused_step_kernel")
        eta_seq = torch.randn((CHUNK, 3, N_ENVS), device=dev) * 50.0 ** 0.5
        xseq = torch.empty((CHUNK, fs.XROWS, N_ENVS), device=dev)
        rollout = lambda: fs.fused_rollout(env, carry, init, actions, eta_seq,
                                           carry_out=carry, collect_out=xseq)
        rollout_ms = event_time_ms(rollout, 3, warmup=1) / CHUNK
        fs.launches = saved
        fs.calls.update(saved_calls)
        with torch.no_grad():
            plain = lambda: fs.fused_step_plain(env, carry, init, actions, eta)
            plain_ms = event_time_ms(plain, 10, warmup=1)
            ops_per_env = count_elementwise_ops(plain) / N_ENVS
        one = bound(N_ENVS, ops_per_env, 1, ended_frac, mixed, held=False)
        many = bound(N_ENVS, ops_per_env, CHUNK, ended_frac, mixed, held=True)
        return {"kernel_ms": kernel_ms if kernel_ms else loop_ms,
                "kernel_ms_source": "profiler" if kernel_ms else "cuda events",
                "loop_ms": loop_ms, "plain_ms": plain_ms,
                "elementwise_ops_per_env_step": ops_per_env, **one,
                "rollout_ms_per_step": rollout_ms,
                "rollout_bound": many}

    mixed_actions = learner.act_bias.expand(N_ENVS, 4).contiguous()
    report["numbers"] = {
        "hover": step_numbers(hover_env, hover_es, hover_actions,
                              hover_ended_frac, mixed=False),
        "mixed4": step_numbers(mixed_env, mixed_ts.env_state, mixed_actions,
                               report["collector"]["graphed"]["ended_frac"],
                               mixed=True)}
    for name, nb in report["numbers"].items():
        rb = nb["rollout_bound"]
        print(f"[time] {name}: one-step kernel {nb['kernel_ms'] * 1e3:.2f} us/launch "
              f"({nb['kernel_ms_source']}), {nb['loop_ms'] * 1e3:.2f} us per step in a "
              f"launch loop, bound {nb['bound_ms'] * 1e3:.3f} us ({nb['bound_by']}: "
              f"{nb['bytes_per_step']:.0f} B, {nb['elementwise_ops_per_env_step']:.0f} "
              f"elementwise ops/env); T-step launch {nb['rollout_ms_per_step'] * 1e3:.2f} "
              f"us per step, bound {rb['bound_ms'] * 1e3:.3f} us ({rb['bound_by']}: "
              f"{rb['bytes_per_step']:.0f} B per step); plain {nb['plain_ms']:.3f} ms/step")
    print(f"[time] hover rollout {rate:.1f} env-steps/s; collector graphed "
          f"{report['collector']['graphed']['env_steps_per_s']:.1f}, eager "
          f"{report['collector']['eager']['env_steps_per_s']:.1f} env-steps/s")

    # block sizes, at 4096 and 16384 envs (BLOCK set for the measurement)
    report["sweep"] = []
    sweep_envs = {"hover": (hover_env, None), "mixed4": (mixed_env, len(MIXED4))}
    for n in SWEEP_ENVS:
        for name, (env_s, n_sub) in sweep_envs.items():
            venv_s = VectorHeliEnv(env_s, n)
            tr_s = env_s.trim_result()
            es_s, _ = venv_s.reset_from_trim(tr_s)
            if n_sub:
                es_s = venv_s.assign_tasks(es_s, np.arange(n) % n_sub)
            carry, init = fs.pack(es_s)
            act = tr_s.action.to(dev).expand(n, 4).contiguous()
            eta = torch.randn((3, n), device=dev) * 50.0 ** 0.5
            eta_seq = torch.randn((SWEEP_STEPS, 3, n), device=dev) * 50.0 ** 0.5
            xbuf = torch.empty((fs.XROWS, n), device=dev)
            xseq = torch.empty((SWEEP_STEPS, fs.XROWS, n), device=dev)
            saved, saved_calls, kept = fs.launches, dict(fs.calls), fs.BLOCK
            try:
                for block in SWEEP_BLOCKS:
                    fs.BLOCK = block
                    c = carry.clone()
                    one = lambda: fs.fused_step(env_s, c, init, act, eta, carry_out=c,
                                                collect_out=xbuf)
                    many = lambda: fs.fused_rollout(env_s, c, init, act, eta_seq,
                                                    carry_out=c, collect_out=xseq)
                    row = {"envs": n, "task": name, "block": block,
                           "step_us": device_time_ms(one, 30, "fused_step_kernel") * 1e3,
                           "rollout_us_per_step":
                               event_time_ms(many, 3, warmup=1) / SWEEP_STEPS * 1e3}
                    report["sweep"].append(row)
                    print(f"[sweep] {n} envs, {name}, block {block}: one-step launch "
                          f"{row['step_us']:.2f} us, T-step launch "
                          f"{row['rollout_us_per_step']:.2f} us per step")
            finally:
                fs.BLOCK = kept
            fs.launches = saved
            fs.calls.update(saved_calls)

    nb = report["numbers"]["mixed4"]
    kernels = [{"name": fs.KERNEL, "route": "cuda",
                "source": "heligym_tpu_torch/csrc/fused_step.cu",
                "replaces": fs.REPLACES, "launches": coll_launches,
                "launches_by_path": {"hover_rollout": hover_launches,
                                     "collector": coll_launches,
                                     "evaluation": eval_launches},
                "max_abs_err": max_abs_err, "ms": nb["kernel_ms"],
                "plain_ms": nb["plain_ms"], "bound_ms": nb["bound_ms"],
                "bound_by": nb["bound_by"], "library_ms": None,
                "hover_ms": report["numbers"]["hover"]["kernel_ms"],
                "hover_bound_ms": report["numbers"]["hover"]["bound_ms"],
                "rollout_ms_per_step": nb["rollout_ms_per_step"],
                "rollout_bound_ms_per_step": nb["rollout_bound"]["bound_ms"],
                "hover_rollout_ms_per_step":
                    report["numbers"]["hover"]["rollout_ms_per_step"],
                "hover_rollout_bound_ms_per_step":
                    report["numbers"]["hover"]["rollout_bound"]["bound_ms"]}]
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
