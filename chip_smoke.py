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
     over the same inputs timed beside it and held equal to it; then
     `tools/torch_bench.py` at its defaults (4096 envs, 5 chunks of 500
     steps), its JSON line printed after "[bench]";
  4. the gather probe (tools/torch_exp_gather.py): each kernel against
     np.take_along_axis and, bit for bit, its plain version at every probe
     size, at (1024, 1022) (L % 4 != 0: gather_axis0's cp.async load,
     gather_axis1's scalar path) and, for gather_axis1, at (8, 32768) (rows
     over many column tiles), with its
     device time hot (inputs in L2), cold (after a 128 MB write) and cold
     with a clean L2 (a 128 MB read after the write) beside torch.gather's
     and the bound;
  5. the collector: the committed 4-task policy in the loop of 4096 envs,
     one warm-up and 5 rollouts of 64 steps through `PPOLearner.collect`,
     each one CUDA graph replay; the eager loop timed beside it and held
     equal to it bit for bit;
  5b. the train step: stage 1 of hover4k (examples/hover4k_training_
     metrics.json: 4096 envs x 64 steps, 4 epochs x 8 minibatches, lr 1e-4
     annealed over 200 updates, critic warm-up 30, frozen obs stats),
     resumed from examples/hover4k_policy.npz (params, Adam, obs stats and
     its 4096-env farm) with the schedules reset: 1 warm-up and 3 timed
     `train_step`s split into collect (the graph replay) and update (GAE +
     epochs) by CUDA events, one profiled step for the device-busy share;
     the critic must move and the actor (warm-up) must not; one update
     repeated on the CPU from the same rollout, parameters and shuffles,
     held to the card's; save -> restore bit-equal; then `train()` for 2
     updates from the checkpoint, as a user resumes a run;
  5c. randomized resets and the trainer CLI: the batched Newton trim on the
     card for 2048 start altitudes of the landing band (6-55 ft) and three
     forward-flight conditions, held against the same solve on the CPU; a
     2048-env farm from `reset_randomized` through the kernel against its
     plain version bit for bit (30 steps and a 300-step dive whose ended
     envs must get their own snapshots back), then the same without
     auto-reset (`auto_reset=False`, the mode of every evaluator and
     collector; in the dive every env ends and integrates on past its end),
     every carry and collect value at every step equal bit for bit; the
     graphed collector against
     the eager loop from that farm with examples/landing_band_policy.npz;
     then `python -m heligym_tpu_torch.learner.train` (its `main`) for 2
     updates of the committed examples/landing_band_training_metrics.json
     config, with the start-band evaluation after each update, each update
     timed on the host clock split into the train step and the evaluation;
  6. the evaluator: `multi_seed_evaluate` of the committed multitask4,
     hover4k and landing_band (on the 6-55 ft start grid) policies beside
     their committed scores;
  6b. distillation, each run at the committed widths with its rounds cut,
     timed on the host clock to a synchronize: (a) the scripted expert
     (`tools/torch_tune_scripted.py`, 3 seeds of the 128-point 6-100 ft
     grid, mean success at least 0.89); (b) `python -m
     heligym_tpu_torch.learner.distill` (its `main`) from
     examples/landing_band_policy.npz at the committed stage-1 widths,
     1 round: round 0 within 0.06 of the committed evaluation, steps
     cloned, a finite loss, the critic and log_std bit-equal, `.best.npz`
     readable; (c) `tools/torch_distill_scripted.py` from
     examples/landing100_policy.npz, 1 BC and 1 DAgger round: round 0
     within 0.06 of the committed evaluation, the expert's acting success at
     least 0.80, the DAgger weights on every step before each env's end;
     (d) `tools/torch_distill_multitask.py` on the committed multitask4
     config with 1 DAgger round: round 0 success at least 0.88; (e)
     `tools/torch_distill_hybrid.py`, 1 round, the landing_band policy as
     both experts (mechanics only). Every collection and evaluation step
     must run on the step kernel, and each run must time exactly the fits
     and evaluations its rounds make;
  7. numbers: the step kernel's device time per step, one-step and T-step
     launches, beside their bounds and the plain version; the block sizes
     at 4096 and 16384 envs, each timed from a fresh carry that every
     launch reads and none overwrites, its outputs held bit for bit against
     the kept block's;
  8. the gymnasium surfaces and the renderer feed: `HeliEnv.reset` and
     `heli_step` on the card against the CPU (within 1e-5 of each field's
     scale); for each of the seven gymnasium ids the facade's core
     (`envs/gym_core.py::SingleCore`: the card's machine has no gymnasium,
     and `gym_api`'s classes are thin over it) reset and stepped 200 times with the
     trim action, every step one kernel launch, its carry and collect block
     at 4 steps held bit for bit against the plain version from the same
     carry and noise, steps/s on the host clock; `BatchCore` (the
     `HeliVectorGymEnv` core) at 4096 envs from `reset(seed=0)` diving
     (collective -1) until every env has ended, each ended env's final obs
     bit-equal to the plain version's rows 22-38 and its returned obs its
     snapshot's, env-steps/s; the native renderer built with g++ from the
     JAX package's C++ sources (it must build) and one native and one
     top-down frame of the card state, each equal to a fresh renderer's
     frame of the state's CPU copy, ms per frame;
  9. multi-device (`tools/torch_sharded_step.py`): the train step of 5b
     sharded over ranks by `heligym_tpu_torch.parallel`, one step compared
     and one timed: without a mesh in this process (the reference); (a)
     one NCCL rank on cuda:0 in this process, held against the reference;
     (b) two gloo ranks spawned on the same card (NCCL takes one rank per
     card), 2048 envs each, each rank's rollout against its columns of
     (a)'s (discrete streams exactly, floats at tests/test_sharding.py's
     tolerances), parameters and Adam's moments within 1e-4 of their
     scale, the metrics, `farm_metrics`, the generators' states, and a
     2-rank save restored in one process bit-equal; per rank, collect,
     update and its all-reduces by CUDA events;
  10. a user airframe with a wing: `aw109_wing` (aw109 with a wing of five
     times its horizontal tail's coefficients, at the centre of gravity)
     written into build/chip_smoke/models/ and registered with
     `register_model_path`; hover and the 4-task MixedTask built on it at
     4096 envs from the port's host trim; the kernels' winged instantiation
     held bit for bit against the plain version (hover: 30 steps and the
     300-step dive with and without auto-reset; mixed4: 30 steps and the
     dive), in one-step and T-step launches at every block size; one
     graphed `PPOLearner.collect` of 64 steps and one `train_step` with
     examples/hover4k_policy.npz's parameters on a fresh winged farm; the
     rollout demo's work (examples/torch_rollout_demo.py, one T-step launch
     of 500 steps); one `trace` of 3 collector steps, which must name the
     winged step kernel; the winged launches timed beside their bounds;
then one JSON line describing each kernel.
Before each path (3, the bench, 4, 5, 5b, 5c, 6, each run of 6b, 8, 9, 10) every kernel's counts are set
to 0, and read just after; a path whose kernel never ran fails the script. The step
kernel's count is of env steps it ran: a T-step launch or a graph replay of
T steps counts T, a graph capture 1 (its warm-up launch); the profiled
collector rollout must show exactly T step-kernel executions. The last
line is {"ok": true, "device": {...}}; the line
starting "[report]" holds every measured number as JSON. The host trims
are cached under build/chip_smoke/trim_cache, emptied at the start, so
every trim of a run is solved by the checkout's own code.
"""
import contextlib
import copy
import importlib.util
import io
import json
import os
import shutil
import sys
import time
import types

import numpy as np

N_ENVS = 4096
CHUNK = 500
CHUNKS = 2
ROLLOUT_STEPS = 64
ROLLOUTS = 5
TRAIN_STEPS = 3                # timed train steps, after one warm-up
TRAIN_TOL = 1e-4               # card vs CPU update, relative to each tensor's scale
SWEEP_ENVS = (4096, 16384)
SWEEP_BLOCKS = (32, 64, 128)
SWEEP_STEPS = 200
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = {"reward_atol": 2e-5, "state_rtol": 2e-4, "state_atol": 2e-4,
       "obs_rtol": 1e-4, "obs_atol": 2e-3}
EVAL_MARGIN = 0.03             # a per-head success mean may lie this far below
MIXED4 = ("hover", "forward", "turning", "oblique")
BAND = (6.0, 55.0)             # the landing band's start altitudes [ft above ground]
BAND_ENVS = 2048               # examples/landing_band_policy.npz's farm
BAND_CPU_ENVS = 64             # band envs whose trim is repeated on the CPU
TRIM_TOL = 5e-3                # card vs CPU trim: state over max(|CPU|, 1), action
CLI_MARGIN = 0.06              # one fixed-noise evaluation after 1-2 updates at lr 3e-5
LANDING_BAND = "landing_band"
DISTILL_MARGIN = 0.06          # round 0: one fixed-noise evaluation of a committed policy
TUNE_GATE = 0.89               # the scripted expert: documented 0.926 +- 0.01 on 3 x 128
BC_ACTING_GATE = 0.80          # the expert's acting success in a BC round (committed 0.855-0.874)
MULTITASK_GATE = 0.88          # multitask4's round 0 (committed 0.9375)
GYM_TOL = 1e-5                 # heli_step card vs CPU, over each field's scale
GYM_STEPS = 200                # steps of each id's single env
GYM_CHECK = (0, 1, 100, 199)   # its steps held bit for bit against the plain version
GYM_DIVE_MAX = 600             # the vector env's dive ends before this
GYM_FRAMES = 5                 # frames timed per renderer
TRACE_STEPS = 3                # collector steps in phase 10's trace
# the committed policies scored in phase 6; `heads` are the gated ones
EVALS = {
    "multitask4": dict(tasks=",".join(MIXED4), task="hover",
                       target="sea_alt=start,vel=60", episodes=512, heads=("mean",)),
    "hover4k": dict(tasks=None, task="hover", target="sea_alt=start",
                    episodes=256, heads=("mean",)),
    LANDING_BAND: dict(tasks=None, task="landing", target="touch_alt=ground",
                       episodes=256, start_band=BAND, heads=("mean", "stochastic")),
}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


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
    def load_tool(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, "tools", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    try:
        from heligym_tpu_torch.envs import (ForwardFlightTask, HeliEnv, HoverTask,
                                            LandingTask, MixedTask,
                                            ObliqueFlightTask, SlalomTask,
                                            TurningFlightTask, VectorHeliEnv)
        from heligym_tpu_torch.learner import PPOConfig, PPOLearner
        from heligym_tpu_torch.learner import evaluate as evaluate_mod, train as train_cli
        from heligym_tpu_torch.learner.evaluate import build_env, multi_seed_evaluate
        from heligym_tpu_torch.envs.trim import trim_batched
        from heligym_tpu_torch.ops import dryden
        from heligym_tpu_torch.utils.constants import EPS
        from heligym_tpu_torch.ops.cuda import build, fused_step as fs, gather
        from heligym_tpu_torch.utils.profiling import (device_time_ms, event_time_ms,
                                                       kernel_times_ms)
        from heligym_tpu_torch.learner.ppo import TrainState
        probe = load_tool("torch_exp_gather")
        bench = load_tool("torch_bench")
    except (ImportError, OSError) as e:
        fail(f"the port is not beside this script ({e}); run it from a checkout")
    # every trim of this run is solved by this checkout's code
    trim_cache = os.path.join(here, "build", "chip_smoke", "trim_cache")
    shutil.rmtree(trim_cache, ignore_errors=True)
    os.environ["HELIGYM_TPU_TORCH_CACHE"] = trim_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": train_cli.card_line() or "unknown", "torch": torch.__version__,
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

    def inputs(action, n, steps, dive):
        """Actions around `action` ((4,), or (n, 4) per env) and noise for
        `steps` steps of n envs."""
        act = np.tile(np.broadcast_to(action.cpu().numpy(), (n, 4)), (steps, 1, 1))
        act = (act + 0.02 * rng.standard_normal(act.shape)).astype(np.float32)
        if dive:
            act[..., 0] = -1.0
        eta = (rng.standard_normal((steps, 3, n)) * 50.0 ** 0.5).astype(np.float32)
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

    def nan_bit_mismatches(a, b):
        """Values whose bits differ; a NaN facing a NaN counts equal."""
        both = torch.isnan(a) & torch.isnan(b)
        return int(((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32))
                    & ~both).sum())

    def compare(env, es, tr, steps, dive, auto_reset=True):
        """Kernel and plain version side by side from `es`; the nominal run
        asserts the parity tolerances at every step, the dive only compares
        the discrete streams (a NaN reward equals a NaN reward). Then the
        same inputs through one T-step launch, against the one-step
        launches. With `auto_reset`, on the step an env ends, the kernel
        must have put back its own snapshot's rows. `bits` counts the
        values of the carry and the collect block, over every step, whose
        bits differ between kernel and plain."""
        act, eta = inputs(tr.action, es.steps.shape[0], steps, dive)
        ck, init = fs.pack(es)
        c0, cp = ck.clone(), ck.clone()
        err = {"reward": 0.0, "obs": 0.0, "state": 0.0, "one_launch": 0.0,
               "resets": 0, "snapshot_bits": 0, "bits": 0}
        close = lambda a, b, rtol, atol: torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol, equal_nan=True)
        xs_k, dones_p = [], []
        first_end = torch.full((ck.shape[1],), -1, dtype=torch.int64, device=dev)
        with torch.no_grad():
            for t in range(steps):
                ck, xk = fs.fused_step(env, ck, init, act[t], eta[t], auto_reset)
                cp, xp = fs.fused_step_plain(env, cp, init, act[t], eta[t], auto_reset)
                if t == 0:
                    err["one_launch"] = max(diff(ck, cp), diff(xk, xp))
                    if not torch.equal(torch.isnan(xk), torch.isnan(xp)):
                        fail("NaN patterns differ after one launch")
                err["reward"] = max(err["reward"], diff(xk[fs.CREW], xp[fs.CREW]))
                err["obs"] = max(err["obs"],
                                 diff(xk[fs.COBS0:fs.CSUCC], xp[fs.COBS0:fs.CSUCC]),
                                 diff(xk[fs.CFINAL0:], xp[fs.CFINAL0:]))
                err["state"] = max(err["state"], diff(ck[:fs.SROWS], cp[:fs.SROWS]))
                err["bits"] += nan_bit_mismatches(ck, cp) + nan_bit_mismatches(xk, xp)
                ended = (xk[fs.CDONE] != 0) | (xk[fs.CTRUNC] != 0)
                err["resets"] += int(ended.sum())
                first_end = torch.where((first_end < 0) & ended, t, first_end)
                if auto_reset:
                    err["snapshot_bits"] += bit_mismatches(ck[:fs.SROWS][:, ended],
                                                           init[:fs.SROWS][:, ended])
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
            if not auto_reset:
                err["envs_ended"] = int((first_end >= 0).sum())
                err["steps_past_end"] = int(torch.where(first_end >= 0, steps - 1 - first_end,
                                                        0).sum())
            c, x = fs.fused_rollout(env, c0.clone(), init, act, eta, auto_reset)
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
            print(f"[check] {label}: kernel vs plain, {steps} step(s) at {es.steps.shape[0]} "
                  f"envs: max |err| reward {err['reward']:.3e} obs {err['obs']:.3e} "
                  f"state {err['state']:.3e}")
            check_forms(label, steps, forms)
        err, dk, dp, ck, cp, forms = compare(env, es, tr, 300, dive=True)
        mismatch = int((dk != dp).sum())
        out["dive_300"] = {**err, "done_frac": float(dk.mean()),
                           "done_mismatch": mismatch, "forms": forms}
        print(f"[check] {label}: dive 300 steps: done fraction "
              f"{float(dk.mean()):.4f}, mismatched done flags {mismatch}, "
              f"{err['resets']} resets, snapshot rows differing {err['snapshot_bits']}")
        check_forms(label + " dive", 300, forms)
        if err["snapshot_bits"]:
            fail(f"{label}: an env that ended did not get its snapshot back")
        if not bool(dk.any()):
            fail(f"{label}: the dive never terminated")
        if mismatch:
            fail(f"{label}: {mismatch} done flags differ between kernel and plain")
        if not torch.equal(ck[fs.STEPS:], cp[fs.STEPS:]):
            fail(f"{label}: dive counters differ between kernel and plain")
        if not bool((ck[fs.STEPS] < 300).all()):
            fail(f"{label}: dive counters did not reset")
        return out

    def check_no_reset(label, env, es, tr):
        """The kernel against its plain version with auto_reset=False, the
        mode of every evaluator and collector: 30 nominal steps, then the
        300-step dive, in which every env ends and integrates on past its
        end. Every value of the carry and the collect block at every step
        must equal the plain version's bit for bit (a NaN facing a NaN
        counts equal), and the T-step launch the one-step launches."""
        out = {}
        for steps, dive in ((30, False), (300, True)):
            err, dk, dp, ck, cp, forms = compare(env, es, tr, steps, dive,
                                                 auto_reset=False)
            key = f"{'dive' if dive else 'nominal'}_{steps}"
            past = err["steps_past_end"]
            mismatch = int((dk != dp).sum())
            counters = torch.equal(ck[fs.STEPS:], cp[fs.STEPS:])
            out[key] = {**err, "done_mismatch": mismatch, "counters_equal": counters,
                        "forms": forms}
            print(f"[check] {label}, auto_reset=False: kernel vs plain, {steps} steps "
                  f"at {es.steps.shape[0]} envs{' (dive)' if dive else ''}: bits "
                  f"differing in carry and collect {err['bits']}, max |err| reward "
                  f"{err['reward']:.3e} obs {err['obs']:.3e} state {err['state']:.3e}; "
                  f"{err['envs_ended']} envs ended, {past} env-steps past their end, "
                  f"mismatched done flags {mismatch}, counters equal {counters}")
            check_forms(f"{label}, auto_reset=False{' dive' if dive else ''}", steps, forms)
            if err["bits"] or mismatch or not counters:
                fail(f"{label}, auto_reset=False: the kernel differs from its plain "
                     f"version over {steps} steps")
            if dive and past == 0:
                fail(f"{label}, auto_reset=False: no env ran past its end in the dive")
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

    # the torch counterpart of bench.py, at its defaults, in this process
    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main([])
    bench_line = out.getvalue().strip().splitlines()[-1]
    bench_launches, bench_calls = fs.launches, dict(fs.calls)
    report["torch_bench"] = {**json.loads(bench_line), "launches": bench_launches,
                             "calls": bench_calls}
    print(f"[bench] {bench_line}")
    if bench_launches != 500 * 6 or bench_calls["rollout"] != 6:
        fail(f"torch_bench: the kernel ran {bench_launches} steps in {bench_calls}, "
             f"expected 3000 steps in 6 T-step launches")

    # ---- 4. the gather probe ---------------------------------------------------
    zero_counts()
    rows = probe.run_probe()
    gather_launches = dict(gather.launches)
    report["gather"] = rows
    for r in rows:
        if (not (r["correct"] and r["equal_plain"] and r["covers"])
                or r["max_abs_err"] != 0.0):
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
    ts0 = learner.restore(ckpt).replace(
        env_state=learner.init(task_ids=task_ids).env_state)
    fields = ("obs", "action", "log_prob", "value", "reward", "terminated",
              "truncated", "v_boot", "failed", "succ_step", "task_oh")

    def graph_vs_eager(label, learner, ts0):
        """The graph replay against the eager loop, bit for bit, over two
        rollouts from `ts0`."""
        outs = {}
        for graphed in (True, False):
            gen = torch.Generator(device=dev).manual_seed(1)
            ts, trajs = ts0, []
            for _ in range(2):
                ts, traj = learner.collect(ts, gen, graphed=graphed)
                trajs.append(traj)
            outs[graphed] = (fs.pack(ts.env_state)[0], trajs, gen.get_state())
        bits = bit_mismatches(outs[True][0], outs[False][0]) + sum(
            bit_mismatches(getattr(a, f), getattr(b, f))
            for a, b in zip(outs[True][1], outs[False][1]) for f in fields)
        same_gen = torch.equal(outs[True][2], outs[False][2])
        n = ts0.env_state.steps.shape[0]
        print(f"[check] {label}: graph replay vs eager loop, 2 x {ROLLOUT_STEPS} steps "
              f"at {n} envs: values differing {bits}, generator states equal "
              f"{same_gen}")
        if bits or not same_gen:
            fail(f"{label}: the graphed collector differs from the eager loop")
        return {"values_differing": bits, "generator_states_equal": same_gen}

    graph_vs_eager("collector", learner, ts0)

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

    # ---- 5b. the train step ----------------------------------------------------
    train_cfg = PPOConfig(num_envs=N_ENVS, rollout_steps=ROLLOUT_STEPS, minibatches=8,
                          epochs=4, lr=1e-4, ent_coef=1e-3, gamma=0.99,
                          anneal_updates=200, shuffle="perm", freeze_obs_stats=True,
                          success_bonus=1.0, fail_penalty=5.0, vf_clip_eps=0.0,
                          target_kl=0.0, critic_warmup=30)
    env, _ = build_env("hover", None, "sea_alt=start")
    trainer = PPOLearner(env, train_cfg)
    hover4k = os.path.join(here, "examples", "hover4k_policy.npz")
    zero_counts()
    # a same-size resume of the whole TrainState, the schedules reset
    ts = trainer.restore(hover4k, trainer.init(torch.Generator().manual_seed(5))
                         ).replace(update_count=0)
    if ts.env_state.steps.shape != (N_ENVS,) or int(ts.opt_state.count) == 0:
        fail("train: the checkpoint's farm or Adam state did not come back")
    actor = lambda net: [p for n, _, p in net.flax_leaves() if n in net.actor_flax_names()]
    critic = lambda net: [p for n, _, p in net.flax_leaves()
                          if n not in net.actor_flax_names()]
    actor0 = [p.detach().clone() for p in actor(ts.params)]
    critic0 = [p.detach().clone() for p in critic(ts.params)]
    rows = []
    for i in range(1 + TRAIN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ev[0].record()
        ts, traj = trainer.collect(ts, ts.generator)   # train_step: collect + update
        ev[1].record()
        ts, metrics = trainer.update(ts, traj)
        ev[2].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        if i:
            rows.append({"wall_ms": wall * 1e3, "collect_ms": ev[0].elapsed_time(ev[1]),
                         "update_ms": ev[1].elapsed_time(ev[2])})
    with torch.no_grad():
        gae_ms = event_time_ms(lambda: trainer._gae(traj), 10, warmup=2)

    def profiled_step():
        nonlocal ts
        ts, _ = trainer.train_step(ts)
    times = kernel_times_ms(profiled_step, 1, warmup=1)   # two more train steps
    device_ms = sum(r["ms"] for r in times.values())
    step_kernel_ms = sum(r["ms"] for k, r in times.items() if "fused_step_kernel" in k)
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    train = {"steps": rows, "wall_ms": mean("wall_ms"), "collect_ms": mean("collect_ms"),
             "update_ms": mean("update_ms"), "gae_ms": gae_ms,
             "minibatch_ms": (mean("update_ms") - gae_ms) / (train_cfg.epochs
                                                            * train_cfg.minibatches),
             "device_ms_per_step": device_ms, "step_kernel_ms_per_step": step_kernel_ms,
             "device_launches_per_step": sum(r["count"] for r in times.values()),
             "device_busy_frac": device_ms / mean("wall_ms"),
             "metrics": {k: float(v) for k, v in metrics.items()}, "card": report["card"]}
    for k, v in train["metrics"].items():
        if not np.isfinite(v):
            fail(f"train: metric {k} is {v}")
    for p in trainer.param_list(ts.params):
        if not bool(torch.isfinite(p).all()):
            fail("train: a non-finite parameter")
    if train["metrics"]["lr"] <= 0 or all(torch.equal(a, b) for a, b in
                                          zip(critic0, critic(ts.params))):
        fail("train: the critic did not move while lr > 0")
    if ts.update_count > train_cfg.critic_warmup or not all(
            torch.equal(a, b) for a, b in zip(actor0, actor(ts.params))):
        fail("train: the actor moved during the critic warm-up")
    # one collection per step (1 warm-up, the timed ones, the profile's
    # warm-up and profiled step) and one capture (the restored generator)
    n_collect = 1 + TRAIN_STEPS + 2
    train_launches, train_calls = fs.launches, dict(fs.calls)
    train["launches"], train["calls"] = train_launches, train_calls
    if train_launches == 0 or train_calls["replay"] != n_collect or \
            train_launches != ROLLOUT_STEPS * n_collect + train_calls["capture"]:
        fail(f"train: the step kernel ran {train_launches} steps in {train_calls}, "
             f"expected {n_collect} replays of {ROLLOUT_STEPS}")
    print(f"[train] hover4k stage 1 at {N_ENVS} envs x {ROLLOUT_STEPS} steps, "
          f"{train_cfg.epochs} epochs x {train_cfg.minibatches} minibatches, on "
          f"{report['card']}")
    print(f"[train] {train['wall_ms'] * 1e3:.1f} us per train step (host clock, "
          f"{TRAIN_STEPS} steps): collect {train['collect_ms'] * 1e3:.1f} us (graph "
          f"replay), update {train['update_ms'] * 1e3:.1f} us (GAE "
          f"{gae_ms * 1e3:.1f} us + {train_cfg.epochs * train_cfg.minibatches} "
          f"minibatch steps of {train['minibatch_ms'] * 1e3:.1f} us) by CUDA events")
    print(f"[train] device busy {train['device_busy_frac']:.3f}: "
          f"{device_ms * 1e3:.1f} us of device time in "
          f"{train['device_launches_per_step']:.0f} launches per step (step kernel "
          f"{step_kernel_ms * 1e3:.1f} us); {train_launches} step-kernel steps in "
          f"{train_calls}")
    print(f"[train] approx_kl {train['metrics']['approx_kl']:.6g}, loss "
          f"{train['metrics']['loss']:.6g}, v_loss {train['metrics']['v_loss']:.6g}, "
          f"lr {train['metrics']['lr']:.6g}, reward_mean "
          f"{train['metrics']['reward_mean']:.6g}")

    # one update on the card and the same update on the CPU: the same
    # rollout, parameters, Adam state and shuffles
    ts, traj = trainer.collect(ts, ts.generator)
    n = ROLLOUT_STEPS * N_ENVS
    perms = [torch.randperm(n, generator=torch.Generator().manual_seed(e))
             for e in range(train_cfg.epochs)]
    cpu_env, _ = build_env("hover", None, "sea_alt=start", device="cpu")
    cpu_trainer = PPOLearner(cpu_env, train_cfg)
    to_cpu = lambda x: x.detach().cpu()
    ts_cpu = TrainState(params=copy.deepcopy(ts.params).cpu(), env_state=None,
                        update_count=ts.update_count,
                        obs_stats=type(ts.obs_stats)(*(to_cpu(getattr(ts.obs_stats, f))
                                                       for f in ("mean", "var", "count"))),
                        opt_state=type(ts.opt_state)(to_cpu(ts.opt_state.count),
                                                     [to_cpu(m) for m in ts.opt_state.mu],
                                                     [to_cpu(v) for v in ts.opt_state.nu]))
    traj_cpu = traj.map(to_cpu)
    ts, m_card = trainer.update(ts, traj, idx=[p.to(dev) for p in perms])
    t0 = time.perf_counter()
    ts_cpu, m_cpu = cpu_trainer.update(ts_cpu, traj_cpu, idx=perms)
    cpu_s = time.perf_counter() - t0

    def rel_err(a, b):
        """max |a - b| over the tensor's largest magnitude."""
        a, b = a.detach().cpu(), b.detach()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    errs = {"params": max(rel_err(a, b) for a, b in zip(
                trainer.param_list(ts.params), cpu_trainer.param_list(ts_cpu.params))),
            "mu": max(rel_err(a, b) for a, b in zip(ts.opt_state.mu, ts_cpu.opt_state.mu)),
            "nu": max(rel_err(a, b) for a, b in zip(ts.opt_state.nu, ts_cpu.opt_state.nu))}
    count_equal = int(ts.opt_state.count) == int(ts_cpu.opt_state.count)
    train["one_update_check"] = {"rel_err": errs, "tol": TRAIN_TOL, "cpu_s": cpu_s,
                                 "count_equal": count_equal,
                                 "card_metrics": {k: float(v) for k, v in m_card.items()},
                                 "cpu_metrics": {k: float(v) for k, v in m_cpu.items()}}
    print(f"[check] train: one update ({train_cfg.epochs} epochs) on the card vs the "
          f"CPU ({cpu_s:.1f} s), same rollout and shuffles: max error relative to each "
          f"tensor's scale: params {errs['params']:.3e}, mu {errs['mu']:.3e}, nu "
          f"{errs['nu']:.3e} (tolerance {TRAIN_TOL:g}); Adam counts equal {count_equal}; "
          f"loss {float(m_card['loss']):.6g} / {float(m_cpu['loss']):.6g}")
    if not count_equal or max(errs.values()) > TRAIN_TOL:
        fail("train: the card's update differs from the CPU's")

    # save -> restore
    ckpt_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "train.npz")
    trainer.save(path, ts)
    back = trainer.restore(path, ts)
    same = (all(torch.equal(a, b) for a, b in zip(trainer.param_list(ts.params),
                                                  trainer.param_list(back.params)))
            and torch.equal(ts.opt_state.count, back.opt_state.count)
            and all(torch.equal(a, b) for a, b in zip(ts.opt_state.mu + ts.opt_state.nu,
                                                      back.opt_state.mu + back.opt_state.nu))
            and all(torch.equal(getattr(ts.obs_stats, f), getattr(back.obs_stats, f))
                    for f in ("mean", "var", "count"))
            and torch.equal(fs.pack(ts.env_state)[0], fs.pack(back.env_state)[0])
            and torch.equal(ts.generator.get_state(), back.generator.get_state())
            and back.update_count == ts.update_count)
    print(f"[check] train: save -> restore: parameters, Adam state, obs stats, farm "
          f"and generator bit-equal {same}")
    if not same:
        fail("train: save -> restore did not give the state back")

    # the training loop, as a user resumes hover4k's stage 1
    zero_counts()
    ts_loop, history = trainer.train(torch.Generator().manual_seed(6), num_updates=2,
                                     log_every=1, resume_from=hover4k,
                                     reset_schedules=True,
                                     checkpoint_path=os.path.join(ckpt_dir, "loop.npz"))
    train["loop"] = {"history": history, "launches": fs.launches}
    if len(history) != 2 or not all(np.isfinite(v) for h in history for v in h.values()) \
            or fs.launches == 0 or ts_loop.update_count != 2:
        fail(f"train(): history {history}, {fs.launches} step-kernel steps")
    print(f"[train] train(): 2 updates from {os.path.basename(hover4k)}, "
          f"{fs.launches} step-kernel steps, checkpoint written")
    report["train"] = train

    # ---- 5c. randomized resets and the trainer CLI --------------------------------
    zero_counts()
    band = {}
    sampler = train_cli.make_alt_band_sampler(*BAND)
    env, _ = build_env("landing", None, "touch_alt=ground")
    conds = sampler(torch.Generator(device=dev).manual_seed(7), BAND_ENVS)
    # the three conditions of tests/test_trim.py's batched check after the band
    extra = {"ned_vel": torch.tensor([[0.0, 0.0, 0.0], [50.0, 0.0, 0.0],
                                      [100.0, 10.0, 0.0]], device=dev),
             "gr_alt": torch.tensor([100.0, 1000.0, 3000.0], device=dev)}
    conds = {k: torch.cat([v, extra[k] if k in extra else torch.zeros_like(v[:3])])
             for k, v in conds.items()}
    wind = dryden.mean_wind(env.wind_params, device=dev)
    trim_ms = []
    for _ in range(2):                      # the first call pays the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve = trim_batched(env.params, env.terrain, wind, conds)
        torch.cuda.synchronize()
        trim_ms.append((time.perf_counter() - t0) * 1e3)
    above = int((solve.sq_residual[:BAND_ENVS] > EPS).sum())
    above_extra = int((solve.sq_residual[BAND_ENVS:] > EPS).sum())
    pick = torch.cat([torch.arange(BAND_CPU_ENVS), torch.arange(BAND_ENVS, BAND_ENVS + 3)])
    cpu = trim_batched(env.params, env.terrain.to("cpu"), wind.cpu(),
                       {k: v.cpu()[pick] for k, v in conds.items()})
    ref = cpu.result.state.flatten()
    scale = ref.abs().clamp(min=1.0)
    state_err = float(((solve.result.state.flatten().cpu()[pick] - ref) / scale).abs().max())
    action_err = float((solve.result.action.cpu()[pick] - cpu.result.action).abs().max())
    band["trim"] = {"envs": BAND_ENVS + 3, "ms": trim_ms[-1], "first_call_ms": trim_ms[0],
                    "iterations": solve.iterations, "band_above_eps": above,
                    "extra_above_eps": above_extra,
                    "max_sq_residual": float(solve.sq_residual.max()),
                    "cpu_envs": len(pick), "cpu_iterations": cpu.iterations,
                    "state_err_vs_cpu": state_err, "action_err_vs_cpu": action_err}
    print(f"[trim] batched Newton on the card, {BAND_ENVS} band conditions "
          f"({BAND[0]:g}-{BAND[1]:g} ft) + 3 of tests/test_trim.py: {trim_ms[-1]:.1f} ms "
          f"(first call {trim_ms[0]:.1f} ms), {solve.iterations} iterations; envs above "
          f"EPS: band {above}, others {above_extra}; max squared residual "
          f"{band['trim']['max_sq_residual']:.3e}")
    print(f"[check] trim: card vs CPU, {len(pick)} envs: max |state| error over "
          f"max(|CPU|, 1) {state_err:.3e}, max |action| error {action_err:.3e} "
          f"(tolerance {TRIM_TOL:g})")
    if above or above_extra:
        fail(f"trim: {above + above_extra} envs end with a residual above EPS")
    if max(state_err, action_err) > TRIM_TOL:
        fail("trim: the card's batched trim differs from the CPU's")

    # the randomized farm through the kernel, against its plain version; a 5 s
    # episode wall makes every env that the dive does not crash reset too
    env_k = env.replace(max_time=5.0)
    es, _ = VectorHeliEnv(env_k, BAND_ENVS).reset_randomized(
        torch.Generator(device=dev).manual_seed(7), sampler)
    farm_actions = types.SimpleNamespace(action=solve.result.action[:BAND_ENVS])
    # launches that hold the kernel against its plain version are not the
    # path's: its counts are put back after them
    saved, saved_calls = fs.launches, dict(fs.calls)
    band["kernel"] = check_task("landing band farm", env_k, es, farm_actions, (30,))
    for k, res in band["kernel"].items():
        worst = max(res["reward"], res["obs"], res["state"], res["one_launch"])
        if worst != 0.0:
            fail(f"landing band farm: the kernel differs from its plain version "
                 f"({k}: max |err| {worst})")
    if band["kernel"]["dive_300"]["resets"] == 0:
        fail("landing band farm: no env reset in the dive")
    max_abs_err = max(max_abs_err, *(band["kernel"]["nominal_30"][k]
                                     for k in ("reward", "obs", "state")))
    # the same farm without auto-reset, as every evaluator and collector
    # steps it
    band["kernel_no_reset"] = check_no_reset("landing band farm", env_k, es,
                                             farm_actions)
    fs.launches = saved
    fs.calls.update(saved_calls)

    # the graphed collector from that farm, with the committed band policy
    band_learner = PPOLearner(env, PPOConfig(num_envs=BAND_ENVS, rollout_steps=ROLLOUT_STEPS))
    es, _ = band_learner.venv.reset_randomized(torch.Generator(device=dev).manual_seed(7),
                                               sampler)
    band_ts = band_learner.restore(os.path.join(here, "examples", "landing_band_policy.npz")
                                   ).replace(env_state=es)
    band["collector"] = graph_vs_eager("landing band collector", band_learner, band_ts)

    # the trainer's command line on the committed config, 2 updates
    with open(os.path.join(here, "examples", "landing_band_training_metrics.json")) as f:
        config = json.load(f)["config"]
    ckpt_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    config.update(updates=2, eval_every=1, fresh_farm=True, resume_num_envs=None,
                  resume=os.path.join(here, config["resume"]),
                  checkpoint=os.path.join(ckpt_dir, "landing_band.npz"),
                  metrics_out=os.path.join(ckpt_dir, "landing_band_metrics.json"))
    argv = []
    for k, v in config.items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        elif v is not None and v is not False:
            argv += [flag, str(v)]
    for stale in (config["checkpoint"], config["checkpoint"] + ".best.npz"):
        if os.path.exists(stale):
            os.remove(stale)
    updates, evals = [], []
    step_fn, make_ev = PPOLearner.train_step, evaluate_mod.make_evaluator

    def timed_step(self, ts, graphed=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(self, ts, graphed)
        torch.cuda.synchronize()
        updates.append({"train_step_ms": (time.perf_counter() - t0) * 1e3})
        return out

    def timed_evaluator(*args, **kw):
        ev = make_ev(*args, **kw)

        def run(ts, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev(ts, generator)
            updates[-1]["eval_ms"] = (time.perf_counter() - t0) * 1e3
            evals.append(res)
            return res
        return run
    before, before_calls = fs.launches, dict(fs.calls)
    print(f"[cli] python -m heligym_tpu_torch.learner.train {' '.join(argv)}")
    PPOLearner.train_step, evaluate_mod.make_evaluator = timed_step, timed_evaluator
    try:
        t0 = time.perf_counter()
        train_cli.main(argv)
        cli_s = time.perf_counter() - t0
    finally:
        PPOLearner.train_step, evaluate_mod.make_evaluator = step_fn, make_ev
    cli_launches = fs.launches - before
    cli_calls = {k: v - before_calls[k] for k, v in fs.calls.items()}
    with open(config["metrics_out"]) as f:
        history = json.load(f)["history"]
    eval_steps = env.time_up_steps + 3
    for u in updates:
        u["wall_ms"] = u["train_step_ms"] + u.get("eval_ms", 0.0)
        u["eval_share"] = u.get("eval_ms", 0.0) / u["wall_ms"]
    with open(os.path.join(here, "examples", f"{LANDING_BAND}_eval.json")) as f:
        committed_det = json.load(f)["aggregate"]["mean"]["success_frac"]["mean"]
    band["cli"] = {"argv": argv, "wall_s": cli_s, "updates": updates,
                   "eval_success_frac": [e["success_frac"] for e in evals],
                   "committed_det_success": committed_det, "history": history,
                   "launches": cli_launches, "calls": cli_calls}
    for i, u in enumerate(updates):
        print(f"[cli] update {i + 1}: {u['wall_ms']:.1f} ms = train step "
              f"{u['train_step_ms']:.1f} ms + evaluation {u.get('eval_ms', 0.0):.1f} ms "
              f"({config['eval_episodes']} episodes x {eval_steps} steps; share "
              f"{u['eval_share']:.3f}); eval "
              f"success {evals[i]['success_frac']:.4f} (committed det {committed_det:.4f})")
    print(f"[cli] main: {cli_s:.1f} s, {cli_launches} step-kernel steps in {cli_calls}")
    if len(updates) != 2 or len(evals) != 2:
        fail(f"cli: {len(updates)} updates, {len(evals)} evaluations, not 2 and 2")
    if not history or not all(np.isfinite(v) for h in history for v in h.values()):
        fail(f"cli: non-finite history {history}")
    if not all(k in history[-1] for k in ("eval_success_frac", "eval_fail_frac",
                                          "eval_timeout_frac")):
        fail(f"cli: no eval_* keys in the history: {sorted(history[-1])}")
    if not os.path.exists(config["checkpoint"] + ".best.npz"):
        fail("cli: no .best.npz was written")
    if any(e["success_frac"] < committed_det - CLI_MARGIN for e in evals):
        fail(f"cli: an evaluation scored {band['cli']['eval_success_frac']}, more than "
             f"{CLI_MARGIN} below the committed {committed_det:.4f}")
    want = {"replay": 2, "capture": 1, "step": 2 * eval_steps}
    if cli_launches != 2 * ROLLOUT_STEPS + 1 + 2 * eval_steps or any(
            cli_calls[k] != v for k, v in want.items()):
        fail(f"cli: the step kernel ran {cli_launches} steps in {cli_calls}, expected "
             f"2 replays of {ROLLOUT_STEPS}, one capture and {want['step']} one-step "
             f"launches")
    band_launches = fs.launches
    band["launches"] = band_launches
    if band_launches == 0:
        fail("randomized resets: the step kernel never ran")
    report["randomized"] = band

    # ---- 6. the evaluator ---------------------------------------------------------
    report["evaluation"] = {}
    eval_launches = 0
    for name, cfg in EVALS.items():
        env, n_tasks = build_env(cfg["task"], cfg["tasks"], cfg["target"])
        learner_e = PPOLearner(env, PPOConfig(num_envs=N_ENVS))
        ts_e = learner_e.restore(os.path.join(here, "examples", f"{name}_policy.npz"))
        steps = env.time_up_steps + 3
        ids = np.arange(cfg["episodes"]) % n_tasks if n_tasks else None
        grid = (train_cli.make_alt_grid_sampler(*cfg["start_band"])
                if "start_band" in cfg else None)
        zero_counts()
        t0 = time.perf_counter()
        res = multi_seed_evaluate(env, learner_e, ts_e, episodes=cfg["episodes"],
                                  steps=steps, seeds=(0, 1, 2), task_ids=ids,
                                  cond_sampler=grid)
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
        starts = (f" from the {cfg['start_band'][0]:g}-{cfg['start_band'][1]:g} ft "
                  f"start grid" if grid else "")
        print(f"[eval] {name}: 2 policies x seeds 0,1,2 x {cfg['episodes']} episodes "
              f"x {steps} steps{starts} in {wall:.1f} s; success_frac mean (this run, "
              f"committed):")
        for k, (got, want) in pairs.items():
            print(f"[eval]   {k}: {got:.4f}  {want:.4f}")
            if k.split(".")[0] in cfg["heads"] and got < want - EVAL_MARGIN:
                fail(f"evaluation {name}: {k} {got:.4f} lies more than "
                     f"{EVAL_MARGIN} below the committed {want:.4f}")

    # ---- 6b. distillation -------------------------------------------------------
    report["distillation"], distill_launches = distillation(here, load_tool, zero_counts)

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
        launches; device time and bound per step of one T-step launch.
        Every launch reads the same carry and writes a scratch one, so each
        times the same work."""
        carry, init = fs.pack(es)
        scratch = torch.empty_like(carry)
        eta = torch.randn((3, N_ENVS), device=dev) * 50.0 ** 0.5
        xbuf = torch.empty((fs.XROWS, N_ENVS), device=dev)
        kernel = lambda: fs.fused_step(env, carry, init, actions, eta,
                                       carry_out=scratch, collect_out=xbuf)
        saved, saved_calls = fs.launches, dict(fs.calls)
        loop_ms = event_time_ms(kernel, 500)
        kernel_ms = device_time_ms(kernel, 100, "fused_step_kernel")
        eta_seq = torch.randn((CHUNK, 3, N_ENVS), device=dev) * 50.0 ** 0.5
        xseq = torch.empty((CHUNK, fs.XROWS, N_ENVS), device=dev)
        rollout = lambda: fs.fused_rollout(env, carry, init, actions, eta_seq,
                                           carry_out=scratch, collect_out=xseq)
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

    # block sizes, at 4096 and 16384 envs (BLOCK set for the measurement):
    # every launch reads the same fresh carry and writes a scratch one, so
    # each block size times the same work; its outputs must equal the kept
    # block's bit for bit
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
            c_one, c_many = torch.empty_like(carry), torch.empty_like(carry)
            saved, saved_calls, kept = fs.launches, dict(fs.calls), fs.BLOCK
            outs = {}
            try:
                for block in SWEEP_BLOCKS:
                    fs.BLOCK = block
                    one = lambda: fs.fused_step(env_s, carry, init, act, eta,
                                                carry_out=c_one, collect_out=xbuf)
                    many = lambda: fs.fused_rollout(env_s, carry, init, act, eta_seq,
                                                    carry_out=c_many, collect_out=xseq)
                    row = {"envs": n, "task": name, "block": block,
                           "step_us": device_time_ms(one, 30, "fused_step_kernel") * 1e3,
                           "rollout_us_per_step":
                               event_time_ms(many, 3, warmup=1) / SWEEP_STEPS * 1e3}
                    outs[block] = [x.clone() for x in (c_one, xbuf, c_many, xseq)]
                    report["sweep"].append(row)
                    print(f"[sweep] {n} envs, {name}, block {block}: one-step launch "
                          f"{row['step_us']:.2f} us, T-step launch "
                          f"{row['rollout_us_per_step']:.2f} us per step")
            finally:
                fs.BLOCK = kept
            fs.launches = saved
            fs.calls.update(saved_calls)
            for block, got in outs.items():
                bits = sum(bit_mismatches(a, b) for a, b in zip(got, outs[kept]))
                if bits:
                    fail(f"sweep: block {block} differs from block {kept} in {bits} "
                         f"values at {n} envs, {name}")

    # ---- 8. the gymnasium surfaces and the renderer feed ---------------------------
    report["surfaces"], gym_launches = surfaces(zero_counts, nan_bit_mismatches)

    # ---- 9. multi-device: the sharded farm and train step --------------------------
    report["sharded"], sharded_launches = sharded(here, load_tool, zero_counts)

    # ---- 10. a user airframe with a wing ---------------------------------------------
    report["winged"], winged_launches = winged(here, zero_counts, nan_bit_mismatches,
                                               step_numbers, train_cfg)

    nb = report["numbers"]["mixed4"]
    kernels = [{"name": fs.KERNEL, "route": "cuda",
                "source": "heligym_tpu_torch/csrc/fused_step.cu",
                "replaces": fs.REPLACES, "launches": train_launches,
                "launches_by_path": {"hover_rollout": hover_launches,
                                     "torch_bench": bench_launches,
                                     "collector": coll_launches,
                                     "train": train_launches,
                                     "randomized": band_launches,
                                     "evaluation": eval_launches,
                                     "distill": distill_launches,
                                     "gym": gym_launches,
                                     "sharded": sharded_launches,
                                     "winged": winged_launches},
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
                    report["numbers"]["hover"]["rollout_bound"]["bound_ms"],
                **{f"winged_{name}_{k}": v for name, nb in report["winged"]["numbers"].items()
                   for k, v in (("ms", nb["kernel_ms"]), ("bound_ms", nb["bound_ms"]),
                                ("plain_ms", nb["plain_ms"]),
                                ("rollout_ms_per_step", nb["rollout_ms_per_step"]),
                                ("rollout_bound_ms_per_step",
                                 nb["rollout_bound"]["bound_ms"]))}}]
    for name in ("gather_axis0", "gather_axis1"):
        big = [r for r in rows_of(report["gather"], name)
               if (r["S"], r["L"]) == (1024, 1024)][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "heligym_tpu_torch/csrc/gather.cu",
            "replaces": gather.REPLACES[name], "launches": gather_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows_of(report["gather"], name)),
            "shape": [big["S"], big["L"]],
            # the bound is device memory's: `ms` is the time with the inputs
            # there (cold L2); `hot_ms` has them in L2, as the TPU probe's
            # VMEM held them
            "ms": big["cold_us"] / 1e3, "plain_ms": big["plain_us"] / 1e3,
            "bound_ms": big["bound_us"] / 1e3, "bound_by": "bytes",
            "bound_share": big["cold_bound_share"],
            "library_ms": big["cold_library_us"] / 1e3,
            "cold_ms": big["cold_us"] / 1e3,
            "cold_library_ms": big["cold_library_us"] / 1e3,
            "hot_ms": big["us"] / 1e3, "hot_library_ms": big["library_us"] / 1e3,
            "cold_clean_ms": big["cold_clean_us"] / 1e3,
            "cold_clean_library_ms": big["cold_clean_library_us"] / 1e3})
    print("[report] " + json.dumps(report))
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def distillation(here, load_tool, zero_counts):
    """Phase 6b: the five runs of the distillation path. Returns (report,
    step-kernel steps over all runs)."""
    import torch
    from heligym_tpu_torch.envs import HeliEnv, LandingTask
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner import distill as distill_mod, evaluate as evaluate_mod
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    out_dir = os.path.join(here, "build", "chip_smoke", "distill")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ex = lambda name: os.path.join(here, "examples", name)

    def committed(name):
        with open(ex(f"{name}_eval.json")) as f:
            return json.load(f)["aggregate"]["mean"]["success_frac"]["mean"]

    report, total = {}, [0]
    fits, ends = [], []         # every BC fit's weights; the collectors' ended flags
    spent = {}                  # host seconds in the fits and the evaluations
    n_evals = [0]
    make_fitter, make_ev = distill_mod.make_bc_fitter, evaluate_mod.make_evaluator
    step = fs.fused_step

    def timed(key, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return out

    def recording_fitter(learner, **kw):
        fit = make_fitter(learner, **kw)

        def run(ts, obs, resid, w, **k):
            out = timed("fit_s", fit, ts, obs, resid, w, **k)
            fits.append({"w": w, "in": ts.params, "out": out[0].params})
            return out
        return run

    def timed_evaluator(*args, **kw):
        ev = make_ev(*args, **kw)

        def run(ts, generator):
            n_evals[0] += 1
            return timed("eval_s", ev, ts, generator)
        return run

    def recording_step(env, carry, init, act, eta, auto_reset=True, carry_out=None,
                       collect_out=None, collect=True):
        c, x = step(env, carry, init, act, eta, auto_reset, carry_out, collect_out,
                    collect)
        ends.append((x[fs.CDONE] != 0) | (x[fs.CTRUNC] != 0))
        return c, x

    def run(name, main, argv, steps, n_fits, evals, record=False):
        """`main(argv)` timed to a synchronize, with its own counts; every
        one of its `steps` env steps must be a one-step launch. The tools
        reach the fitter, the evaluator and the step through module
        attributes patched here: the run fails unless exactly `n_fits` fits
        and `evals` evaluations were timed, so that a path around the
        patches shows."""
        fits.clear()
        ends.clear()
        spent.clear()
        n_evals[0] = 0
        out = os.path.join(out_dir, name)
        argv = argv + ["--out", out + ".npz", "--metrics-out", out + ".json"] \
            if name != "tune" else argv + ["--json-out", out + ".json"]
        zero_counts()
        distill_mod.make_bc_fitter = recording_fitter
        distill_mod.make_evaluator = evaluate_mod.make_evaluator = timed_evaluator
        if record:
            fs.fused_step = recording_step
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ret = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            distill_mod.make_bc_fitter, fs.fused_step = make_fitter, step
            distill_mod.make_evaluator = evaluate_mod.make_evaluator = make_ev
        n, calls = fs.launches, dict(fs.calls)
        report[name] = {"argv": argv, "wall_s": wall, "launches": n, "calls": calls,
                        "fit_s": spent.get("fit_s", 0.0), "eval_s": spent.get("eval_s", 0.0)}
        print(f"[distill] {name}: {wall:.1f} s = fits {report[name]['fit_s']:.1f} s + "
              f"evaluations {report[name]['eval_s']:.1f} s + collection, resets and "
              f"files {wall - report[name]['fit_s'] - report[name]['eval_s']:.1f} s; "
              f"{n} step-kernel steps")
        if n != steps or calls["step"] != steps:
            fail(f"distillation {name}: the step kernel ran {n} steps in {calls}, "
                 f"expected {steps} one-step launches")
        if len(fits) != n_fits or n_evals[0] != evals:
            fail(f"distillation {name}: {len(fits)} fits and {n_evals[0]} evaluations "
                 f"were timed, expected {n_fits} and {evals}")
        if record and len(ends) != steps:
            fail(f"distillation {name}: {len(ends)} of {steps} steps were recorded")
        total[0] += n
        return ret, out

    def check_actor_only(name, fit):
        """The fit moved the actor and left the critic and log_std
        bit-equal."""
        a, b = fit["in"], fit["out"]
        frozen = list(a.critic.parameters()) + list(a.value.parameters()) + [a.log_std]
        kept = list(b.critic.parameters()) + list(b.value.parameters()) + [b.log_std]
        equal = all(torch.equal(x, y) for x, y in zip(frozen, kept))
        moved = not torch.equal(a.mean.weight, b.mean.weight)
        if not (equal and moved):
            fail(f"distillation {name}: critic/log_std bit-equal {equal}, actor moved {moved}")
        return equal

    def finite_losses(name, history):
        losses = [h["bc_loss"] for h in history if "bc_loss" in h]
        if not losses or not all(np.isfinite(losses)):
            fail(f"distillation {name}: bc_loss {losses}")
        return losses

    learner = PPOLearner(HeliEnv.build("aw109", task=LandingTask()),
                         PPOConfig(num_envs=4096))
    eval_steps = learner.env.time_up_steps + 3

    # (a) the scripted expert on the 6-100 ft grid
    tune = load_tool("torch_tune_scripted")
    res, _ = run("tune", tune.main, ["--band", "6:100", "--envs", "128",
                                     "--seeds", "0,1,2"], 3 * eval_steps, 0, 0)
    fails = [s["fail"] for s in res["per_seed"]]
    report["tune"].update(mean_succ=res["mean_succ"], per_seed=res["per_seed"])
    print(f"[distill] (a) scripted expert, 3 seeds x 128 grid points 6-100 ft: mean "
          f"success {res['mean_succ']:.4f} (per seed "
          f"{[round(s['succ'], 4) for s in res['per_seed']]}; documented 0.926 +- 0.01), "
          f"fail {np.mean(fails):.4f} (documented 0.067)")
    if res["mean_succ"] < TUNE_GATE:
        fail(f"distillation: the scripted expert scored {res['mean_succ']:.4f} < {TUNE_GATE}")

    # (b) self-imitation distillation, the committed stage-1 widths, 1 round
    argv = ["--checkpoint", ex("landing_band_policy.npz"), "--task", "landing",
            "--target", "touch_alt=ground", "--train-num-envs", "4096", "--band", "6:55",
            "--episodes", "2048", "--epochs", "8", "--minibatch", "65536",
            "--eval-episodes", "256", "--rounds", "1"]
    _, out = run("self_imitation", distill_mod.main, argv, 3 * eval_steps, 1, 2)
    with open(out + ".json") as f:
        history = json.load(f)["history"]
    want = committed("landing_band")
    if len(history) != 2 or len(fits) != 1:
        fail(f"distillation self_imitation: {len(history)} rounds, {len(fits)} fits")
    cloned = float(fits[0]["w"].sum())
    losses = finite_losses("self_imitation", history)
    equal = check_actor_only("self_imitation", fits[0])
    best = learner.restore(out + ".npz.best.npz", with_farm=True)
    report["self_imitation"].update(history=history, cloned_steps=cloned,
                                    committed_det=want, critic_log_std_equal=equal,
                                    best_update_count=best.update_count)
    print(f"[distill] (b) self-imitation, 2048 episodes x 2003 steps, 8 epochs: round 0 "
          f"det {history[0]['success_frac']:.4f} (committed {want:.4f}); round 1 "
          f"stochastic {history[1]['stoch_success']:.4f}, {cloned:.0f} cloned steps, "
          f"bc_loss {losses[0]:.6f}, det {history[1]['success_frac']:.4f}; critic and "
          f"log_std bit-equal {equal}; .best.npz read back")
    if abs(history[0]["success_frac"] - want) > DISTILL_MARGIN:
        fail(f"distillation self_imitation: round 0 {history[0]['success_frac']:.4f} lies "
             f"more than {DISTILL_MARGIN} from the committed {want:.4f}")
    if cloned <= 0:
        fail("distillation self_imitation: no step was cloned")

    # (c) the scripted expert distilled, 1 BC and 1 DAgger round
    argv = ["--init", ex("landing100_policy.npz"), "--train-num-envs", "4096",
            "--band", "6:100", "--episodes", "1024", "--collect-log-std", "-3",
            "--epochs", "10", "--minibatch", "65536", "--eval-episodes", "256",
            "--bc-rounds", "1", "--dagger-rounds", "1"]
    scripted = load_tool("torch_distill_scripted")
    history, _ = run("scripted", scripted.main, argv, 5 * eval_steps, 2, 3, record=True)
    want = committed("landing100")
    if len(history) != 3 or len(fits) != 2:
        fail(f"distillation scripted: {len(history)} rounds, {len(fits)} fits")
    # the collectors' steps (1024 envs; the evaluations have 256), in order
    coll = torch.stack([e for e in ends if e.shape[0] == 1024])
    if coll.shape[0] != 2 * eval_steps:
        fail(f"distillation scripted: {coll.shape[0]} collector steps recorded")
    alive = []
    for block in (coll[:eval_steps], coll[eval_steps:]):
        ended_before = torch.cumsum(block.int(), 0) - block.int()
        alive.append(ended_before == 0)
    w_bc, w_dagger = (f["w"].bool() for f in fits)
    dagger_missed = int((alive[1] & ~w_dagger).sum())
    dagger_extra = int((w_dagger & ~alive[1]).sum())
    bc_partial = int(((w_bc != alive[0]).any(0) & w_bc.any(0)).sum())
    losses = finite_losses("scripted", history)
    equal = all(check_actor_only("scripted", f) for f in fits)
    report["scripted"].update(history=history, committed_det=want,
                              dagger_weighted=int(w_dagger.sum()),
                              dagger_alive=int(alive[1].sum()),
                              dagger_missed=dagger_missed, dagger_extra=dagger_extra,
                              bc_weighted=int(w_bc.sum()), bc_partial_envs=bc_partial)
    print(f"[distill] (c) scripted distillation, 1024 episodes x 2003 steps, 10 epochs: "
          f"round 0 det {history[0]['success_frac']:.4f} (committed {want:.4f}); BC acting "
          f"success {history[1]['acting_success']:.4f} (committed 0.855-0.874), "
          f"{int(w_bc.sum())} labelled steps, bc_loss {losses[0]:.6f}, det "
          f"{history[1]['success_frac']:.4f}; DAgger acting success "
          f"{history[2]['acting_success']:.4f}, {int(w_dagger.sum())} labelled of "
          f"{int(alive[1].sum())} alive steps (missed {dagger_missed}, extra "
          f"{dagger_extra}), bc_loss {losses[1]:.6f}, det {history[2]['success_frac']:.4f}; "
          f"critic and log_std bit-equal {equal}")
    if abs(history[0]["success_frac"] - want) > DISTILL_MARGIN:
        fail(f"distillation scripted: round 0 {history[0]['success_frac']:.4f} lies more "
             f"than {DISTILL_MARGIN} from the committed {want:.4f}")
    if history[1]["acting_success"] < BC_ACTING_GATE:
        fail(f"distillation scripted: the expert's acting success "
             f"{history[1]['acting_success']:.4f} < {BC_ACTING_GATE}")
    if dagger_missed or dagger_extra or bc_partial:
        fail(f"distillation scripted: DAgger weights missed {dagger_missed} alive steps "
             f"and weighted {dagger_extra} others; {bc_partial} BC episodes partly weighted")

    # (d) multitask distillation on the committed multitask4 config, 1 DAgger round
    with open(ex("multitask4_distill_metrics.json")) as f:
        mt = json.load(f)
    experts = mt["config"]["experts"].replace("examples/", ex(""))
    argv = ["--experts", experts, "--target", mt["config"]["target"],
            "--collect-steps", "1200", "--collect-envs", "512", "--collect-log-std", "-3",
            "--epochs", "10", "--task-loss-weights", "2,1,1,1", "--out-num-envs", "1024",
            "--eval-episodes", "512", "--seed", "63", "--dagger-rounds", "1"]
    multitask = load_tool("torch_distill_multitask")
    history, _ = run("multitask", multitask.main, argv, 4 * 1200 + 4 * 600 + 2 * eval_steps,
                     2, 2)
    losses = finite_losses("multitask", history)
    per_task = [[round(h[f"success_frac_t{i}"], 4) for i in range(4)] for h in history]
    report["multitask"].update(history=history, committed=mt["history"][:2])
    print(f"[distill] (d) multitask4, 4 experts x 512 envs x 1200 steps, 10 epochs: round 0 "
          f"success {history[0]['success_frac']:.4f} per task {per_task[0]} (committed "
          f"{mt['history'][0]['success_frac']:.4f}), round 1 {history[1]['success_frac']:.4f} "
          f"per task {per_task[1]} (committed {mt['history'][1]['success_frac']:.4f}); "
          f"bc_loss {losses[0]:.6f}, {losses[1]:.6f}")
    if history[0]["success_frac"] < MULTITASK_GATE:
        fail(f"distillation multitask: round 0 success {history[0]['success_frac']:.4f} "
             f"< {MULTITASK_GATE}")

    # (e) the hybrid blend's mechanics: one policy as both experts, 1 round
    lander = f"{ex('landing_band_policy.npz')}:2048"
    hybrid = load_tool("torch_distill_hybrid")
    history, _ = run("hybrid", hybrid.main, ["--lander", lander, "--descender", lander,
                                             "--rounds", "1"], 3 * eval_steps, 1, 2)
    losses = finite_losses("hybrid", history)
    kept = float(fits[0]["w"].sum()) if fits else 0.0
    report["hybrid"].update(history=history, kept=kept)
    print(f"[distill] (e) hybrid blend (landing_band as lander and descender), 2048 "
          f"episodes, 6-100 ft: round 0 det {history[0]['success_frac']:.4f}, round 1 "
          f"{kept:.0f} samples, bc_loss {losses[0]:.3e}, det "
          f"{history[1]['success_frac']:.4f}")
    if len(history) != 2 or kept <= 0:
        fail(f"distillation hybrid: {len(history)} rounds, {kept} samples kept")
    return report, total[0]


def surfaces(zero_counts, nan_bit_mismatches):
    """Phase 8: the gymnasium surfaces and the renderer feed on the card.
    Returns (report, step-kernel steps)."""
    import torch
    from heligym_tpu_torch import ENV_IDS
    from heligym_tpu_torch.envs import TASKS, BatchCore, HeliEnv, HoverTask, SingleCore
    from heligym_tpu_torch.envs.env import map_tensors
    from heligym_tpu_torch.ops.cuda import fused_step as fs
    from heligym_tpu_torch.render import (NativeRenderer, NumpyTopDownRenderer,
                                          native_available)

    report = {"gymnasium_installed": importlib.util.find_spec("gymnasium") is not None}
    zero_counts()
    t_phase = time.perf_counter()

    # HeliEnv.reset and heli_step on the card against the CPU
    envs = {dev: HeliEnv.build("aw109", task=HoverTask(), device=dev)
            for dev in ("cuda", "cpu")}
    out = {}
    for dev, env in envs.items():
        es, _ = env.reset()
        a = env.trim_result().action.to(env.device)
        new, k4, obs = env.heli_step(es.heli, tuple(a[i] for i in range(4)),
                                     tuple(es.wind_ned[i] for i in range(3)))
        out[dev] = {"reset": es.heli.flatten(), "state": new.flatten(),
                    "k4": k4.flatten(), "obs": torch.stack(obs)}
    rel = {k: float(((out["cuda"][k].cpu() - v).abs() / v.abs().clamp(min=1.0)).max())
           for k, v in out["cpu"].items()}
    report["heli_step_vs_cpu"] = rel
    print(f"[gym] HeliEnv.reset, heli_step on the card vs the CPU, max |err| over each "
          f"field's scale: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (tolerance {GYM_TOL})")
    if max(rel.values()) > GYM_TOL:
        fail(f"heli_step on the card differs from the CPU by {max(rel.values()):.3e}")

    # each id's single env: one kernel launch per step, its carry held bit
    # for bit against the plain version from the same carry and noise
    report["single"] = {}
    for name in ENV_IDS:
        core = SingleCore(HeliEnv.build("aw109", task=TASKS[name]()))
        core.generator.manual_seed(0)
        core.reset()
        act = core.trim({}).action.numpy()[None]
        wall, bits, checked = 0.0, 0, 0
        for t in range(GYM_STEPS):
            before, calls = fs.launches, fs.calls["step"]
            c0 = core.carry.clone() if t in GYM_CHECK else None
            t0 = time.perf_counter()
            core.step(act)
            wall += time.perf_counter() - t0
            if fs.launches - before != 1 or fs.calls["step"] - calls != 1:
                fail(f"{name}: step {t} made {fs.launches - before} kernel launches")
            if c0 is not None:
                with torch.no_grad():
                    cp, xp = fs.fused_step_plain(core.env, c0, core.init, core.act,
                                                 core.eta, auto_reset=False)
                bits += (nan_bit_mismatches(core.carry, cp)
                         + nan_bit_mismatches(core.out[:fs.XROWS], xp))
                checked += 1
        rate = GYM_STEPS / wall
        report["single"][name] = {"steps": GYM_STEPS, "steps_per_s": rate,
                                  "bits_differing": bits, "steps_checked": checked}
        print(f"[gym] {name}: {GYM_STEPS} steps of the trim action, one kernel launch "
              f"each, {rate:.1f} steps/s; carry and collect vs the plain version at "
              f"{checked} steps: {bits} bits differing")
        if bits:
            fail(f"{name}: the facade's step differs from the plain version in {bits} values")
    single_state = core.state()

    # the vector env at 4096 envs: a dive until every env has ended
    env = HeliEnv.build("aw109", task=HoverTask())
    core = BatchCore(env, N_ENVS)
    core.generator.manual_seed(0)
    core.reset()
    act = np.tile(core.trim({}).action.numpy(), (N_ENVS, 1))
    act[:, 0] = -1.0
    ended_once = np.zeros(N_ENVS, bool)
    snapshot = core.init[fs.O0:fs.D0].T.cpu().numpy()
    wall, ends, final_bits, bits, snap_bad, steps = 0.0, 0, 0, 0, 0, 0
    while not ended_once.all() and steps < GYM_DIVE_MAX:
        c0 = core.carry.clone()
        before = fs.launches
        t0 = time.perf_counter()
        res = core.step(act)
        wall += time.perf_counter() - t0
        steps += 1
        if fs.launches - before != 1:
            fail(f"vector env: step {steps} made {fs.launches - before} kernel launches")
        ended = res.done | res.truncated
        if ended.any():
            with torch.no_grad():
                cp, xp = fs.fused_step_plain(env, c0, core.init, core.act, core.eta)
            want = xp[fs.CFINAL0:fs.XROWS].T.cpu().numpy()[ended]
            final_bits += int((res.final_obs[ended].view(np.int32)
                               != want.view(np.int32)).sum())
            bits += (nan_bit_mismatches(core.carry, cp)
                     + nan_bit_mismatches(core.out[:fs.XROWS], xp))
            snap_bad += int((res.obs[ended] != snapshot[ended]).any(axis=1).sum())
            ends += int(ended.sum())
        ended_once |= ended
    rate = N_ENVS * steps / wall
    report["vector"] = {"envs": N_ENVS, "steps": steps, "env_steps_per_s": rate,
                        "ends": ends, "envs_ended": int(ended_once.sum()),
                        "final_obs_bits_differing": final_bits,
                        "bits_differing_at_ends": bits, "obs_not_snapshot": snap_bad}
    print(f"[gym] vector env, {N_ENVS} envs diving (collective -1): {steps} steps, "
          f"{rate:.1f} env-steps/s, {int(ended_once.sum())} envs ended ({ends} ends); "
          f"final_obs vs the plain version's rows 22-38: {final_bits} bits differing; "
          f"carry and collect at the ending steps: {bits}; obs not the snapshot: {snap_bad}")
    if not ended_once.all() or final_bits or bits or snap_bad:
        fail("vector env: the dive's ends differ from the plain version")

    # one native and one top-down frame of the card state, each against a
    # fresh renderer's frame of its CPU copy
    t0 = time.perf_counter()
    if not native_available():
        fail("the native renderer did not build")
    report["render"] = {"native_build_s": time.perf_counter() - t0}
    host_state = map_tensors(lambda x: x.cpu(), single_state)
    for kind, make in (("native", lambda: NativeRenderer(envs["cuda"])),
                       ("topdown", lambda: NumpyTopDownRenderer(envs["cuda"]))):
        frames = []
        for state in (single_state, host_state):
            r = make()
            frames.append(r.render(state))
            r.close()
        r = make()
        t0 = time.perf_counter()
        for _ in range(GYM_FRAMES):
            frame = r.render(single_state)
        ms = (time.perf_counter() - t0) / GYM_FRAMES * 1e3
        r.close()
        colours = len(np.unique(frames[0].reshape(-1, 3), axis=0))
        equal = bool(np.array_equal(frames[0], frames[1]))
        report["render"][kind] = {"shape": list(frame.shape), "ms_per_frame": ms,
                                  "colours": colours, "equal_to_cpu_copy": equal}
        print(f"[render] {kind}: {frame.shape} {frame.dtype}, {colours} colours, "
              f"{ms:.2f} ms per frame ({GYM_FRAMES} frames of the card state); "
              f"equal to the CPU copy's frame {equal}")
        if frame.dtype != np.uint8 or frame.ndim != 3 or colours < 50 or not equal:
            fail(f"{kind} frame: {frame.shape} {frame.dtype}, {colours} colours, "
                 f"equal to the CPU copy's {equal}")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[gym] phase 8: {report['phase_s']:.1f} s, {fs.launches} step-kernel steps")
    return report, fs.launches


def sharded(here, load_tool, zero_counts):
    """Phase 9: the hover4k stage-1 train step sharded over ranks
    (`tools/torch_sharded_step.py`). Returns (report, step-kernel steps of
    the sharded runs, summed over their ranks)."""
    import subprocess
    import torch
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    tool = load_tool("torch_sharded_step")
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[sharded] compute mode: {mode} (two processes share the card outside the "
          f"exclusive modes)")
    out = os.path.join(here, "build", "chip_smoke", "sharded")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    opts = {"num_envs": N_ENVS, "rollout_steps": ROLLOUT_STEPS, "cpu": False,
            "same_card": True, "save": None}
    t_phase = time.perf_counter()
    # today's learner, no mesh: what the sharded runs are held against
    base = tool.step_results(torch.device("cuda", 0), opts, None)
    print(tool.timing_line(base, "one process, no mesh"))
    # (a) NCCL, one rank on cuda:0, in this process
    zero_counts()
    one = tool.run_rank(0, 1, {**opts, "backend": "nccl",
                               "address": f"localhost:{tool.free_port()}"},
                        os.path.join(out, "nccl"))
    launches_a = fs.launches
    print(tool.timing_line(one, "(a) 1 rank, NCCL"))
    # (b) gloo, two ranks on the same card, spawned
    save = os.path.join(out, "gloo", "sharded.npz")
    two = tool.run_ranks(2, {**opts, "backend": "gloo", "save": save,
                             "address": f"localhost:{tool.free_port()}"},
                         os.path.join(out, "gloo"))
    for r, res in enumerate(two):
        print(tool.timing_line(res, f"(b) rank {r}/2, gloo on one card"))
    print("[sharded] gloo on one card carries every all-reduce through the host: these "
          "are not multi-card numbers")
    rep_a, fails = tool.compare(base, [one], "(a) NCCL 1 rank vs no mesh")
    rep_b, fails_b = tool.compare(one, two, "(b) gloo 2 ranks vs (a)")
    rep_b["save_restore_bit_equal"] = tool.check_save(save, two, torch.device("cuda", 0))
    for label, rep in (("(a) NCCL, 1 rank vs no mesh", rep_a),
                       ("(b) gloo, 2 ranks vs (a)", rep_b)):
        print(f"[check] sharded {label}: rollout discrete streams equal "
              f"{rep['discrete_equal']}, floats max |diff| {rep['rollout_max_abs_diff']:.3e} "
              f"(bit-equal {rep['rollout_bit_equal']}); params {rep['params_rel_err']:.3e}, "
              f"mu {rep['mu_rel_err']:.3e}, nu {rep['nu_rel_err']:.3e} of their scale "
              f"(tolerance {tool.REL_TOL:g}); metrics max |diff| "
              f"{rep['metric_max_abs_diff']:.3e}; farm_metrics {rep['farm_metrics']}; "
              f"generators equal {rep['generators_equal']}")
    print(f"[check] sharded (b): a 2-rank save restored in one process bit-equal to the "
          f"ranks' farms, rank 0's parameters and Adam {rep_b['save_restore_bit_equal']}")
    fails += fails_b
    if not rep_b["save_restore_bit_equal"]:
        fails.append("(b): the 2-rank save, restored in one process, differs")
    launches = launches_a + sum(int(r["launches"]) for r in two)
    if int(one["launches"]) == 0 or any(int(r["launches"]) == 0 for r in two):
        fails.append("a rank of the sharded step ran no step-kernel step")
    if fails:
        fail("sharded: " + "; ".join(fails))
    report = {"reference": tool.summary(base), "nccl_1rank": tool.summary(one),
              "gloo_2ranks": [tool.summary(r) for r in two], "check_a": rep_a,
              "check_b": rep_b, "compute_mode": mode,
              "phase_s": time.perf_counter() - t_phase}
    print(f"[sharded] phase 9: {report['phase_s']:.1f} s, {launches} step-kernel steps "
          f"on the sharded runs ({launches_a} in (a), "
          f"{[int(r['launches']) for r in two]} on (b)'s ranks)")
    return report, launches


def winged(here, zero_counts, nan_bit_mismatches, step_numbers, train_cfg):
    """Phase 10: a user airframe with a wing, through `register_model_path`
    to the kernels' winged instantiation. Returns (report, step-kernel steps
    of its path)."""
    import dataclasses
    import torch
    from heligym_tpu_torch.envs import VectorHeliEnv
    from heligym_tpu_torch.learner import PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    from heligym_tpu_torch.models import register_model_path
    from heligym_tpu_torch.ops.cuda import fused_step as fs
    from heligym_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # the tests' user airframe (tests/torch_airframes.py), written anew here
    spec = importlib.util.spec_from_file_location(
        "torch_airframes", os.path.join(here, "tests", "torch_airframes.py"))
    airframes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(airframes)
    airframe, wing = airframes.NAME, airframes.WING
    models_dir = os.path.join(here, "build", "chip_smoke", "models")
    shutil.rmtree(models_dir, ignore_errors=True)
    os.makedirs(models_dir)
    airframes.write_winged(models_dir)
    register_model_path(models_dir)
    t0 = time.perf_counter()
    hover, _ = build_env("hover", None, "sea_alt=start", heli=airframe)
    mixed, n_sub = build_env("hover", ",".join(MIXED4), "sea_alt=start,vel=60", heli=airframe)
    tr, tr60 = hover.trim_result(), hover.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
    report = {"airframe": airframe, "wing": wing, "trims_s": time.perf_counter() - t0,
              "trim_action": tr.action.tolist()}
    wn = hover.params.WN
    if not (fs.has_wing(hover) and fs.has_wing(mixed)) or \
            (wn.ZUU, wn.ZUW, wn.ZMAX) != tuple(wing.values()):
        fail(f"winged: {airframe} did not load with its wing ({wn})")
    print(f"[winged] {airframe} from {models_dir}: WN ZUU {wn.ZUU} ZUW {wn.ZUW} ZMAX "
          f"{wn.ZMAX}; host trims {report['trims_s']:.2f} s, hover trim action "
          f"{[round(a, 4) for a in report['trim_action']]}")

    # the winged kernels against the plain version, bit for bit, at every
    # block size, in one-step launches stepping their own carry and in one
    # T-step launch; the plain version runs once per case
    rng = np.random.default_rng(10)
    venv_h = VectorHeliEnv(hover, N_ENVS)
    es_h, _ = venv_h.reset_from_trim(tr)
    venv_m = VectorHeliEnv(mixed, N_ENVS)
    es_m, _ = venv_m.reset_from_trim(tr60)
    es_m = venv_m.assign_tasks(es_m, np.arange(N_ENVS) % n_sub)

    def hold(label, env, es, action, steps, dive, auto_reset):
        act = np.tile(action.cpu().numpy(), (steps, N_ENVS, 1))
        act = (act + 0.02 * rng.standard_normal(act.shape)).astype(np.float32)
        if dive:
            act[..., 0] = -1.0
        eta = (rng.standard_normal((steps, 3, N_ENVS)) * 50.0 ** 0.5).astype(np.float32)
        act, eta = torch.from_numpy(act).to(dev), torch.from_numpy(eta).to(dev)
        carry, init = fs.pack(es)
        cp, xp = carry.clone(), []
        with torch.no_grad():
            for t in range(steps):
                cp, x = fs.fused_step_plain(env, cp, init, act[t], eta[t], auto_reset)
                xp.append(x)
        xp = torch.stack(xp)
        bits, kept = {}, fs.BLOCK
        try:
            for block in SWEEP_BLOCKS:
                fs.BLOCK = block
                ck, xk = carry.clone(), []
                for t in range(steps):
                    ck, x = fs.fused_step(env, ck, init, act[t], eta[t], auto_reset)
                    xk.append(x)
                cr, xr = fs.fused_rollout(env, carry, init, act, eta, auto_reset)
                bits[block] = {"one_step": nan_bit_mismatches(ck, cp)
                               + nan_bit_mismatches(torch.stack(xk), xp),
                               "t_step": nan_bit_mismatches(cr, cp) + nan_bit_mismatches(xr, xp)}
        finally:
            fs.BLOCK = kept
        torch.cuda.synchronize()
        row = {"steps": steps, "dive": dive, "auto_reset": auto_reset,
               "done_frac": float(xp[:, fs.CDONE].mean()), "bits": bits}
        print(f"[check] winged {label}: kernel vs plain, {steps} steps at {N_ENVS} envs"
              f"{' (dive)' if dive else ''}, auto_reset={auto_reset}: done fraction "
              f"{row['done_frac']:.4f}; bits differing in carry and collect, one-step / "
              f"T-step launch, by block: " + ", ".join(
                  f"{b} {v['one_step']} / {v['t_step']}" for b, v in bits.items()))
        if any(v for b in bits.values() for v in b.values()):
            fail(f"winged {label}: the winged kernel differs from its plain version")
        if dive and not bool(xp[:, fs.CDONE].any()):
            fail(f"winged {label}: the dive never terminated")
        return row

    report["checks"] = [
        hold("hover", hover, es_h, tr.action, 30, False, True),
        hold("hover", hover, es_h, tr.action, 300, True, True),
        hold("hover", hover, es_h, tr.action, 30, False, False),
        hold("hover", hover, es_h, tr.action, 300, True, False),
        hold("mixed4", mixed, es_m, tr60.action, 30, False, True),
        hold("mixed4", mixed, es_m, tr60.action, 300, True, True)]

    # the winged launches timed beside their bounds (counts restored inside)
    report["numbers"] = {
        "hover": step_numbers(hover, es_h, tr.action.to(dev).expand(N_ENVS, 4).contiguous(),
                              0.0, mixed=False),
        "mixed4": step_numbers(mixed, es_m, tr60.action.to(dev).expand(N_ENVS, 4).contiguous(),
                               0.0, mixed=True)}
    for name, nb in report["numbers"].items():
        rb = nb["rollout_bound"]
        print(f"[time] winged {name}: one-step kernel {nb['kernel_ms'] * 1e3:.2f} us/launch "
              f"({nb['kernel_ms_source']}), bound {nb['bound_ms'] * 1e3:.3f} us "
              f"({nb['bound_by']}, {nb['elementwise_ops_per_env_step']:.0f} elementwise "
              f"ops/env); T-step launch {nb['rollout_ms_per_step'] * 1e3:.2f} us per step, "
              f"bound {rb['bound_ms'] * 1e3:.3f} us ({rb['bound_by']}); plain "
              f"{nb['plain_ms']:.3f} ms/step")

    # the path: the graphed collector and one train step with hover4k's
    # parameters on a fresh winged farm, the rollout demo's work, a trace
    zero_counts()
    trainer = PPOLearner(hover, train_cfg)
    ts = trainer.init(torch.Generator().manual_seed(5))
    ck = trainer.restore(os.path.join(here, "examples", "hover4k_policy.npz"))
    ts = ts.replace(params=ck.params, opt_state=ck.opt_state, obs_stats=ck.obs_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, traj = trainer.collect(ts, ts.generator)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    for f in ("obs", "action", "log_prob", "value", "reward", "v_boot"):
        v = getattr(traj, f)
        if v.shape[:2] != (ROLLOUT_STEPS, N_ENVS) or not bool(torch.isfinite(v).all()):
            fail(f"winged collector: {f} has shape {tuple(v.shape)} or non-finite values")
    t0 = time.perf_counter()
    ts, metrics = trainer.train_step(ts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()) or not all(
            bool(torch.isfinite(p).all()) for p in trainer.param_list(ts.params)):
        fail(f"winged train step: non-finite metrics or parameters ({metrics})")
    after_train = fs.launches
    if after_train != 2 * ROLLOUT_STEPS + 1 or fs.calls["replay"] != 2:
        fail(f"winged: the collector and the train step ran {after_train} kernel steps "
             f"in {fs.calls}, expected {2 * ROLLOUT_STEPS + 1} in 2 replays")
    print(f"[winged] graphed collect, {ROLLOUT_STEPS} steps at {N_ENVS} envs (capture "
          f"included): {collect_s * 1e3:.1f} ms; one train step {train_s * 1e3:.1f} ms; "
          f"reward_mean {metrics['reward_mean']:.5f}, done_frac {metrics['done_frac']:.5f}, "
          f"approx_kl {metrics.get('approx_kl', float('nan')):.3g}")

    spec = importlib.util.spec_from_file_location(
        "torch_rollout_demo", os.path.join(here, "examples", "torch_rollout_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    res = demo.run(N_ENVS, CHUNK, fused=True, heli=airframe)
    if not bool((torch.isfinite(res["rewards"]) | res["dones"]).all()):
        fail("winged rollout demo: a non-finite reward outside an ending step")
    if fs.launches - after_train != CHUNK or fs.calls["rollout"] != 1:
        fail(f"winged rollout demo: {fs.launches - after_train} kernel steps in {fs.calls}")
    demo_report = {k: v for k, v in res.items() if k not in ("state", "rewards", "dones")}
    print(f"[winged] rollout demo, one T-step launch: {res['env_steps']} env-steps in "
          f"{res['seconds']:.3f} s, {res['steps_per_s']:.1f} env-steps/s, mean reward "
          f"{res['mean_reward']:+.5f}, terminations {res['terminations']}, altitude "
          f"{res['alt_min']:.0f}..{res['alt_max']:.0f} ft")

    tracer = PPOLearner(hover, dataclasses.replace(train_cfg, rollout_steps=TRACE_STEPS))
    gen = torch.Generator(device=dev).manual_seed(2)
    ts3, _ = tracer.collect(ts, gen)                  # the capture, outside the trace
    trace_dir = os.path.join(here, "build", "chip_smoke", "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    before = fs.launches
    with trace(trace_dir) as prof:
        tracer.collect(ts3, gen)
    traced = sum(ev.count for ev in prof.key_averages()
                 if "fused_step_kernel<true>" in ev.key)
    names = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, names[0])) as f:
        in_file = "fused_step_kernel" in f.read()
    print(f"[winged] trace of {TRACE_STEPS} collector steps (a graph replay): "
          f"{names[0]}, names the step kernel {in_file}; executions of "
          f"fused_step_kernel<true> {traced}, step-kernel steps {fs.launches - before}")
    if len(names) != 1 or not in_file or traced != TRACE_STEPS \
            or fs.launches - before != TRACE_STEPS:
        fail(f"winged trace: {names}, winged kernel in the file {in_file}, "
             f"{traced} executions")
    launches, calls = fs.launches, dict(fs.calls)
    report.update(collect_s=collect_s, train_step_s=train_s, metrics=metrics,
                  demo=demo_report, traced_executions=traced, launches=launches,
                  calls=calls, phase_s=time.perf_counter() - t_phase)
    print(f"[winged] phase 10: {report['phase_s']:.1f} s, {launches} step-kernel steps "
          f"on its path ({calls})")
    return report, launches


def rows_of(rows, name):
    return [r for r in rows if r["name"] == name]


if __name__ == "__main__":
    main()
