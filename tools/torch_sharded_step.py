#!/usr/bin/env python
"""One PPO train step sharded over ranks (`heligym_tpu_torch.parallel`),
held against the same step in one process without a mesh.

The step is hover4k's stage 1 (examples/hover4k_training_metrics.json: 4096
envs x 64 steps, 4 epochs x 8 minibatches, hidden (256, 256), lr 1e-4
annealed over 200 updates, critic warm-up 30, frozen obs stats), resumed
from examples/hover4k_policy.npz with its farm and Adam state, the
schedules reset, as `chip_smoke.py` phase 5b takes it. The reference is the
learner without a mesh, in this process; then `--ranks` processes each take
their rows of the same farm on an env mesh and take the same step: the
collector's CUDA graph and step kernel on each rank's card, the update's
all-reduces over NCCL (or gloo). Held, for each rank:

  * its collected rollout against its columns of the reference's: the
    done, truncated, failed and in-tolerance streams exactly, the floats at
    tests/test_sharding.py's tolerances (reward atol 1e-4, the rest rtol
    1e-3 / atol 1e-4), whether they came out bit-equal reported;
  * the parameters and Adam's moments (max |diff| over the tensor's
    largest magnitude, at most 1e-4), Adam's count equal, the loss, reward,
    approx_kl and success metrics (rtol 1e-3 / atol 1e-5);
  * `farm_metrics` of the rollout against the reference's (rtol 1e-6; the
    reward mean also atol 1e-6 of the mean |reward|);
  * the generator's state equal to the reference's;
  * the main rank's value broadcast to every rank (`PPOLearner._from_main`,
    how `train` shares an evaluation's success);

and a `save` of the sharded state, restored in one process, bit-equal to
the ranks' farms and rank 0's parameters. Both steps are the learner's own
`train_step`. After the compared step, one more step is timed on every
rank: collect and update by CUDA events, and the all-reduces inside the
update (events around each call of the learner's `_reduce`).

    python3 tools/torch_sharded_step.py --ranks 4            # NCCL, rank k on cuda:k
    python3 tools/torch_sharded_step.py --ranks 2 --backend gloo --same-card
    python3 tools/torch_sharded_step.py --ranks 4 --cpu --num-envs 64 --rollout-steps 8

`--cpu` runs every rank on the CPU over gloo (a rehearsal of the card run:
the step kernel's plain version, a fresh farm when the checkpoint's is of
another size). Prints `[sharded]` and `[check]` lines, then one JSON line
with every number; exits non-zero when a check fails.
"""
import argparse
import dataclasses
import json
import os
import socket
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(HERE, "tools")
if HERE not in sys.path:
    sys.path.insert(0, HERE)
CKPT = os.path.join(HERE, "examples", "hover4k_policy.npz")
REL_TOL = 1e-4                  # parameters and moments, over each tensor's scale
ROLLOUT_TOL = {"reward": dict(rtol=0.0, atol=1e-4)}
FLOAT_TOL = dict(rtol=1e-3, atol=1e-4)
METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
DISCRETE = ("terminated", "truncated", "failed", "succ_step")


def stage1_config(num_envs: int, rollout_steps: int):
    from heligym_tpu_torch.learner import PPOConfig
    return PPOConfig(num_envs=num_envs, rollout_steps=rollout_steps, minibatches=8,
                     epochs=4, lr=1e-4, ent_coef=1e-3, gamma=0.99, anneal_updates=200,
                     shuffle="perm", freeze_obs_stats=True, success_bonus=1.0,
                     fail_penalty=5.0, vf_clip_eps=0.0, target_kl=0.0, critic_warmup=30)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(device, opts: dict, mesh):
    """The learner and its state: hover4k's checkpoint restored (its farm
    where the sizes match, else a fresh farm), the schedules reset."""
    import torch
    from heligym_tpu_torch.learner import PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    env, _ = build_env("hover", None, "sea_alt=start", device=device)
    learner = PPOLearner(env, stage1_config(opts["num_envs"], opts["rollout_steps"]),
                         mesh=mesh)
    ts = learner.init(torch.Generator().manual_seed(5))
    if opts["num_envs"] == 4096:
        ts = learner.restore(CKPT, ts)
    else:
        ck = learner.restore(CKPT)
        ts = ts.replace(params=ck.params, opt_state=ck.opt_state, obs_stats=ck.obs_stats)
    return learner, ts.replace(update_count=0)


class ReduceTimer:
    """A learner's `_reduce` (every collective of its train step) with CUDA
    events (host clock on the CPU) around each call over ranks, and those
    calls and their bytes counted."""

    def __init__(self, fn, mesh, cuda: bool):
        self.fn, self.mesh, self.cuda = fn, mesh, cuda
        self.spans, self.calls, self.bytes = [], 0, 0

    def __call__(self, t, *args, **kw):
        import torch
        if self.mesh is None:            # no ranks: nothing to reduce
            return self.fn(t, *args, **kw)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        if not self.cuda:
            t0 = time.perf_counter()
            out = self.fn(t, *args, **kw)
            self.spans.append((time.perf_counter() - t0) * 1e3)
            return out
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(t, *args, **kw)
        b.record()
        self.spans.append((a, b))
        return out

    def ms(self) -> float:
        return sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
                   for s in self.spans)


def take_step(learner, ts, timed: bool):
    """One `learner.train_step` (its generator check included), its
    rollout kept by a tap on the learner's `collect`; with `timed`, the
    times of collect and update (CUDA events; host clock on the CPU) and of
    the update's all-reduces (a `ReduceTimer` on the learner's `_reduce`).
    The taps are attributes of this learner object, removed after the step."""
    import torch
    cuda = learner.env.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks, kept = [], {}

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    def tap(name, keep=None):
        fn = getattr(learner, name)

        def tapped(*args, **kw):
            if timed and not marks:
                mark()
            out = fn(*args, **kw)
            if timed:
                mark()
            if keep is not None:
                kept[keep] = out[1]
            return out
        setattr(learner, name, tapped)

    timer = ReduceTimer(learner._reduce, learner.mesh, cuda) if timed else None
    tap("collect", keep="traj")
    if timed:
        tap("update")
        learner._reduce = timer
    sync()
    w0 = time.perf_counter()
    try:
        ts, metrics = learner.train_step(ts)
        sync()
    finally:
        for name in ("collect", "update", "_reduce"):
            learner.__dict__.pop(name, None)
    times = None
    if timed:
        span = ((lambda a, b: a.elapsed_time(b)) if cuda
                else (lambda a, b: (b - a) * 1e3))
        times = {"wall_ms": (time.perf_counter() - w0) * 1e3,
                 "collect_ms": span(marks[0], marks[1]),
                 "update_ms": span(marks[1], marks[2]), "allreduce_ms": timer.ms(),
                 "allreduce_calls": timer.calls, "allreduce_bytes": timer.bytes}
    return ts, kept["traj"], metrics, times


def step_results(device, opts: dict, mesh) -> dict:
    """One compared step and one timed step of this process's learner;
    the results as numpy (rollout, parameters, Adam, metrics, farm,
    generator) and the times."""
    import torch
    from heligym_tpu_torch.convert import env_state_to_numpy
    from heligym_tpu_torch.envs.env import StepOutput
    from heligym_tpu_torch.ops.cuda import fused_step as fs
    from heligym_tpu_torch.parallel import farm_metrics
    learner, ts = start(device, opts, mesh)
    launches0 = fs.launches
    ts, traj, metrics, _ = take_step(learner, ts, timed=False)
    # copies: on the CPU a tensor's numpy view would follow the next step
    host = lambda t: t.detach().cpu().numpy().copy()
    res = {f"traj/{f.name}": host(getattr(traj, f.name))
           for f in dataclasses.fields(traj) if f.name != "task_oh"}
    net = learner.param_list(ts.params)
    for name, tensors in (("params", net), ("mu", ts.opt_state.mu), ("nu", ts.opt_state.nu)):
        for i, t in enumerate(tensors):
            res[f"{name}/{i}"] = host(t)
    res["count"] = host(ts.opt_state.count)
    for k, v in metrics.items():
        res[f"metric/{k}"] = host(v)
    flag = lambda x: x > 0
    out = StepOutput(obs=traj.obs, reward=traj.reward, done=flag(traj.terminated),
                     truncated=flag(traj.truncated), failed=flag(traj.failed),
                     successed=flag(traj.terminated) & ~flag(traj.failed),
                     time_up=flag(traj.truncated))
    for k, v in farm_metrics(out, mesh).items():
        res[f"farm_metric/{k}"] = host(v)
    res["reward_abs_mean"] = np.asarray(float(traj.reward.abs().mean()))
    for k, v in env_state_to_numpy(ts.env_state).items():
        res[f"farm/{k}"] = v.copy()
    res["generator"] = host(ts.generator.get_state())
    if mesh is not None and opts.get("save"):
        learner.save(opts["save"], ts)
    ts, _, _, times = take_step(learner, ts, timed=True)
    if mesh is not None:
        # `train`'s broadcast of the main rank's evaluation, rank r sending r + 0.25
        res["from_main"] = np.asarray(learner._from_main(torch.distributed.get_rank() + 0.25))
    res.update({f"time/{k}": np.asarray(v) for k, v in times.items()})
    res["launches"] = np.asarray(fs.launches - launches0)
    res["device"] = np.asarray(str(learner.env.device))
    return res


def run_rank(rank: int, world: int, opts: dict, out_dir: str):
    """One rank of the sharded step: join the group, take the step on the
    env mesh, write the results to `out_dir/rank<r>.npz`. Returns them."""
    import torch
    import torch.distributed as dist
    from heligym_tpu_torch.parallel import init_distributed, make_env_mesh
    if opts["cpu"]:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    local = 0 if opts["same_card"] else rank
    device = init_distributed(opts["address"], world, rank, local_rank=local,
                              cpu=opts["cpu"], backend=opts["backend"])
    try:
        res = step_results(device, opts, make_env_mesh())
    finally:
        dist.destroy_process_group()
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return res


def run_ranks(world: int, opts: dict, out_dir: str) -> list:
    """`world` processes, each one rank of the sharded step."""
    import importlib
    import torch.multiprocessing as mp
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    # the children find `run_rank` by this module's name, wherever this copy
    # of it was loaded from
    entry = importlib.import_module("torch_sharded_step").run_rank
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(entry, args=(world, opts, out_dir), nprocs=world, join=True)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def rel_err(a, b) -> float:
    """max |a - b| over b's largest magnitude."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def compare(base: dict, ranks: list, label: str) -> tuple:
    """Each rank against its columns of `base` (a run of the whole farm).
    Returns (report, failures)."""
    fails = []
    n_params = len([k for k in base if k.startswith("params/")])
    width = ranks[0]["traj/reward"].shape[1]
    rep = {"ranks": len(ranks), "envs_per_rank": width, "rollout_max_abs_diff": 0.0,
           "rollout_bit_equal": True, "discrete_equal": True}
    for r, res in enumerate(ranks):
        cols = slice(r * width, (r + 1) * width)
        for key in [k for k in base if k.startswith("traj/")]:
            name = key[5:]
            got, want = res[key], base[key][:, cols]
            if name in DISCRETE:
                if not np.array_equal(got, want):
                    rep["discrete_equal"] = False
                    fails.append(f"{label}: rank {r}'s {name} stream differs")
                continue
            both = np.isfinite(want)
            diff = float(np.abs(got - want)[both].max()) if both.any() else 0.0
            rep["rollout_max_abs_diff"] = max(rep["rollout_max_abs_diff"], diff)
            rep["rollout_bit_equal"] &= got.tobytes() == want.tobytes()
            try:
                np.testing.assert_allclose(got, want, **ROLLOUT_TOL.get(name, FLOAT_TOL))
            except AssertionError:
                fails.append(f"{label}: rank {r}'s {name} differs beyond tolerance "
                             f"(max |diff| {diff:.3e})")
        for name in ("params", "mu", "nu"):
            err = max(rel_err(res[f"{name}/{i}"], base[f"{name}/{i}"])
                      for i in range(n_params))
            rep[f"{name}_rel_err"] = max(rep.get(f"{name}_rel_err", 0.0), err)
            if err > REL_TOL:
                fails.append(f"{label}: rank {r}'s {name} differ by {err:.3e} of their scale")
        if int(res["count"]) != int(base["count"]):
            fails.append(f"{label}: rank {r}'s Adam count {int(res['count'])} != "
                         f"{int(base['count'])}")
        for k in ("loss", "reward_mean", "approx_kl", "success_ep_frac"):
            if not np.allclose(res[f"metric/{k}"], base[f"metric/{k}"], **METRIC_TOL):
                fails.append(f"{label}: rank {r}'s metric {k} {float(res[f'metric/{k}'])} "
                             f"!= {float(base[f'metric/{k}'])}")
        for k in [k for k in base if k.startswith("farm_metric/")]:
            atol = 1e-6 * float(base["reward_abs_mean"]) if k.endswith("reward_mean") else 0
            if not np.allclose(res[k], base[k], rtol=1e-6, atol=atol):
                fails.append(f"{label}: rank {r}'s {k} {float(res[k])} != {float(base[k])}")
        if res["generator"].tobytes() != base["generator"].tobytes():
            fails.append(f"{label}: rank {r}'s generator state differs")
        if "from_main" in res and float(res["from_main"]) != 0.25:
            fails.append(f"{label}: rank {r} got {float(res['from_main'])} from the main "
                         "rank's broadcast, not its 0.25")
    rep["metric_max_abs_diff"] = max(
        abs(float(res[f"metric/{k}"]) - float(base[f"metric/{k}"]))
        for res in ranks for k in ("loss", "reward_mean", "approx_kl", "success_ep_frac"))
    rep["generators_equal"] = not any("generator" in f for f in fails)
    rep["farm_metrics"] = {k[12:]: float(ranks[0][k]) for k in ranks[0]
                           if k.startswith("farm_metric/")}
    return rep, fails


def check_save(path: str, ranks: list, device) -> bool:
    """The sharded `save` at `path`, restored by one process, bit-equal to
    the ranks' farms put together and to rank 0's parameters and Adam."""
    from heligym_tpu_torch.convert import env_state_to_numpy
    from heligym_tpu_torch.learner import PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    n = sum(r["farm/steps"].shape[0] for r in ranks)
    env, _ = build_env("hover", None, "sea_alt=start", device=device)
    one = PPOLearner(env, stage1_config(n, ranks[0]["traj/reward"].shape[0]))
    back = one.restore(path, with_farm=True)
    farm = env_state_to_numpy(back.env_state)
    same = all(farm[k].tobytes() == np.concatenate([r[f"farm/{k}"] for r in ranks]).tobytes()
               for k in farm)
    tensors = (one.param_list(back.params), back.opt_state.mu, back.opt_state.nu)
    for name, ts in zip(("params", "mu", "nu"), tensors):
        same &= all(t.detach().cpu().numpy().tobytes() == ranks[0][f"{name}/{i}"].tobytes()
                    for i, t in enumerate(ts))
    return bool(same and int(back.opt_state.count) == int(ranks[0]["count"])
                and back.generator.get_state().numpy().tobytes()
                == ranks[0]["generator"].tobytes())


def timing_line(res: dict, label: str) -> str:
    t = {k[5:]: float(v) for k, v in res.items() if k.startswith("time/")}
    clock = "CUDA events" if str(res["device"]).startswith("cuda") else "host clock"
    return (f"[sharded] {label}: {res['traj/reward'].shape[1]} envs on {res['device']}: "
            f"train step {t['wall_ms']:.2f} ms (host clock) = collect {t['collect_ms']:.2f} "
            f"ms + update {t['update_ms']:.2f} ms ({clock}), of which all-reduces "
            f"{t['allreduce_ms']:.2f} ms in {int(t['allreduce_calls'])} calls "
            f"({int(t['allreduce_bytes'])} bytes); {int(res['launches'])} step-kernel steps")


def summary(res: dict) -> dict:
    return {k[5:]: float(v) for k, v in res.items() if k.startswith("time/")} | {
        "launches": int(res["launches"]), "device": str(res["device"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="nccl (default on the cards) or gloo (default with --cpu)")
    ap.add_argument("--same-card", action="store_true",
                    help="every rank on cuda:0 (gloo only: NCCL takes one rank per card)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--rollout-steps", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "sharded_step"))
    args = ap.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("no CUDA card: pass --cpu for the CPU rehearsal")
    opts = {"num_envs": args.num_envs, "rollout_steps": args.rollout_steps,
            "cpu": args.cpu, "same_card": args.same_card,
            "backend": args.backend or ("gloo" if args.cpu else "nccl"),
            "address": f"localhost:{free_port()}",
            "save": os.path.join(args.out, "sharded.npz")}
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    t0 = time.perf_counter()
    base = step_results(device, opts, None)
    print(timing_line(base, "one process, no mesh"), flush=True)
    ranks = run_ranks(args.ranks, opts, args.out)
    for r, res in enumerate(ranks):
        print(timing_line(res, f"rank {r}/{args.ranks} ({opts['backend']})"), flush=True)
    rep, fails = compare(base, ranks, f"{args.ranks} ranks")
    rep["save_restore_bit_equal"] = check_save(opts["save"], ranks, device)
    if not rep["save_restore_bit_equal"]:
        fails.append("the sharded save, restored in one process, differs from the ranks'")
    print(f"[check] sharded, {args.ranks} ranks vs one process: rollout discrete streams "
          f"equal {rep['discrete_equal']}, floats max |diff| {rep['rollout_max_abs_diff']:.3e} "
          f"(bit-equal {rep['rollout_bit_equal']}); params {rep['params_rel_err']:.3e}, mu "
          f"{rep['mu_rel_err']:.3e}, nu {rep['nu_rel_err']:.3e} of their scale (tolerance "
          f"{REL_TOL:g}); metrics max |diff| {rep['metric_max_abs_diff']:.3e}; generators "
          f"equal {rep['generators_equal']}; save -> restore bit-equal "
          f"{rep['save_restore_bit_equal']}", flush=True)
    out = {"ranks": args.ranks, "backend": opts["backend"], "same_card": args.same_card,
           "num_envs": args.num_envs, "rollout_steps": args.rollout_steps,
           "reference": summary(base), "per_rank": [summary(r) for r in ranks],
           "check": rep, "failures": fails, "wall_s": time.perf_counter() - t0}
    if not args.cpu:
        from heligym_tpu_torch.learner.train import card_line
        out["cards"] = [card_line(i) for i in range(torch.cuda.device_count())]
    print(json.dumps(out))
    if fails:
        sys.exit("sharded step FAILED:\n" + "\n".join(fails))


if __name__ == "__main__":
    main()
