"""The trainer's command line, its start-condition samplers, and what the
evaluator's command line shares with it (the task registry and the
task-target parser).

    python -m heligym_tpu_torch.learner.train --task hover --num-envs 1024 --updates 200
    python -m heligym_tpu_torch.learner.train --tasks hover,landing --num-envs 2048
    python -m heligym_tpu_torch.learner.train --task landing --rand-start-alt 6:55 \
        --eval-every 4 --eval-start-band --eval-episodes 256

The flags, their defaults and the printed lines are the JAX package's
(`heligym_tpu.learner.train`). The run takes the CUDA card, or the CPU with
`--cpu`; `--seed` seeds a CPU `torch.Generator` that seeds the network and
the run's generators. `--tasks a,b,...` trains one task-conditioned policy
on a MixedTask batch (per-env task ids, round-robin). `--randomized-resets`,
`--rand-start-alt` and `--rand-start-yaw` draw per-env initial conditions
through the batched Newton trim at farm reset; each env's auto-reset then
returns it to its own start.

On several cards, one process per card under `torchrun`:

    torchrun --standalone --nproc_per_node=N -m heligym_tpu_torch.learner.train ...

Each rank takes `cuda:LOCAL_RANK` (or the CPU with `--cpu`, over gloo), the
farm of `--num-envs` is split over the ranks (`parallel/`), and the main
rank alone prints, evaluates and writes checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..envs import HeliEnv
from ..envs.tasks import (ForwardFlightTask, HoverTask, LandingTask, MixedTask,
                          ObliqueFlightTask, SlalomTask, TurningFlightTask)
from ..ops import terrain as terrain_ops
from .ppo import PPOConfig, PPOLearner

TASKS = {"hover": HoverTask, "forward": ForwardFlightTask,
         "oblique": ObliqueFlightTask, "turning": TurningFlightTask,
         "slalom": SlalomTask, "landing": LandingTask}


# Start-condition samplers: `sampler(generator, n)` -> a dict of batched
# trim conditions (`envs.trim.trim_batched`) on the generator's device.

def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _conds(n: int, device, **fields) -> dict:
    """The default hover-trim condition for n envs (zero speed, yaw and
    rotor azimuths, map origin, 100 ft above ground), with `fields` over
    it."""
    z = torch.zeros(n, device=device)
    conds = {"yaw": z, "yaw_rate": z, "ned_vel": torch.zeros((n, 3), device=device),
             "gr_alt": torch.full((n,), 100.0, device=device),
             "xy": torch.zeros((n, 2), device=device), "psi_mr": z, "psi_tr": z}
    conds.update(fields)
    return conds


def default_cond_sampler(generator: torch.Generator, n: int) -> dict:
    """Randomized trim conditions: heading anywhere, gentle forward speed,
    broad altitude band, positions across the middle third of the map."""
    yaw = _uniform(generator, (n,), -math.pi, math.pi)
    speed = _uniform(generator, (n,), 0.0, 50.0)
    ned_vel = torch.stack([speed * torch.cos(yaw), speed * torch.sin(yaw),
                           torch.zeros_like(speed)], dim=-1)
    gr_alt = _uniform(generator, (n,), 50.0, 2000.0)
    xy = _uniform(generator, (n, 2), -3000.0, 3000.0)
    psi = _uniform(generator, (n, 2), 0.0, 2 * math.pi)
    return _conds(n, generator.device, yaw=yaw, ned_vel=ned_vel, gr_alt=gr_alt,
                  xy=xy, psi_mr=psi[:, 0], psi_tr=psi[:, 1])


def make_alt_band_sampler(lo: float, hi: float):
    """Randomizes only the start altitude, uniform in [lo, hi] ft above
    ground, the default hover-trim condition otherwise. The landing
    curriculum's anchor: a fixed start altitude leaves every altitude above
    it out of distribution, so the policy hovers instead of descending when
    started higher; a band keeps known descents in every rollout while the
    upper edge extends the behaviour."""
    def sampler(generator, n):
        return _conds(n, generator.device, gr_alt=_uniform(generator, (n,), lo, hi))
    return sampler


def make_yaw_band_sampler(lo: float, hi: float, alt_band=None):
    """Randomizes the start heading uniformly in [lo, hi] rad (and, with
    `alt_band`, the start altitude): a fixed heading gives a course-tracking
    task one long turn to discover before any positive signal; a band puts
    some envs near the course in every rollout."""
    def sampler(generator, n):
        yaw = _uniform(generator, (n,), lo, hi)
        if alt_band:
            return _conds(n, generator.device, yaw=yaw,
                          gr_alt=_uniform(generator, (n,), *alt_band))
        return _conds(n, generator.device, yaw=yaw)
    return sampler


def make_alt_grid_sampler(lo: float, hi: float):
    """A deterministic start-altitude grid, `linspace(lo, hi, n)` (the
    generator gives only the device), for the periodic evaluator of a band
    run: selecting on one altitude picks a policy overfit to it; an evenly
    spaced grid makes best-tracking reward the whole band."""
    def sampler(generator, n):
        grid = torch.from_numpy(np.linspace(lo, hi, n).astype(np.float32))
        return _conds(n, generator.device, gr_alt=grid.to(generator.device))
    return sampler


def _parse_target(spec: str, env) -> dict:
    """'k=v,...' task-target overrides; the value 'start' resolves to the
    default trim condition's start altitude (terrain + gear touch + 100 ft
    gr_alt), 'ground' to the gear-contact altitude itself, both computed on
    the CPU; 'ground+N' / 'start+N' add an offset (e.g. touch_alt=ground+30
    turns LandingTask's per-step success gate into an N-ft station-keep)."""
    def _contact_alt() -> float:
        zero = torch.zeros((), dtype=torch.float32)
        return float(terrain_ops.ground_touching_altitude(
            env.params, env.terrain.to("cpu"), zero, zero))

    updates = {}
    for kv in spec.split(","):
        k, v = (s.strip() for s in kv.split("="))
        base, off = v, 0.0
        if "+" in v:
            base, off_s = v.split("+", 1)
            off = float(off_s)
        if base == "start":
            val = _contact_alt() + 100.0 + off
        elif base == "ground":
            val = _contact_alt() + off
        else:
            val = float(v)
        updates[k] = val
    return updates


def card_line(index: int = 0) -> Optional[str]:
    """Card `index`'s name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[index] if res.returncode == 0 and index < len(lines) else None


def describe_device(dev: torch.device, with_index: bool = False) -> str:
    """The device a run uses; a card as `nvidia-smi` names it, with its
    power limit (and its index, with `with_index`)."""
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = card_line(index) or torch.cuda.get_device_name(index)
    return f"cuda:{index}: {name}" if with_index else f"cuda: {name}"


def join_run(cpu: bool):
    """Under `torchrun` (WORLD_SIZE > 1 in the environment): join the run
    (`parallel.init_distributed`, NCCL on the cards, gloo with `cpu`) and
    return (this rank's device, the env mesh, the devices of every rank);
    otherwise (None, None, None)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None, None, None
    from ..parallel import init_distributed, make_env_mesh
    rank = int(os.environ["RANK"])
    device = init_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                              world, rank, local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                              cpu=cpu)
    mesh = make_env_mesh()
    names = [None] * world
    torch.distributed.all_gather_object(names, describe_device(device, True))
    return device, mesh, names


def _band(spec: str):
    return tuple(float(v) for v in spec.split(":"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=sorted(TASKS), default="hover")
    ap.add_argument("--tasks", default=None,
                    help="comma list -> one task-conditioned MixedTask policy "
                         "(overrides --task), e.g. 'hover,landing'")
    ap.add_argument("--task-weights", default=None,
                    help="comma ints, env-count ratio per sub-task (default "
                         "uniform round-robin), e.g. '3,1' gives the first "
                         "task 3x the envs — use to protect a fragile task "
                         "from a dominant one's gradient share")
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--rollout-steps", type=int, default=64)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--ent-coef", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=8)
    ap.add_argument("--anneal", type=int, default=0,
                    help="linear lr/entropy decay horizon in updates "
                         "(0 = constant)")
    ap.add_argument("--shuffle", choices=("roll", "perm"), default="perm",
                    help="epoch minibatch shuffle (roll: one shifted "
                         "order; perm: a fresh permutation per epoch)")
    ap.add_argument("--no-obs-norm", action="store_true",
                    help="disable running-stat observation normalization")
    ap.add_argument("--freeze-obs-stats", action="store_true",
                    help="apply but stop updating the running obs stats — "
                         "use when fine-tuning a checkpoint (a fresh farm's "
                         "early rollouts shift the stats and silently "
                         "perturb the policy's effective inputs)")
    ap.add_argument("--no-center-actions", action="store_true",
                    help="policy outputs absolute actions instead of "
                         "residuals around the nominal trim action")
    ap.add_argument("--log-std-init", type=float, default=-0.5,
                    help="initial policy log-std (lower = gentler early "
                         "exploration; the heli is an unstable plant)")
    ap.add_argument("--success-bonus", type=float, default=0.0,
                    help="training-only shaping: + per in-tolerance step "
                         "(the success criterion's own increment)")
    ap.add_argument("--fail-penalty", type=float, default=0.0,
                    help="training-only shaping: - on crash/OOB transitions")
    ap.add_argument("--agl-shaping", type=float, default=0.0,
                    help="potential-based descent shaping coefficient "
                         "(landing; Phi = -alt-above-ground)")
    ap.add_argument("--flare-shaping", type=float, default=0.0,
                    help="potential-based flare shaping coefficient "
                         "(landing; Phi = -|down_vel| * exp(-agl/scale): "
                         "pays for killing descent rate near the ground — "
                         "breaks the gear-window bounce limit-cycle)")
    ap.add_argument("--flare-scale", type=float, default=10.0,
                    help="e-folding altitude [ft] of the flare zone")
    ap.add_argument("--prof-shaping", type=float, default=0.0,
                    help="potential-based descent-profile shaping "
                         "coefficient (high-altitude landing; Phi = "
                         "-|down_vel - v_ref(agl)| with v_ref = vmax * "
                         "(1 - exp(-agl/scale)): penalizes hovering at "
                         "altitude AND diving — the safe-approach gradient "
                         "the reference reward lacks)")
    ap.add_argument("--prof-vmax", type=float, default=7.0,
                    help="asymptotic descent rate [ft/s] of the profile")
    ap.add_argument("--prof-scale", type=float, default=25.0,
                    help="e-folding altitude [ft] of the profile taper")
    ap.add_argument("--vel-shaping", type=float, default=0.0,
                    help="training-only potential shaping toward a "
                         "horizontal NED velocity VECTOR (oblique/"
                         "directional tasks; Phi = -|v - target| ft/s). "
                         "Target defaults to the task's course: vel * "
                         "(cos, sin)(heading + azimuth) when those fields "
                         "exist, else --vel-target")
    ap.add_argument("--vel-target", type=str, default=None, metavar="N:E",
                    help="explicit shaping velocity target [ft/s]")
    ap.add_argument("--track-shaping", type=float, default=0.0,
                    help="training-only potential shaping onto the slalom "
                         "weave reference (Phi = -|y - A sin(2 pi x / L)| "
                         "ft; A/L from the task fields)")
    ap.add_argument("--vf-clip", type=float, default=0.2,
                    help="value-loss clip range (0 = no value clipping; "
                         "use 0 with --success-bonus, returns are O(100))")
    ap.add_argument("--target-kl", type=float, default=0.0,
                    help="skip minibatch updates past this approx KL "
                         "(0 = off)")
    ap.add_argument("--critic-warmup", type=int, default=0,
                    help="freeze the actor for the first N updates while "
                         "the critic (and obs stats, unless frozen) re-fit "
                         "— REQUIRED when fine-tuning a checkpoint on a "
                         "fresh farm: the transplanted critic's garbage "
                         "early advantages drift the actor's mean "
                         "invisibly in KL (see PPOConfig.critic_warmup)")
    ap.add_argument("--std-cap-updates", type=int, default=0,
                    help="anneal an exploration-std ceiling from "
                         "--log-std-init to --std-cap-final over N updates "
                         "(0 = off); forces the MEAN policy to carry "
                         "noise-dependent behavior")
    ap.add_argument("--std-cap-final", type=float, default=-3.5)
    ap.add_argument("--randomized-resets", action="store_true",
                    help="per-env randomized initial trim conditions")
    ap.add_argument("--target", default=None,
                    help="task target override, 'k=v,...' (the CLI face of "
                         "the reference's set_target, helicopter.py:100-106) "
                         "e.g. --target sea_alt=1640. 'start' for sea_alt "
                         "resolves to the trim start altitude.")
    ap.add_argument("--start-alt", type=float, default=None,
                    help="initial trim altitude above ground [ft] "
                         "(default 100; e.g. 25 for a landing curriculum)")
    ap.add_argument("--max-time", type=float, default=None,
                    help="episode wall [s] (the reference's set_max_time, "
                         "helicopter.py:89-92; success requires "
                         "max_time/4 s of accumulated tolerance — a longer "
                         "budget means MORE required settle time, but "
                         "gives high-altitude landings room to descend at "
                         "a safe rate)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the step's plain version) instead "
                         "of the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="path to save (and periodically update) the full "
                         "training state")
    ap.add_argument("--resume", default=None,
                    help="path of a checkpoint to resume from")
    ap.add_argument("--resume-num-envs", type=int, default=None,
                    help="the checkpoint's num_envs when scaling the farm "
                         "up/down on resume: transplants only params/"
                         "optimizer/obs-stats (schedules restart)")
    ap.add_argument("--rand-start-alt", type=str, default=None,
                    metavar="LO:HI",
                    help="randomize each env's start altitude uniformly in "
                         "[LO, HI] ft AGL via the on-device batched trim "
                         "(landing curriculum band; overrides --start-alt "
                         "for the farm — the periodic evaluator still uses "
                         "--start-alt)")
    ap.add_argument("--rand-start-yaw", type=str, default=None,
                    metavar="LO:HI",
                    help="randomize each env's start heading uniformly in "
                         "[LO, HI] rad (heading-band curriculum for "
                         "course-tracking tasks; composes with "
                         "--rand-start-alt)")
    ap.add_argument("--turb-level", type=int, default=None,
                    help="override the Dryden turbulence level (1..7) for "
                         "TRAINING only — the periodic evaluator still runs "
                         "at the model's nominal level (train hard, test "
                         "easy: hardens hover against gust-tail failures)")
    ap.add_argument("--eval-turb-level", type=int, default=None,
                    help="turbulence level of the periodic evaluator when "
                         "it should differ from --turb-level's "
                         "train-hard/select-nominal default — e.g. train "
                         "at 3, SELECT at 2 to best-track turbulence "
                         "robustness itself")
    ap.add_argument("--eval-start-band", action="store_true",
                    help="with --rand-start-alt LO:HI and --eval-every: "
                         "evaluate on a deterministic linspace(LO, HI) "
                         "altitude grid instead of the single --start-alt "
                         "point, so best-tracking selects band-wide "
                         "generalization")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="every N updates run the TRUE deterministic "
                         "evaluator (fresh episodes to first termination) "
                         "and best-track on its success_frac instead of the "
                         "selection-biased in-training success_ep_frac "
                         "(see PPOLearner.train)")
    ap.add_argument("--eval-episodes", type=int, default=64)
    ap.add_argument("--reset-schedules", action="store_true",
                    help="on a same-size --resume, zero the restored "
                         "update_count so --anneal/--critic-warmup/"
                         "--std-cap-updates count from 0 instead of the "
                         "checkpoint's counter (scale-up resumes already "
                         "restart schedules)")
    ap.add_argument("--set-log-std", type=float, default=None,
                    help="on --resume, overwrite the restored policy's "
                         "learned log-std (std surgery for staged "
                         "consolidation; see PPOLearner.train)")
    ap.add_argument("--fresh-farm", action="store_true",
                    help="on --resume, keep the checkpoint's network/"
                         "optimizer but re-initialize the env farm — "
                         "REQUIRED for a --start-alt curriculum (a full "
                         "restore brings back the old reset snapshots)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.eval_start_band and not args.rand_start_alt:
        # without a band the evaluator would fall back to the single
        # --start-alt point and report numbers with no band selection
        ap.error("--eval-start-band requires --rand-start-alt LO:HI "
                 "(the eval grid spans the training band)")

    task_ids = None
    if args.tasks:
        names = [s.strip() for s in args.tasks.split(",") if s.strip()]
        task = MixedTask(tasks=tuple(TASKS[n]() for n in names))
        if args.task_weights:
            w = [int(v) for v in args.task_weights.split(",")]
            if len(w) != len(names):
                ap.error("--task-weights needs one weight per task")
            if any(v <= 0 for v in w):
                # a 0 weight would give that sub-task no training envs while
                # it still counts in the evaluation's per-task minimum
                ap.error("--task-weights values must be positive integers")
            pattern = np.repeat(np.arange(len(names)), w)
            task_ids = np.tile(pattern,
                               args.num_envs // len(pattern) + 1)[:args.num_envs]
        else:
            task_ids = np.arange(args.num_envs) % len(names)
        label = "+".join(names)
    else:
        task = TASKS[args.task]()
        label = args.task

    device, mesh, rank_devices = join_run(args.cpu)
    is_main = mesh is None or torch.distributed.get_rank() == 0
    env = HeliEnv.build("aw109", task=task, device=device or ("cpu" if args.cpu else None))
    if args.max_time is not None:
        env = env.replace(max_time=args.max_time)
        label += f"@T{args.max_time:g}"
    if args.target:
        updates = _parse_target(args.target, env)
        if args.tasks:
            # each key goes to the sub-tasks that carry that target field
            subs = tuple(t.with_target(**{k: v for k, v in updates.items()
                                          if k in t.target_dict()})
                         for t in task.tasks)
            task = MixedTask(tasks=subs)
        else:
            task = task.with_target(**updates)
        env = env.replace(task=task)
        label += f"@{args.target}"
    eval_env = None
    if args.turb_level is not None:
        # train under stronger turbulence, select at the model's nominal
        # level; the mean wind is unchanged, so the two envs share the trim
        eval_env = env
        env = env.replace(wind_params=dataclasses.replace(
            env.wind_params, turbulence_level=args.turb_level))
        label += f"+turb{args.turb_level}"
    if args.eval_turb_level is not None:
        eval_env = (eval_env or env).replace(wind_params=dataclasses.replace(
            env.wind_params, turbulence_level=args.eval_turb_level))
        label += f"/ev{args.eval_turb_level}"
    vel_tn = vel_te = 0.0
    if args.vel_shaping:
        if args.vel_target:
            vel_tn, vel_te = (float(v) for v in args.vel_target.split(":"))
        else:
            t = env.task
            course = getattr(t, "heading", 0.0) + getattr(t, "azimuth", 0.0)
            vel = getattr(t, "vel", None)
            if vel is None:
                ap.error("--vel-shaping needs --vel-target N:E for tasks "
                         "without a vel field")
            vel_tn = vel * math.cos(course)
            vel_te = vel * math.sin(course)
        if is_main:
            print(f"vel shaping target: ({vel_tn:.1f}, {vel_te:.1f}) ft/s",
                  flush=True)
    track_amp, track_wl = 150.0, 2000.0
    if args.track_shaping:
        track_amp = getattr(env.task, "amplitude", track_amp)
        track_wl = getattr(env.task, "wavelength", track_wl)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                    lr=args.lr, gamma=args.gamma, ent_coef=args.ent_coef,
                    epochs=args.epochs, minibatches=args.minibatches,
                    anneal_updates=args.anneal, shuffle=args.shuffle,
                    obs_norm=not args.no_obs_norm,
                    freeze_obs_stats=args.freeze_obs_stats,
                    center_actions=not args.no_center_actions,
                    log_std_init=args.log_std_init,
                    success_bonus=args.success_bonus,
                    fail_penalty=args.fail_penalty,
                    agl_shaping=args.agl_shaping,
                    flare_shaping=args.flare_shaping,
                    flare_scale=args.flare_scale,
                    prof_shaping=args.prof_shaping,
                    prof_vmax=args.prof_vmax, prof_scale=args.prof_scale,
                    vel_shaping=args.vel_shaping,
                    vel_target_n=vel_tn, vel_target_e=vel_te,
                    track_shaping=args.track_shaping,
                    track_amplitude=track_amp, track_wavelength=track_wl,
                    vf_clip_eps=args.vf_clip,
                    target_kl=args.target_kl,
                    critic_warmup=args.critic_warmup,
                    std_cap_updates=args.std_cap_updates,
                    std_cap_final=args.std_cap_final)
    learner = PPOLearner(env, cfg, mesh=mesh)
    if is_main:
        print(f"devices: [{', '.join(rank_devices or [describe_device(env.device)])}]  "
              f"task: {label}  envs: {cfg.num_envs}  "
              f"steps/update: {cfg.num_envs * cfg.rollout_steps}  "
              f"fused: {cfg.use_fused_rollout}", flush=True)
    if args.rand_start_yaw:
        cond_sampler = make_yaw_band_sampler(
            *_band(args.rand_start_yaw),
            alt_band=_band(args.rand_start_alt) if args.rand_start_alt else None)
    elif args.rand_start_alt:
        cond_sampler = make_alt_band_sampler(*_band(args.rand_start_alt))
    elif args.randomized_resets:
        cond_sampler = default_cond_sampler
    else:
        cond_sampler = None
    t0 = time.time()
    ts, history = learner.train(
        torch.Generator().manual_seed(args.seed), args.updates,
        log_every=args.log_every,
        trim_cond=({"gr_alt": args.start_alt}
                   if args.start_alt is not None else None),
        cond_sampler=cond_sampler,
        task_ids=task_ids,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume,
        fresh_farm=args.fresh_farm,
        resume_num_envs=args.resume_num_envs,
        reset_schedules=args.reset_schedules,
        set_log_std=args.set_log_std,
        eval_every=args.eval_every,
        eval_episodes=args.eval_episodes,
        eval_env=eval_env,
        eval_cond_sampler=(make_alt_grid_sampler(*_band(args.rand_start_alt))
                           if args.eval_start_band else None))
    dt = time.time() - t0
    total_steps = args.updates * cfg.num_envs * cfg.rollout_steps
    if is_main:
        print(f"trained {total_steps} env-steps in {dt:.1f}s "
              f"({total_steps / dt:.0f} steps/s incl. learner)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump({"config": vars(args), "history": history}, f)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
