"""The system under test: heligym_tpu_torch, built from a configuration file
and driven by a traffic file.

A traffic file names the entry it drives, and the entry is the file
`entries/<entry>.py`, found by that name. It holds `build(prog)` (the port's
objects for the entry), `unit(prog)` (one call of the entry, the unit of
the traffic), `record(prog, k)` (the first k units driven through the same
call, what each produced kept on the host for the reference to judge),
`span_targets(prog)` (the methods the traced run times) and
`unit_flops(ctx)`. The farm, the weights (the configuration's committed
checkpoint) and the generator of every random draw are made here and in
the entry from the seed; the helpers below are shared by the entries.
"""
from __future__ import annotations

import gc
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reference.check import TRAJ_FLAGS, TRAJ_FLOATS
from reference.sim.state import HELI_STATE_FIELDS, WIND_STATE_FIELDS

from . import spec
from .spec import ROOT


def seed_of(seed: int) -> int:
    return int(seed) % (2 ** 63)


def carry_of(es) -> torch.Tensor:
    """The farm's state as rows (63, B): heli, wind, obs, dots, wind,
    steps, successed steps."""
    rows = ([getattr(es.heli, f) for f in HELI_STATE_FIELDS]
            + [getattr(es.wind, f) for f in WIND_STATE_FIELDS]
            + list(es.obs.T) + [getattr(es.dots, f) for f in HELI_STATE_FIELDS]
            + list(es.wind_ned.T)
            + [es.steps.to(torch.float32), es.successed_steps.to(torch.float32)])
    return torch.stack(rows).to("cpu", copy=True)


def cpu(x):
    return x.detach().to("cpu", copy=True)


def traj_record(traj) -> dict:
    """A rollout's streams on the host (the layout of `reference.check`)."""
    out = {k: cpu(getattr(traj, k)) for k in TRAJ_FLOATS}
    out.update({k: cpu(getattr(traj, k) != 0) for k in TRAJ_FLAGS})
    return out


def build_learner(prog) -> None:
    """`PPOLearner` of the configuration's PPO settings on `prog.env`, its
    train state from the seed with the committed checkpoint's parameters,
    Adam state and statistics, the update counter at the configuration's
    `start_update`, and the train state's generator `prog.gen`."""
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner

    config = prog.config
    cfg = PPOConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in prog.ppo.items()})
    prog.learner = PPOLearner(prog.env, cfg)
    ids = (np.arange(prog.n) % len(config["tasks"]) if len(config["tasks"]) > 1 else None)
    ts = prog.learner.init(torch.Generator().manual_seed(prog.seed), task_ids=ids)
    ck = prog.learner.restore(os.path.join(ROOT, config["policy"]),
                              farm_size=int(config["policy_farm"]))
    ts = ts.replace(params=ck.params, opt_state=ck.opt_state, obs_stats=ck.obs_stats,
                    update_count=int(config.get("start_update", 0)), generator=prog.gen)
    if config.get("set_log_std") is not None:
        with torch.no_grad():
            ts.params.log_std.fill_(float(config["set_log_std"]))
    prog.ts = ts
    prog.env_steps_per_unit = prog.n * cfg.rollout_steps


class Program:
    """One cell's system under test on `device`; `overrides` replaces
    configuration or traffic sizes (the CPU tests run a tiny farm); `here`
    is the perfbench/ directory whose `entries/` it reads."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 overrides: Optional[dict] = None, here: str = spec.HERE):
        from heligym_tpu_torch.learner.evaluate import build_env

        self.config, self.traffic = config, dict(traffic)
        self.device = torch.device(device)
        self.ppo = dict(config["ppo"])
        for k, v in (overrides or {}).items():
            (self.ppo if k in self.ppo else self.traffic)[k] = v
        self.entry = self.traffic["entry"]
        self.entry_mod = spec.entry(self.entry, here)
        self.seed = seed_of(seed)
        self.n = int(self.ppo["num_envs"])
        tasks = config["tasks"]
        self.env, _ = build_env(task=tasks[0], tasks=",".join(tasks) if len(tasks) > 1 else None,
                                target=config.get("target"), device=self.device,
                                turb_level=config.get("turbulence_level"),
                                heli=config["airframe"])
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.env_steps_per_unit = 0
        self.entry_mod.build(self)
        self.spans: Dict[str, List] = {}

    def unit(self):
        """One call of the entry; returns what it produced."""
        return self.entry_mod.unit(self)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, k: int) -> List[dict]:
        """Drive the first `k` units and keep, on the host, what each
        produced (the layout of the reference's side of the entry)."""
        return self.entry_mod.record(self, k)

    # -- spans ---------------------------------------------------------------------
    def instrument(self, timing: bool) -> None:
        """Spans around the entry's `span_targets` (a train step's `collect`
        and `update`) and around each unit: a profiler range, and with
        `timing` a pair of CUDA events per call, read after the window."""
        from torch.profiler import record_function

        def wrap(obj, name):
            fn = getattr(obj, name)
            self.spans[name] = []

            def spanned(*a, **kw):
                ev = None
                if timing:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                with record_function(name):
                    out = fn(*a, **kw)
                if ev is not None:
                    ev[1].record()
                    self.spans[name].append(ev)
                return out
            setattr(obj, name, spanned)

        for obj, name in self.entry_mod.span_targets(self):
            wrap(obj, name)
        wrap(self, "unit")

    def span_ms(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.spans.items()}

    def free(self) -> None:
        for name in ("learner", "ts", "es", "roll", "actions", "env"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(unit: Callable, sync: Callable, seconds: float, clock) -> Dict[str, float]:
    """Units back to back for `seconds` of the host clock, then one wait for
    the device: the window closes when the last unit dispatched has run."""
    sync()
    t0 = clock()
    n = 0
    while clock() - t0 < seconds:
        unit()
        n += 1
    sync()
    return {"units": n, "seconds": clock() - t0}
