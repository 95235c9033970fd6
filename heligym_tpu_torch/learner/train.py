"""What the evaluator's command line shares with the trainer's: the task
registry and the task-target parser. (The training loop is
`PPOLearner.train`; the trainer's command line is not in the port yet.)"""
from __future__ import annotations

import torch

from ..envs.tasks import (ForwardFlightTask, HoverTask, LandingTask,
                          ObliqueFlightTask, SlalomTask, TurningFlightTask)
from ..ops import terrain as terrain_ops

TASKS = {"hover": HoverTask, "forward": ForwardFlightTask,
         "oblique": ObliqueFlightTask, "turning": TurningFlightTask,
         "slalom": SlalomTask, "landing": LandingTask}


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
