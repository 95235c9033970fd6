"""Carry env state and parameters across frameworks as numpy arrays.

Nothing here imports the JAX package: a JAX `EnvState` crosses as a dict of
numpy arrays (see `env_state_from_numpy`), and `params_to_numpy` reads only
public dataclass fields, so it flattens either package's `HeliParams`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .envs.env import EnvState, ResetSnapshot
from .ops.state import HeliState, WindState

# Keys of the flattened state: (B, n) float arrays of the fields in
# HELI_STATE_FIELDS / WIND_STATE_FIELDS order, (B,) integer counters.
STATE_KEYS = ("heli", "wind", "dots", "obs", "wind_ned", "steps",
              "successed_steps", "init.heli", "init.wind", "init.dots",
              "init.obs", "init.wind_ned")


def env_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> EnvState:
    """The port's EnvState from a state flattened to numpy (`STATE_KEYS`)."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"flattened state lacks {missing}")
    f32 = lambda k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
    i32 = lambda k: torch.tensor(np.asarray(arrays[k], np.int32), device=device)
    init = ResetSnapshot(heli=HeliState.unflatten(f32("init.heli")),
                         wind=WindState.unflatten(f32("init.wind")),
                         dots=HeliState.unflatten(f32("init.dots")),
                         obs=f32("init.obs"), wind_ned=f32("init.wind_ned"))
    return EnvState(heli=HeliState.unflatten(f32("heli")),
                    wind=WindState.unflatten(f32("wind")),
                    dots=HeliState.unflatten(f32("dots")),
                    obs=f32("obs"), wind_ned=f32("wind_ned"),
                    steps=i32("steps"), successed_steps=i32("successed_steps"),
                    init=init)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """Flatten a HeliParams (of either package) to {"GROUP.FIELD": array}."""
    out = {}
    for group in dataclasses.fields(params):
        sub = getattr(params, group.name)
        if not dataclasses.is_dataclass(sub):
            continue
        for f in dataclasses.fields(sub):
            out[f"{group.name}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out
