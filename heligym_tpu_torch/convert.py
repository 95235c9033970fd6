"""Carry env state, parameters and policies across frameworks as numpy arrays.

Nothing here imports the JAX package: a JAX `EnvState` crosses as a dict of
numpy arrays (`env_state_from_numpy`, `env_state_to_numpy`),
`params_to_numpy` reads only public dataclass fields, so it flattens either
package's `HeliParams`, and a flax parameter dict and optax's Adam state
cross as nested numpy arrays in the flax layout (`policy_from_numpy`,
`policy_to_numpy`, `adam_state_from_numpy`, `adam_state_to_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .envs.env import EnvState, ResetSnapshot
from .ops.state import HeliState, WindState

# Keys of the flattened state: (B, n) float arrays of the fields in
# HELI_STATE_FIELDS / WIND_STATE_FIELDS order, (B,) integer counters. The
# optional key "task_id" (B,) carries the MixedTask selector (zeros if absent).
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
                    init=init,
                    task_id=i32("task_id") if "task_id" in arrays else None)


def env_state_to_numpy(es: EnvState) -> Dict[str, np.ndarray]:
    """A batched EnvState flattened to numpy: the inverse of
    `env_state_from_numpy` (`STATE_KEYS` plus "task_id")."""
    wind = lambda w: w.flatten().detach().cpu().numpy()
    arr = lambda x: x.detach().cpu().numpy()
    return {"heli": arr(es.heli.flatten()), "wind": wind(es.wind),
            "dots": arr(es.dots.flatten()), "obs": arr(es.obs),
            "wind_ned": arr(es.wind_ned), "steps": arr(es.steps),
            "successed_steps": arr(es.successed_steps),
            "init.heli": arr(es.init.heli.flatten()), "init.wind": wind(es.init.wind),
            "init.dots": arr(es.init.dots.flatten()), "init.obs": arr(es.init.obs),
            "init.wind_ned": arr(es.init.wind_ned), "task_id": arr(es.task_id)}


def flax_tree_of(net, tensors) -> Dict[str, object]:
    """`tensors` (one per parameter of `net`, in `net.flax_leaves()` order
    and in the parameters' layouts) as a flax parameter tree of numpy
    arrays: kernels transposed to (in, out)."""
    tree: Dict[str, object] = {}
    for (name, leaf, _), t in zip(net.flax_leaves(), tensors):
        a = t.detach().cpu().numpy()
        if leaf is None:
            tree[name] = a
        else:
            tree.setdefault(name, {})[leaf] = np.ascontiguousarray(a.T) \
                if leaf == "kernel" else a
    return tree


def tensors_from_flax_tree(net, tree, device):
    """The inverse of `_flax_tree`: one tensor per parameter of `net`."""
    out = []
    for name, leaf, p in net.flax_leaves():
        a = np.asarray(tree[name] if leaf is None else tree[name][leaf], np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a.T if leaf == "kernel" else a))
        if t.shape != p.shape:
            raise ValueError(f"{name}.{leaf}: {tuple(a.shape)} does not fit "
                             f"a parameter of shape {tuple(p.shape)}")
        out.append(t.to(device))
    return out


def policy_to_numpy(net) -> Dict[str, object]:
    """An `ActorCritic`'s parameters as the JAX network's flax dict: the
    inverse of `policy_from_numpy`."""
    return flax_tree_of(net, [p for _, _, p in net.flax_leaves()])


def adam_state_to_numpy(net, state) -> Dict[str, object]:
    """The learner's `AdamState` (moments in `net.flax_leaves()` order) as
    optax's ScaleByAdamState in numpy: {"count" () int32, "mu", "nu"}, the
    moments as flax trees of `net`'s parameters."""
    return {"count": np.asarray(state.count.detach().cpu().numpy(), np.int32),
            "mu": flax_tree_of(net, state.mu), "nu": flax_tree_of(net, state.nu)}


def adam_state_from_numpy(net, arrays: Dict[str, object], device="cpu"):
    """The inverse of `adam_state_to_numpy`, onto `device`."""
    from .learner.optim import AdamState

    return AdamState(count=torch.tensor(int(np.asarray(arrays["count"])),
                                        dtype=torch.int32, device=device),
                     mu=tensors_from_flax_tree(net, arrays["mu"], device),
                     nu=tensors_from_flax_tree(net, arrays["nu"], device))


def policy_from_numpy(params: Dict[str, dict], device="cpu"):
    """An `ActorCritic` holding a flax parameter dict of the JAX package's
    network: {"Dense_i": {"kernel" (in, out), "bias"}, ..., "log_std"}. With
    L hidden layers, Dense_0..Dense_{L-1} is the actor torso, Dense_L the
    mean head, Dense_{L+1}..Dense_{2L} the critic torso, Dense_{2L+1} the
    value head. A flax kernel (in, out) becomes an `nn.Linear` weight
    (out, in)."""
    from .learner.networks import ActorCritic

    n_dense = sum(k.startswith("Dense_") for k in params)
    if n_dense < 4 or n_dense % 2 or set(params) != (
            {f"Dense_{i}" for i in range(n_dense)} | {"log_std"}):
        raise ValueError(f"not the parameters of an ActorCritic: {sorted(params)}")
    n_hidden = n_dense // 2 - 1
    kernels = [np.asarray(params[f"Dense_{i}"]["kernel"]) for i in range(n_dense)]
    net = ActorCritic(in_dim=kernels[0].shape[0],
                      action_dim=kernels[n_hidden].shape[1],
                      hidden=tuple(k.shape[1] for k in kernels[:n_hidden]))
    with torch.no_grad():
        for i, lin in enumerate(net.dense_layers()):
            weight = torch.from_numpy(np.ascontiguousarray(kernels[i].T))
            bias = torch.from_numpy(np.asarray(params[f"Dense_{i}"]["bias"]))
            if weight.shape != lin.weight.shape or bias.shape != lin.bias.shape:
                raise ValueError(f"Dense_{i}: kernel {kernels[i].shape} does not "
                                 f"fit a layer of weight {tuple(lin.weight.shape)}")
            lin.weight.copy_(weight)
            lin.bias.copy_(bias)
        net.log_std.copy_(torch.from_numpy(np.asarray(params["log_std"])))
    return net.to(device)


def obs_stats_from_numpy(stats: Dict[str, np.ndarray], device="cpu"):
    """The port's `ObsStats` from {"mean" (17,), "var" (17,), "count" ()}."""
    from .learner.ppo import ObsStats

    f32 = lambda k: torch.tensor(np.asarray(stats[k], np.float32), device=device)
    return ObsStats(mean=f32("mean"), var=f32("var"), count=f32("count"))


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
