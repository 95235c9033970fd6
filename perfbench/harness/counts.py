"""The yardstick's arithmetic: the work a unit of each traffic needs,
counted from shapes, and the device's peaks.

`count_elementwise_ops` is `chip_smoke.py`'s counter, copied: the floating
operations a function executes, per output element summed over its ATen
calls, data movement excluded. The env step's operations are counted on the
reference's plain step (`reference.sim.env.Sim.step`), so that the roofline
reads the same work whatever implements the step.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

HERE = os.path.dirname(os.path.abspath(__file__))

# ATen calls that move or make data without computing it
MOVEMENT = {"cat", "stack", "select", "slice", "view", "t", "transpose", "permute",
            "expand", "unsqueeze", "index", "_to_copy", "copy_", "clone", "full_like",
            "zeros_like", "empty_like", "lift_fresh", "alias", "detach", "unbind",
            "_unsafe_view", "reshape", "full", "zeros", "empty", "scalar_tensor",
            "lift_fresh_copy", "squeeze", "split", "contiguous", "as_strided",
            "new_empty", "fill_"}

# rows of the step's blocks, float32 each: carry, init, collect per step
CARRY_ROWS, INIT_ROWS, COLLECT_ROWS = 63, 62, 39
ACT_DIM, NOISE_DIM = 4, 3


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def count_elementwise_ops(fn) -> int:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if name not in MOVEMENT and isinstance(out, torch.Tensor):
                Counter.n += out.numel()
            return out

    with Counter():
        fn()
    return Counter.n


def env_step_ops(sim, carry, init, act, eta) -> float:
    """Elementwise operations of one plain env step, per env."""
    import torch
    with torch.no_grad():
        n = count_elementwise_ops(lambda: sim.step(carry, init, act, eta))
    return n / carry.shape[1]


def mlp_macs(in_dim: int, hidden: Sequence[int], out_dim: int) -> int:
    widths = [in_dim, *hidden, out_dim]
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def policy_forward_flops(in_dim: int, hidden: Sequence[int], action_dim: int = 4) -> int:
    """FLOPs of one sample through the actor and the critic, 2 per MAC."""
    return 2 * (mlp_macs(in_dim, hidden, action_dim) + mlp_macs(in_dim, hidden, 1))


def critic_forward_flops(in_dim: int, hidden: Sequence[int]) -> int:
    return 2 * mlp_macs(in_dim, hidden, 1)


def collect_flops(num_envs: int, steps: int, in_dim: int, hidden, env_ops: float) -> float:
    """A rollout: per env-step the policy's forward and the env step; after
    it, the critic on every pre-reset observation (the value bootstrap)."""
    samples = num_envs * steps
    return samples * (policy_forward_flops(in_dim, hidden) + env_ops
                      + critic_forward_flops(in_dim, hidden))


def train_flops(num_envs: int, steps: int, epochs: int, in_dim: int, hidden,
                env_ops: float) -> float:
    """A train step: the rollout, then per epoch the forward and the
    backward (twice the forward) of every sample."""
    samples = num_envs * steps
    return (collect_flops(num_envs, steps, in_dim, hidden, env_ops)
            + epochs * samples * 3 * policy_forward_flops(in_dim, hidden))


def step_launch_bytes(num_envs: int, steps: int, collected: bool, held_action: bool) -> int:
    """Bytes a step-kernel launch of `steps` transitions moves, each byte of
    its blocks read or written once: the carry in and out, the init block,
    the actions (one row held, or one per step), the noise and, where the
    launch writes it, the collect block."""
    per_env = 4 * (2 * CARRY_ROWS + INIT_ROWS
                   + ACT_DIM * (1 if held_action else steps)
                   + NOISE_DIM * steps
                   + (COLLECT_ROWS * steps if collected else 0))
    return per_env * num_envs


def step_launch_bound_s(num_envs: int, steps: int, env_ops: float, collected: bool,
                        held_action: bool) -> float:
    """The least time of a launch: max(bytes / HBM bandwidth, operations /
    the float32 peak outside the tensor cores)."""
    p = peaks()
    return max(step_launch_bytes(num_envs, steps, collected, held_action)
               / p["hbm_bytes_per_s"],
               env_ops * num_envs * steps / p["fp32_flops_per_s"])
