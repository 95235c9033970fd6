"""Actor-critic networks for continuous helicopter control.

MLPs sized for the 17-dim observation / 4-dim action interface. Observations
are scaled by fixed physical normalizers so the network sees O(1) inputs; the
scales derive from rotor radius and gravity exactly like the reward
normalizers. The matmuls are plain `nn.Linear` in float32 (the JAX package
leaves them to XLA, outside any kernel); callers that hold the port against
the JAX package keep TF32 off.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def obs_scales(params) -> np.ndarray:
    """Fixed per-component observation scales (power, velocities, angles,
    rates, positions, altitudes)."""
    v = float(np.sqrt(2.0 * params.MR.R * params.ENV.GRAV))
    x = 2.0 * params.MR.R
    return np.asarray(
        [1000.0,                      # power [hp]
         v, v, v,                     # uvw air
         v, v, v,                     # ned vel
         1.0, 1.0, np.pi,             # euler
         1.0, 1.0, 1.0,               # pqr
         x * 10, x * 10, 5000.0, 5000.0],  # positions/altitudes
        dtype=np.float32)


def _orthogonal_(weight: torch.Tensor, gain: float,
                 generator: Optional[torch.Generator]) -> None:
    """Orthogonal init of an (out, in) weight scaled by `gain`, drawn from
    `generator`: QR of a normal matrix with the sign of R's diagonal folded
    in, as flax's `initializers.orthogonal` does for its (in, out) kernel."""
    rows, cols = weight.shape
    flat = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    with torch.no_grad():
        weight.copy_(gain * (q if rows >= cols else q.T))


class ActorCritic(nn.Module):
    """Shared-input, separate-torso Gaussian policy + value function.

    `in_dim` is 17 plus the task one-hot's width. `log_std_init` sets the
    initial exploration scale: the helicopter is an unstable plant, so
    exp(-0.5)=0.6 full-range control noise destroys the trim within a
    second; hover/landing training uses -1.0 to -1.5. Weights are
    orthogonal (gain sqrt(2) in the towers, 0.01 for the mean head, 1.0 for
    the value head) and biases zero, drawn from `generator`."""

    def __init__(self, in_dim: int = 17, action_dim: int = 4,
                 hidden: Sequence[int] = (256, 256), log_std_init: float = -0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_dim, *hidden]
        tower = lambda: nn.ModuleList(nn.Linear(a, b)
                                      for a, b in zip(widths[:-1], widths[1:]))
        # creation order follows the JAX module's call order: actor torso,
        # mean head, critic torso, value head (flax Dense_0 .. Dense_{2L+1})
        self.actor = tower()
        self.mean = nn.Linear(widths[-1], action_dim)
        self.critic = tower()
        self.value = nn.Linear(widths[-1], 1)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init)))
        for lin, gain in self.dense_layers_with_gain():
            _orthogonal_(lin.weight, gain, generator)
            nn.init.zeros_(lin.bias)

    def dense_layers_with_gain(self):
        root2 = math.sqrt(2.0)
        return ([(lin, root2) for lin in self.actor] + [(self.mean, 0.01)]
                + [(lin, root2) for lin in self.critic] + [(self.value, 1.0)])

    def dense_layers(self):
        """The Linear layers in the JAX module's Dense_i order."""
        return [lin for lin, _ in self.dense_layers_with_gain()]

    def flax_leaves(self):
        """(flax name, leaf name, parameter) of every parameter in the leaf
        order of the JAX network's parameter tree: the Dense_i sorted by name
        as strings (Dense_10 before Dense_2), bias before kernel, then
        log_std. A kernel is the transpose of its `nn.Linear` weight."""
        dense = self.dense_layers()
        out = []
        for name in sorted(f"Dense_{i}" for i in range(len(dense))):
            lin = dense[int(name[len("Dense_"):])]
            out += [(name, "bias", lin.bias), (name, "kernel", lin.weight)]
        return out + [("log_std", None, self.log_std)]

    def actor_flax_names(self):
        """The flax names of the actor's parameters: the torso Dense_0 ..
        Dense_{L-1}, the mean head Dense_L, and log_std."""
        return {f"Dense_{i}" for i in range(len(self.actor) + 1)} | {"log_std"}

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        a = c = obs
        for lin in self.actor:
            a = torch.tanh(lin(a))
        mean = self.mean(a)
        for lin in self.critic:
            c = torch.tanh(lin(c))
        value = self.value(c)
        return mean, self.log_std.expand(mean.shape), value[..., 0]


def gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var)
                     - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
