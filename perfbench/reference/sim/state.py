# Frozen copy of heligym_tpu_torch/ops/state.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Simulation state: small frozen dataclasses of (batched) float32 tensors.

Every physical scalar is its own field, of shape () for one env or (B,) for a
batch, so the physics is elementwise over the batch and the same code serves
one env, a batch, and the plain version of the fused CUDA step. `rows()` /
`from_rows()` pack a state into, and view it out of, a `(rows, B)` tensor in
field order: the layout of the fused step's carry block.
"""
from __future__ import annotations

import dataclasses

import torch

# Flattening order of the 18-dim state vector (the reference's registration
# order, as in the JAX package's ops/state.py:26).
HELI_STATE_FIELDS = ("vi_mr", "vi_tr", "psi_mr", "psi_tr", "b0", "b1",
                     "u", "v", "w", "p", "q", "r",
                     "phi", "theta", "psi", "x", "y", "z")

WIND_STATE_FIELDS = ("us", "vs0", "vs1", "ws0", "ws1")


class _Fields:
    """Shared helpers of the per-field state dataclasses."""
    FIELDS: tuple = ()

    @classmethod
    def zeros(cls, batch=(), device=None):
        zv = torch.zeros(batch, dtype=torch.float32, device=device)
        return cls(**{f: zv for f in cls.FIELDS})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn):
        return type(self)(**{f: fn(getattr(self, f)) for f in self.FIELDS})

    def flatten(self) -> torch.Tensor:
        """(..., n) vector in field order."""
        return torch.stack([getattr(self, f) for f in self.FIELDS], dim=-1)

    @classmethod
    def unflatten(cls, vec: torch.Tensor):
        return cls(**{f: vec[..., i] for i, f in enumerate(cls.FIELDS)})

    def rows(self) -> torch.Tensor:
        """(n, ...) packing, components on the leading axis."""
        return torch.stack([getattr(self, f) for f in self.FIELDS], dim=0)

    @classmethod
    def from_rows(cls, rows: torch.Tensor):
        return cls(**{f: rows[i] for i, f in enumerate(cls.FIELDS)})


@dataclasses.dataclass(frozen=True)
class HeliState(_Fields):
    FIELDS = HELI_STATE_FIELDS
    vi_mr: torch.Tensor   # main-rotor induced inflow [ft/s]
    vi_tr: torch.Tensor   # tail-rotor induced inflow [ft/s]
    psi_mr: torch.Tensor  # main-rotor azimuth [rad]
    psi_tr: torch.Tensor  # tail-rotor azimuth [rad]
    b0: torch.Tensor      # TPP tilt a (longitudinal flap) [rad]
    b1: torch.Tensor      # TPP tilt b (lateral flap) [rad]
    u: torch.Tensor       # body-frame velocities [ft/s]
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor       # body rates [rad/s]
    q: torch.Tensor
    r: torch.Tensor
    phi: torch.Tensor     # Euler angles [rad]
    theta: torch.Tensor
    psi: torch.Tensor
    x: torch.Tensor       # NED position [ft]
    y: torch.Tensor
    z: torch.Tensor

    # -- stacked views (what the renderers read) ---------------------------
    @property
    def betas(self):
        return torch.stack([self.b0, self.b1], dim=-1)

    @property
    def uvw(self):
        return torch.stack([self.u, self.v, self.w], dim=-1)

    @property
    def pqr(self):
        return torch.stack([self.p, self.q, self.r], dim=-1)

    @property
    def euler(self):
        return torch.stack([self.phi, self.theta, self.psi], dim=-1)

    @property
    def xyz(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)


@dataclasses.dataclass(frozen=True)
class WindState(_Fields):
    """Dryden turbulence filter states."""
    FIELDS = WIND_STATE_FIELDS
    us: torch.Tensor
    vs0: torch.Tensor
    vs1: torch.Tensor
    ws0: torch.Tensor
    ws1: torch.Tensor


def tree_add_scaled(state, dots, h: float):
    """state + dots * h, field by field (RK4 stage arithmetic)."""
    return type(state)(**{f: getattr(state, f) + getattr(dots, f) * h
                          for f in state.FIELDS})


def tree_rk4_combine(state, k1, k2, k3, k4, dt: float):
    """The reference's RK4 combination in its float op order:
    state + (((k1 + k2*2) + k3*2) + k4) * (1/6 * dt)."""
    c = 0.16666666666666666 * dt
    return type(state)(**{
        f: getattr(state, f) + (((getattr(k1, f) + getattr(k2, f) * 2.0)
                                 + getattr(k3, f) * 2.0) + getattr(k4, f)) * c
        for f in state.FIELDS})
