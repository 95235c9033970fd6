# Frozen copy of heligym_tpu_torch/ops/atmosphere.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Standard-atmosphere model (linear lapse rate)."""
from .mathx import cdiv


def air_properties(env, altitude):
    """Temperature [R] and density [slug/ft^3] at `altitude` ft above sea level.

    `env` is an EnvPhysics of static floats; `altitude` a (batched) f32 scalar.
    """
    temp = env.T0 - env.LAPSE * altitude
    rho = env.RO_SEA * cdiv(temp, env.T0) ** ((env.GRAV / (env.LAPSE * env.R)) - 1.0)
    return temp, rho
