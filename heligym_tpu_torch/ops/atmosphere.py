"""Standard-atmosphere model (linear lapse rate)."""
from ..utils.math import cdiv


def air_properties(env, altitude):
    """Temperature [R] and density [slug/ft^3] at `altitude` ft above sea level.

    `env` is an EnvPhysics of static floats; `altitude` a (batched) f32 scalar.
    """
    temp = env.T0 - env.LAPSE * altitude
    rho = env.RO_SEA * cdiv(temp, env.T0) ** ((env.GRAV / (env.LAPSE * env.R)) - 1.0)
    return temp, rho
