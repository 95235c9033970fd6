# Frozen copy of heligym_tpu_torch/ops/integrator.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Fixed-step RK4 integrators over state dataclasses.

Two variants exist on purpose:

* `rk4` — the true RK4 the helicopter dynamics get (the reference copies its
  dots container, so its four stage slopes are independent).

* `rk4_k4only` — the integrator the *wind* dynamics get in the reference: its
  wind model writes into and returns one shared dots object, so by the time
  the RK4 combination runs, k1..k3 alias k4 and the update degenerates to
  `state += (((k4 + 2 k4) + 2 k4) + k4) * (dt/6)` with k4 evaluated at the
  nested stage point. The exact arithmetic, intermediate float32 roundings
  included, is kept for trajectory parity.
"""
from .state import tree_add_scaled, tree_rk4_combine
from .constants import RK4_SIXTH


def rk4(f, state, dt: float):
    """One true RK4 step. `f(state) -> (dots, aux)`; aux is taken from the k4
    stage. Returns (new_state, k4_dots, aux_k4)."""
    k1, _ = f(state)
    k2, _ = f(tree_add_scaled(state, k1, 0.5 * dt))
    k3, _ = f(tree_add_scaled(state, k2, 0.5 * dt))
    k4, aux = f(tree_add_scaled(state, k3, dt))
    new_state = tree_rk4_combine(state, k1, k2, k3, k4, dt)
    return new_state, k4, aux


def rk4_k4only(f, state, dt: float):
    """The reference wind integrator: RK4 stage nesting, but the combination
    collapses onto k4 (see module docs)."""
    k1, _ = f(state)
    k2, _ = f(tree_add_scaled(state, k1, 0.5 * dt))
    k3, _ = f(tree_add_scaled(state, k2, 0.5 * dt))
    k4, aux = f(tree_add_scaled(state, k3, dt))
    c = RK4_SIXTH * dt

    def combine(s, d):
        return s + (((d + d * 2.0) + d * 2.0) + d) * c

    new_state = type(state)(**{n: combine(getattr(state, n), getattr(k4, n))
                               for n in state.FIELDS})
    return new_state, k4, aux
