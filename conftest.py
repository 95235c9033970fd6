"""Marks the JAX package's heaviest self-checks `slow`.

The JAX package (`heligym_tpu/`) is the frozen reference that the port's
tests hold `heligym_tpu_torch` against. The tests listed here hold the JAX
package against itself (its Pallas kernel, interpreted on the CPU, against
its eager step; its shaped train step against its unshaped one), so they
can only change their outcome with the installed JAX. They stay in their
files unchanged, and `python -m pytest -m slow tests/` runs them. The port's
own checks of the same properties (`test_torch_fused.py`,
`test_torch_tasks.py`, `test_torch_parallel.py`,
`test_torch_ppo.py::test_shaping_is_training_only`) are not marked.

Each id's comment gives its junit seconds in a whole tier-1 run (6 workers,
`--dist loadfile`, 8 shared CPU cores at a median load of 9.7). This file
imports neither JAX nor torch: it loads before `tests/conftest.py` sets
JAX's flags.
"""
import pytest

SLOW = frozenset({
    "tests/test_multitask.py::test_mixed_through_fused_rollout",  # 410.9 s
    "tests/test_sharding.py::test_sharded_fused_rollout_matches_single_device",  # 388.1 s
    "tests/test_fused.py::test_fused_matches_unfused",  # 332.7 s
    "tests/test_ppo.py::test_shaped_gae_finite",  # 220.7 s
    "tests/test_ppo.py::test_flare_shaping_training_only",  # 195.4 s
    "tests/test_ppo.py::test_vel_track_shaping_training_only",  # 152.3 s
    "tests/test_ppo.py::test_prof_shaping_training_only",  # 150.7 s
})


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Mark the listed tests before `-m` deselects by mark."""
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
