"""The yardstick's arithmetic on known shapes."""
import pytest
import torch

from harness import counts
from reference.check import build_sim, task_ids


def test_mlp_flops():
    # actor 17*256 + 256*256 + 256*4 = 70,912 MACs, critic 70,144
    assert counts.mlp_macs(17, (256, 256), 4) == 70_912
    assert counts.mlp_macs(17, (256, 256), 1) == 70_144
    assert counts.policy_forward_flops(17, (256, 256)) == 282_112
    assert counts.policy_forward_flops(21, (256, 256)) == 2 * (71_936 + 71_168)
    n, t = 16384, 64
    train = counts.train_flops(n, t, 4, 17, (256, 256), 4205.0)
    samples = n * t
    # the rollout (forward, env step, value bootstrap) and 4 epochs of 3x forward
    assert train == pytest.approx(samples * (282_112 + 4205 + 140_288 + 4 * 3 * 282_112))
    assert 3.9e12 < train < 4.1e12


def test_launch_bytes_and_bound():
    # one-step launch: carry in and out, init, action, noise, collect block
    assert counts.step_launch_bytes(1, 1, True, False) == 4 * (126 + 62 + 4 + 3 + 39) == 936
    assert counts.step_launch_bytes(16384, 500, True, True) == \
        16384 * 4 * (126 + 62 + 4 + 500 * (3 + 39))
    p = counts.peaks()
    one = counts.step_launch_bound_s(16384, 1, 4440.0, True, False)
    assert one == pytest.approx(936 * 16384 / p["hbm_bytes_per_s"])
    many = counts.step_launch_bound_s(16384, 500, 4205.0, True, True)
    assert many == pytest.approx(4205.0 * 16384 * 500 / p["fp32_flops_per_s"])


@pytest.mark.parametrize("tasks,ops", [(["hover"], 4205), (["hover", "forward", "turning",
                                                                "oblique"], 4440)])
def test_env_step_ops(tasks, ops):
    """The plain step's operations per env: the counts `chip_smoke.py`
    reads from the port's plain version (hover 4,205, mixed4 4,440)."""
    config = {"airframe": "aw109", "tasks": tasks, "target": "sea_alt=start",
              "turbulence_level": 1}
    n = 64
    sim = build_sim(config, "cpu")
    carry, init, act = sim.start(n, task_ids(config, n), "cpu")
    got = counts.env_step_ops(sim, carry, init, act.expand(n, 4).contiguous(),
                              torch.zeros((3, n)))
    assert got == pytest.approx(ops, abs=2)
