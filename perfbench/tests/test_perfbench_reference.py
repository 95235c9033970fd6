"""The frozen reference against the port's plain versions at a tiny size on
the CPU (this test alone imports both), and whole cells run on the CPU
with the reference's verdict `correct`."""
import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from harness import runner, spec
from reference import learner as ref_learner
from reference.check import build_sim, task_ids

MIXED = {"airframe": "aw109", "tasks": ["hover", "forward", "turning", "oblique"],
         "target": "sea_alt=start,vel=60", "turbulence_level": 1}


def test_plain_step_and_trim_match_the_port():
    """20 steps of 16 MixedTask envs under random actions and noise: the
    reference's trim and plain step equal the port's bit for bit."""
    from heligym_tpu_torch.envs import VectorHeliEnv
    from heligym_tpu_torch.learner.evaluate import build_env
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    n = 16
    env, _ = build_env(tasks="hover,forward,turning,oblique", target="sea_alt=start,vel=60",
                       device="cpu")
    venv = VectorHeliEnv(env, n)
    es, _ = venv.reset_from_trim(env.trim_result(use_cache=False))
    es = venv.assign_tasks(es, task_ids(MIXED, n))
    carry_p, init_p = fs.pack(es)
    sim = build_sim(MIXED, "cpu")
    carry_r, init_r, act_r = sim.start(n, task_ids(MIXED, n), "cpu")
    assert torch.equal(carry_p, carry_r) and torch.equal(init_p, init_r)
    assert torch.equal(env.trim_result(use_cache=False).action, act_r)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _ in range(20):
            act = torch.clamp(act_r + 0.2 * torch.randn((n, 4), generator=g), -1, 1)
            eta = torch.randn((3, n), generator=g) * 7.0
            carry_p, x_p = fs.fused_step_plain(env, carry_p, init_p, act, eta)
            carry_r, x_r = sim.step(carry_r, init_r, act, eta)
            assert torch.equal(carry_p, carry_r) and torch.equal(x_p, x_r)


def test_forward_matches_actor_critic():
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env

    env, _ = build_env(task="hover", target="sea_alt=start", device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=8))
    path = f"{ROOT}/examples/hover4k_policy.npz"
    ts = learner.restore(path, farm_size=4096)
    ck = ref_learner.load_checkpoint(path, "cpu")
    for a, b in zip(learner.param_list(ts.params), ck.leaves):
        assert torch.equal(a.detach(), b)
    for a, b in zip(ts.opt_state.mu + ts.opt_state.nu, ck.mu + ck.nu):
        assert torch.equal(a, b)
    assert torch.equal(ts.obs_stats.mean, ck.stats_mean)
    x = torch.randn((32, 17), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = ts.params(x)
        want = ref_learner.forward(ck.leaves, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_whole_cell_on_the_cpu_is_correct(workload):
    """A run of the cell at a tiny size, the window included: every number
    the reference compares reads 0 (the same arithmetic on one device)."""
    cell = spec.cell(workload)
    res = runner.run(cell, 2 ** 31 + 7, 0.2, False, "cpu", 0.0, overrides=TINY[workload],
                     log=lambda m: None)
    assert res["correct"] is True and res["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks"
    assert {m.name for m in cell.end_to_end} == set(res["metrics"])
    assert np.isfinite([m["value"] for m in res["metrics"].values()]).all()
