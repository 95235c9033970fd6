"""The control of each cell must come out not correct: the reference in
the configuration's next lower precision (TF32 matmuls for a learner cell,
the state kept in bfloat16 for the env-only rollout) put in the program's
place, against the reference, judged by the cell's own limits. On the card
at the cell's own size on three seeds; the env-only control also at a tiny
size on the CPU (TF32 does not exist there)."""
import pytest

from conftest import ROOT, TINY
from harness import spec
from reference import check

SEEDS = (101, 2 ** 31 + 5, 70_000_001)


def _control_checks(workload, seed, device, overrides=None):
    cell = spec.cell(workload)
    ppo = {**cell.config["ppo"], **{k: v for k, v in (overrides or {}).items()
                                    if k in cell.config["ppo"]}}
    traffic = {**cell.traffic, **{k: v for k, v in (overrides or {}).items()
                                  if k not in cell.config["ppo"]}}
    config = {**cell.config, "ppo": ppo}
    units = int(traffic["compared_units"])
    control = check.entry(traffic["entry"]).CONTROL
    got = check.follow(config, traffic, seed, units, device, control=control, root=ROOT)
    ref = check.follow(config, traffic, seed, units, device, root=ROOT)
    return check.judge(check.compare(traffic["entry"], got, ref), cell.limits)


def test_env_only_control_on_the_cpu():
    checks = _control_checks("hover.sim", SEEDS[0], "cpu", TINY["hover.sim"])
    assert not check.correct(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hover.train", "mixed4.collect", "hover.sim"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_on_the_card(card, workload, seed):
    checks = _control_checks(workload, seed, card)
    assert not check.correct(checks), checks
