"""The correctness check against faults planted in the program: a whole
tiny run of each cell on the CPU (the look for a card skipped), the timed
path broken underneath, must come out not correct. One case per fault the
cell can have: a step that returns its state unchanged (in the train
step also the actor's part alone: its update scaled by 0, as during the
critic's warm-up), half of the batch left out with the mean taken over the
rest (the update only), an answer altered where it is produced. The
exchange between cards has no cell."""
import pytest

from conftest import TINY
from harness import runner, spec


def _unchanged_update(monkeypatch):
    from heligym_tpu_torch.learner import ppo

    monkeypatch.setattr(ppo, "apply_step", lambda params, grads, state, *a, **k: state)


def _frozen_actor(monkeypatch):
    from heligym_tpu_torch.learner import ppo

    orig = ppo.PPOLearner.schedules
    monkeypatch.setattr(ppo.PPOLearner, "schedules",
                        lambda self, update_count: orig(self, update_count)[:3] + (0.0,))


def _half_batch(monkeypatch):
    from heligym_tpu_torch.learner import ppo

    orig = ppo.PPOLearner._loss

    def half(self, params, batch, adv, ret, stats, ent_coef, cap, norm=None):
        h = adv.shape[0] // 2
        batch = batch.map(lambda x: x[:h])
        return orig(self, params, batch, adv[:h], ret[:h], stats, ent_coef, cap,
                    (adv[:h].mean(), adv[:h].std(correction=0), h))
    monkeypatch.setattr(ppo.PPOLearner, "_loss", half)


def _altered_reward(monkeypatch):
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    orig = fs.fused_step_plain

    def altered(*a, **k):
        carry, x = orig(*a, **k)
        x = x.clone()
        x[fs.CREW, 0] += 1.0
        return carry, x
    monkeypatch.setattr(fs, "fused_step_plain", altered)


def _unchanged_collect(monkeypatch):
    from heligym_tpu_torch.learner import ppo

    orig = ppo.PPOLearner._collect_fused

    def same(self, params, stats, cap, es, *a, **k):
        return es, orig(self, params, stats, cap, es, *a, **k)[1]
    monkeypatch.setattr(ppo.PPOLearner, "_collect_fused", same)


def _unchanged_rollout(monkeypatch):
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    orig = fs._plain_rollout
    monkeypatch.setattr(fs, "_plain_rollout",
                        lambda env, carry, *a: (carry.clone(), orig(env, carry, *a)[1]))


FAULTS = [("hover.train", _unchanged_update), ("hover.train", _frozen_actor),
          ("hover.train", _half_batch),
          ("hover.train", _altered_reward), ("mixed4.collect", _unchanged_collect),
          ("mixed4.collect", _altered_reward), ("hover.sim", _unchanged_rollout),
          ("hover.sim", _altered_reward)]


@pytest.mark.parametrize("workload,plant", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_planted_fault_is_not_correct(workload, plant, monkeypatch):
    plant(monkeypatch)
    res = runner.run(spec.cell(workload), 977, 0.1, False, "cpu", 0.0,
                     overrides=TINY[workload], log=lambda m: None)
    assert res["correct"] is False, res["checks"]
