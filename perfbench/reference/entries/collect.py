"""The reference's side of `PPOLearner.collect`: the plain actor-critic's
stochastic policy and the plain step, a rollout a unit (the record's
"traj" and "carry"). Numbers: `rollout_gap`, `flag_mismatch`."""
from reference.check import compare_rollouts, follow_learner

# the control: the learner's matmuls in TF32
CONTROL = "tf32"
# "alter": one reward changed where the step makes it; "unchanged": a
# collect that returns the farm it was given
FAULTS = ("alter", "unchanged")


def follow(config, traffic, seed, units, device, control, root, fault):
    return follow_learner(config, traffic, seed, units, device, control, root, fault,
                          update=False)


def compare(prog, ref):
    return compare_rollouts(prog, ref)
