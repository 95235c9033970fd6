"""The reference's side of `PPOLearner.train_step`: the collect, then GAE,
the clipped PPO loss and optax's clipped Adam over `epochs` x
`minibatches` steps. A unit's record: the rollout's "traj" and "carry",
"adv" and "ret" (GAE), "loss" (the step's mean loss), "params" (the
network after it); the first unit also "params0" (the network before it),
"mu", "nu" (Adam's moments after it) and "first_grads" (the reference's
gradient norm of each leaf at its first minibatch step).

Numbers, all of the first train step: `rollout_gap`, `flag_mismatch` (as
the collect's, over its rollout), `gae_gap` (its advantages and returns),
`loss_gap` (its mean loss), `moment_gap` (Adam's moments after it) and
`change_gap` (the network's change over it; see `reference.check`). The
program equals the reference bit for bit but for the reduction order of
the global gradient norm; from the second train step on, the rollouts
amplify that one-ulp difference in the actor, on most seeds in a few of
the envs, to gaps as wide as the TF32 control's, so later steps give no
number that separates a sound run from the control."""
import numpy as np

from reference.check import (GRAD_FLOOR, compare_rollouts, follow_learner, gap,
                             norm_gap)

# the control: the learner's matmuls in TF32
CONTROL = "tf32"
# "alter": one reward changed where the step makes it; "half_batch": half
# of each minibatch left out, the mean over the rest; "unchanged": the
# network and Adam's state left as they were; "frozen_actor": the actor's
# update scaled by 0, as during the critic's warm-up
FAULTS = ("alter", "half_batch", "unchanged", "frozen_actor")


def follow(config, traffic, seed, units, device, control, root, fault):
    return follow_learner(config, traffic, seed, units, device, control, root, fault,
                          update=True)


def compare(prog, ref):
    p, r = prog[0], ref[0]
    out = compare_rollouts([p], [r])
    out["gae_gap"] = max(gap(p["adv"], r["adv"], None), gap(p["ret"], r["ret"], None))
    out["loss_gap"] = abs(p["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30)
    out["moment_gap"] = max(norm_gap(p["mu"], r["mu"]), norm_gap(p["nu"], r["nu"]))
    grads = np.array(r["first_grads"])
    keep = list(grads >= GRAD_FLOOR * np.median(grads))
    dp = [a - b for a, b in zip(p["params"], p["params0"])]
    dr = [a - b for a, b in zip(r["params"], r["params0"])]
    out["change_gap"] = norm_gap(dp, dr, keep)
    return out
