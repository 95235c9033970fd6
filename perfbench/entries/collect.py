"""`PPOLearner.collect`: one rollout of `rollout_steps` from the train
state's farm with the stochastic head (on the card one CUDA graph replay),
the reward sanitising and the value bootstrap; no update. A unit keeps the
rollout's streams and the farm after it."""
from harness import counts
from harness.program import build_learner, carry_of, traj_record


def build(prog):
    build_learner(prog)


def unit(prog):
    prog.ts, traj = prog.learner.collect(prog.ts, prog.ts.generator)
    return traj


def record(prog, k):
    recs = []
    for _ in range(k):
        traj = unit(prog)
        recs.append({"traj": traj_record(traj), "carry": carry_of(prog.ts.env_state)})
    return recs


def span_targets(prog):
    return [(prog.learner, "collect")]


def unit_flops(ctx):
    p = ctx.ppo
    return counts.collect_flops(p["num_envs"], p["rollout_steps"], ctx.in_dim(),
                                p["hidden"], ctx.env_ops)
