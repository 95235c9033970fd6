"""`PPOLearner.train_step`: a graphed collect, then the update (GAE and
`epochs` x `minibatches` optimizer steps). A unit keeps the rollout's
streams, the farm after it, GAE's advantages and returns and the step's
mean loss and the network after it; the first unit also the network
before it and Adam's moments after it."""
from typing import Dict

from harness import counts
from harness.program import build_learner, carry_of, cpu, traj_record


def build(prog):
    build_learner(prog)


def unit(prog):
    prog.ts, metrics = prog.learner.train_step(prog.ts)
    return metrics


def record(prog, k):
    """The train step's own call, with its two halves' inputs tapped on the
    learner object: `update` sees the rollout, `_gae` gives the advantages."""
    lr = prog.learner
    params0 = [cpu(p) for p in lr.param_list(prog.ts.params)]
    got: Dict[str, object] = {}
    update, gae = lr.update, lr._gae

    def update_rec(ts, traj, idx=None):
        got["traj"], got["carry"] = traj_record(traj), carry_of(ts.env_state)
        return update(ts, traj, idx)

    def gae_rec(traj):
        adv, ret = gae(traj)
        got["adv"], got["ret"] = cpu(adv), cpu(ret)
        return adv, ret

    lr.update, lr._gae = update_rec, gae_rec
    recs = []
    try:
        for u in range(k):
            metrics = unit(prog)
            rec = dict(got, loss=float(metrics["loss"]),
                       params=[cpu(p) for p in lr.param_list(prog.ts.params)])
            if u == 0:
                rec.update(params0=params0, mu=[cpu(m) for m in prog.ts.opt_state.mu],
                           nu=[cpu(v) for v in prog.ts.opt_state.nu])
            recs.append(rec)
    finally:
        del lr.update, lr._gae
    return recs


def span_targets(prog):
    return [(prog.learner, "collect"), (prog.learner, "update")]


def unit_flops(ctx):
    p = ctx.ppo
    return counts.train_flops(p["num_envs"], p["rollout_steps"], p["epochs"], ctx.in_dim(),
                              p["hidden"], ctx.env_ops)
