"""The env-only rollout: `build_fused_rollout(env, num_envs, steps)` with the
trim action held and the Dryden noise drawn on the device from the cell's
generator. A unit is one launch of `steps` transitions; it keeps the farm
after the launch and the collected reward and done rows."""
from harness.program import carry_of, cpu


def build(prog):
    from heligym_tpu_torch.envs import VectorHeliEnv
    from heligym_tpu_torch.ops.cuda.fused_step import build_fused_rollout

    prog.steps = int(prog.traffic["steps"])
    tr = prog.env.trim_result()
    prog.es, _ = VectorHeliEnv(prog.env, prog.n).reset_from_trim(tr)
    prog.actions = tr.action.to(prog.device).expand(prog.n, 4).contiguous()
    prog.roll = build_fused_rollout(prog.env, prog.n, prog.steps,
                                    collect=tuple(prog.traffic["collect"]))
    prog.env_steps_per_unit = prog.n * prog.steps


def unit(prog):
    prog.es, outs = prog.roll(prog.es, prog.actions, generator=prog.gen)
    return outs


def record(prog, k):
    recs = []
    for _ in range(k):
        outs = unit(prog)
        recs.append({"carry": carry_of(prog.es), "reward": cpu(outs["reward"]),
                     "done": cpu(outs["done"]), "truncated": cpu(outs["truncated"])})
    return recs


def span_targets(prog):
    return []


def unit_flops(ctx):
    """The plain step's operations of every transition of the launch."""
    return ctx.env_ops * ctx.program.env_steps_per_unit
