"""The reference's side of the env-only rollout: the plain step, `steps`
transitions a unit from the trim with the trim action held, the Dryden
noise drawn from the seed's generator as the launch draws it. A unit's
record: "carry" (63, B) after it, "reward", "done", "truncated" (steps, B).

Numbers: `rollout_gap` (the carry, per row, and the rewards) and
`flag_mismatch` (done and truncated flags that differ)."""
import torch

from reference.check import build_sim, cpu, gap, precision, task_ids
from reference.graphs import Stepper
from reference.sim.env import CDONE, CTRUNC, XROWS

# the control: the state rows kept in bfloat16 between transitions (TF32
# touches no operation of the elementwise float32 step)
CONTROL = "bf16"
# "alter": one reward changed where the step makes it; "unchanged": a
# launch that returns the farm it was given
FAULTS = ("alter", "unchanged")


def _bf16_rows(carry):
    """The state rows rounded to bfloat16 (the counters stay exact)."""
    carry = carry.clone()
    carry[:61] = carry[:61].to(torch.bfloat16).to(torch.float32)
    return carry


def follow(config, traffic, seed, units, device, control, root, fault):
    n = config["ppo"]["num_envs"]
    sim = build_sim(config, device)
    carry, init, act_bias = sim.start(n, task_ids(config, n), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    steps = int(traffic["steps"])
    act = act_bias.expand(n, 4).contiguous()
    stepper = Stepper(sim, init, _bf16_rows if control == "bf16" else None)
    recs = []
    with precision("float32"), torch.no_grad():
        for _ in range(units):
            eta = torch.randn((steps, 3, n), generator=gen, device=device) * (1.0 / sim.dt) ** 0.5
            x = torch.empty((steps, XROWS, n), device=device)
            start = carry
            for t in range(steps):
                carry, x[t] = stepper(carry, act, eta[t])
            carry = carry.clone()
            if fault == "alter":
                x[0, 0, 0] += 1.0
            elif fault == "unchanged":
                carry = start
            recs.append({"carry": cpu(carry), "reward": cpu(x[:, 0]),
                         "done": cpu(x[:, CDONE] != 0), "truncated": cpu(x[:, CTRUNC] != 0)})
    return recs


def compare(prog, ref):
    return {"rollout_gap": max(max(gap(p["carry"], r["carry"], 0),
                                   gap(p["reward"], r["reward"], None))
                               for p, r in zip(prog, ref)),
            "flag_mismatch": float(sum(int((p[k] != r[k]).sum()) for p, r in zip(prog, ref)
                                       for k in ("done", "truncated")))}
