"""What decides `correct`: the plain reference follows the units the
program's set-up drove through the window's own call, from the same seed,
and each number compared below is held to the cell's limit.

The reference's side of each entry is the file `reference/entries/<entry>.py`
(found by the entry's name, as the program's side is `entries/<entry>.py`):
its `follow` makes the reference's records of the units, its `compare` the
numbers, and it names its `CONTROL` and the `FAULTS` it can plant. A unit's
record (CPU tensors; the program's and the reference's alike) is described
there; a policy-driven rollout keeps "traj" (per step: obs, action,
log_prob, value, reward, v_boot, terminated, truncated, failed, succ_step)
and "carry", the farm after the rollout (63, B).

The numbers:
  rollout_gap    worst stream and component of max |program - reference|
                 over the reference's largest magnitude there (a NaN on one
                 side only: infinite)
  flag_mismatch  the transitions whose done, truncated, failed or
                 in-tolerance flag differs
  gae_gap        the same gap over the advantages and returns
  loss_gap       |loss gap| over the reference's |loss|
  moment_gap     worst leaf of Adam's two moments after the first unit: the
                 gap of the two norms over the larger of the reference's
                 norm of that leaf and of the median leaf
  change_gap     the same for the parameters' change over the first unit,
                 over the leaves whose first gradient in the reference is
                 at least a thousandth of the median leaf's; the median
                 leaf of the change is taken over the leaves it moves
An entry says which units each number covers.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import learner as ref_learner
from .sim.env import Sim

HERE = os.path.dirname(os.path.abspath(__file__))        # perfbench/reference

TRAJ_FLOATS = ("obs", "action", "log_prob", "value", "reward", "v_boot")
TRAJ_FLAGS = ("terminated", "truncated", "failed", "succ_step")
GRAD_FLOOR = 1e-3


def gap(p: torch.Tensor, r: torch.Tensor, comp_dim: Optional[int]) -> float:
    """max |p - r| over max |r|, per component along `comp_dim` (None: the
    whole tensor), the worst component."""
    p, r = p.double(), r.double()
    if p.shape != r.shape:
        return float("inf")
    pn, rn = torch.isnan(p), torch.isnan(r)
    if bool((pn ^ rn).any()):
        return float("inf")
    d = torch.where(pn & rn, 0.0, (p - r).abs())
    a = torch.where(rn, 0.0, r.abs())
    if comp_dim is None:
        d, a = d.reshape(1, -1), a.reshape(1, -1)
    else:
        d = d.movedim(comp_dim, 0).reshape(d.shape[comp_dim], -1)
        a = a.movedim(comp_dim, 0).reshape(a.shape[comp_dim], -1)
    num, den = d.amax(1), a.amax(1)
    gaps = torch.where(num == 0, 0.0, num / torch.clamp(den, min=1e-30))
    return float(gaps.max())


def norm_gap(p: List[torch.Tensor], r: List[torch.Tensor],
              keep: Optional[List[bool]] = None) -> float:
    pn = np.array([float(torch.linalg.vector_norm(x.double())) for x in p])
    rn = np.array([float(torch.linalg.vector_norm(x.double())) for x in r])
    keep = np.ones(len(r), bool) if keep is None else np.asarray(keep)
    moved = rn[keep & (rn > 0)]
    med = float(np.median(moved)) if moved.size else 0.0
    worst = 0.0
    for i in np.flatnonzero(keep):
        gap = abs(pn[i] - rn[i])
        if gap == 0:
            continue
        if not np.isfinite(gap):
            return float("inf")
        worst = max(worst, gap / max(rn[i], med, 1e-30))
    return worst


def entry(name: str, here: Optional[str] = None):
    """The reference's side of the entry `name`: reference/entries/<name>.py
    under `here` (the perfbench/ directory; None: this one). It holds
    `follow`, `compare`, `CONTROL` and `FAULTS`."""
    here = here or os.path.dirname(HERE)
    path = os.path.join(here, "reference", "entries", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_reference_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare(name: str, prog: List[dict], ref: List[dict],
            here: Optional[str] = None) -> Dict[str, float]:
    """The cell's numbers from the program's records and the reference's."""
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program units against {len(ref)} reference units")
    return entry(name, here).compare(prog, ref)


def compare_rollouts(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """`rollout_gap` and `flag_mismatch` of the policy-driven rollouts."""
    gaps = []
    for p, r in zip(prog, ref):
        gaps.append(gap(p["carry"], r["carry"], 0))
        for k in TRAJ_FLOATS:
            gaps.append(gap(p["traj"][k], r["traj"][k],
                             -1 if p["traj"][k].dim() == 3 else None))
    return {"rollout_gap": max(gaps),
            "flag_mismatch": float(sum(int((p["traj"][k] != r["traj"][k]).sum())
                                       for p, r in zip(prog, ref) for k in TRAJ_FLAGS))}


# -- the reference's own run -----------------------------------------------------

@contextlib.contextmanager
def precision(name: str):
    """"float32": every matmul in full float32 (TF32 off); "tf32": matmuls in
    TF32, the control of a float32 configuration with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_sim(config: dict, device) -> Sim:
    return Sim.build(config["airframe"], config["tasks"], config.get("target"), device,
                     config.get("turbulence_level"))


def task_ids(config: dict, num_envs: int):
    n = len(config["tasks"])
    return np.arange(num_envs) % n if n > 1 else None


def cpu(x):
    return x.detach().to("cpu", copy=True)


def follow(config: dict, traffic: dict, seed: int, units: int, device,
           control: Optional[str] = None, root: str = ".",
           fault: Optional[str] = None, here: Optional[str] = None) -> List[dict]:
    """The reference's records of the first `units` units of the cell from
    `seed`. `control` (the entry's `CONTROL`, the configuration's next lower
    precision) runs the control in the program's place; `fault` (one of the
    entry's `FAULTS`) plants a fault the check must catch."""
    mod = entry(traffic["entry"], here)
    if control not in (None, mod.CONTROL):
        raise ValueError(f"the entry {traffic['entry']!r} has the control {mod.CONTROL!r}")
    if fault not in (None,) + tuple(mod.FAULTS):
        raise ValueError(f"the entry {traffic['entry']!r} plants {mod.FAULTS}, not {fault!r}")
    return mod.follow(config, traffic, seed, units, device, control, root, fault)


def follow_learner(config: dict, traffic: dict, seed: int, units: int, device,
                   control: Optional[str], root: str, fault: Optional[str],
                   update: bool) -> List[dict]:
    """The reference learner's units from `seed`: each a rollout, and with
    `update` the update after it (the layout of the train step's records)."""
    ppo = config["ppo"]
    n = ppo["num_envs"]
    sim = build_sim(config, device)
    carry, init, act_bias = sim.start(n, task_ids(config, n), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ck = ref_learner.load_checkpoint(os.path.join(root, config["policy"]), device)
    lrn = ref_learner.Learner(sim, {**ppo, "set_log_std": config.get("set_log_std"),
                                    "start_update": config.get("start_update", 0)},
                              ck, carry, init, act_bias, gen, device)
    lrn.fault = fault
    params0 = [cpu(p) for p in lrn.leaves]
    recs: List[dict] = []
    with precision(control or "float32"):
        for u in range(units):
            tr = lrn.collect(ppo["rollout_steps"])
            rec = {"traj": {k: cpu(tr[k]) for k in TRAJ_FLOATS},
                   "carry": cpu(tr["carry"])}
            rec["traj"].update({k: cpu(tr[k] != 0) for k in TRAJ_FLAGS})
            if update:
                res = lrn.update(tr)
                rec.update(adv=cpu(res["advantages"]), ret=cpu(res["returns"]),
                           loss=res["loss"], params=[cpu(p) for p in lrn.leaves])
                if u == 0:
                    rec.update(mu=[cpu(m) for m in lrn.mu], nu=[cpu(v) for v in lrn.nu],
                               first_grads=res["first_grads"], params0=params0)
            recs.append(rec)
    return recs


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell compares (those its limits file names) beside
    its limit; a limit for a number the entry does not give is an error of
    the cell's files."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the entry gives no number {missing}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in sorted(limits)}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
