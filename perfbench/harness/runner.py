"""One run of one cell: set-up, the measured window, the traced slice, and
the reference's judgement, in that order.

Set-up builds the program and drives its first units (`compared_units` of
the traffic file) through the window's own call: they build and load the
kernels, capture the collector's graph and warm every shape the window
uses, and their outputs are what the reference judges. `setup_s` runs from
the start of the process to the end of those units. The window then runs
units back to back for `seconds` and ends in one wait for the device. With
`trace`, spans time each unit's halves inside the window, and a profiled
slice of `traced_units` more units follows it. The program's state is then
freed and the reference follows the recorded units from the same seed.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from . import program as program_mod
from . import spec as spec_mod
from . import trace as trace_mod
from . import counts

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "heligym_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of the
    JAX stack's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: spec_mod.Cell
    program: program_mod.Program
    window: Dict[str, float]
    spans: Dict[str, List[float]]
    trace: Optional[trace_mod.Trace]
    env_ops: float                 # operations of one env step, per env
    peaks: dict

    @property
    def ppo(self) -> dict:
        return self.program.ppo

    def in_dim(self) -> int:
        tasks = self.cell.config["tasks"]
        return 17 + (len(tasks) if len(tasks) > 1 else 0)

    def unit_flops(self) -> float:
        """The FLOPs of one unit, counted from shapes by the entry's file."""
        return self.program.entry_mod.unit_flops(self)


def _env_ops(cell, program, device) -> float:
    from reference.check import build_sim, task_ids
    n = program.n
    sim = build_sim(cell.config, device)
    carry = torch.zeros((63, n), device=device)
    init = torch.zeros((62, n), device=device)
    if task_ids(cell.config, n) is not None:
        init[61] = torch.as_tensor(task_ids(cell.config, n), dtype=torch.float32)
    act = torch.zeros((n, 4), device=device)
    eta = torch.zeros((3, n), device=device)
    return counts.env_step_ops(sim, carry, init, act, eta)


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides: Optional[dict] = None, log=None) -> dict:
    from reference import check as ref_check

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    clock = time.perf_counter
    torch.backends.cuda.matmul.allow_tf32 = False     # the configurations' precision
    torch.backends.cudnn.allow_tf32 = False

    prog = program_mod.Program(cell.config, cell.traffic, seed, device, overrides, cell.here)
    units = int(prog.traffic["compared_units"])
    recorded = prog.record(units)
    prog.sync()
    setup_s = clock() - t_start
    log(f"set-up {setup_s:.3f} s ({units} units recorded)")

    prog.instrument(timing=trace and prog.device.type == "cuda")
    win = program_mod.window(prog.unit, prog.sync, seconds, clock)
    device_line = device_info(device)
    log(f"window {win['seconds']:.3f} s, {win['units']} units")

    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        rate = prog.env_steps_per_unit * win["units"] / win["seconds"]
        for m in cell.end_to_end:
            value = setup_s if m.name == "setup_s" else rate
            metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        spans = prog.span_ms()
        tr = None
        if prog.device.type == "cuda":
            n_traced = int(prog.traffic["traced_units"])
            with trace_mod.profiled(prog.sync) as out:
                for _ in range(n_traced):
                    prog.unit()
            tr = trace_mod.read(out["prof"], out["window_s"], n_traced)
            device_line.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = tr.breakdown()
        ctx = Context(cell=cell, program=prog, window=win, spans=spans, trace=tr,
                      env_ops=_env_ops(cell, prog, device), peaks=counts.peaks())
        for name, read in spec_mod.readers(cell).items():
            value = read(ctx)
            if value is not None:
                unit = next(m.unit for m in cell.per_layer if m.name == name)
                metrics[name] = {"value": value, "unit": unit}

    prog.free()
    t_ref = clock()
    ref = ref_check.follow({**cell.config, "ppo": prog.ppo}, prog.traffic,
                           seed=program_mod.seed_of(seed), units=units, device=device,
                           root=spec_mod.ROOT, here=cell.here)
    numbers = ref_check.compare(prog.entry, recorded, ref, here=cell.here)
    log(f"reference {clock() - t_ref:.3f} s")
    checks = ref_check.judge(numbers, cell.limits)
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    result = {"correct": ref_check.correct(checks), "attempted": win["units"], "failed": 0,
              "metrics": metrics, "device": device_line}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
