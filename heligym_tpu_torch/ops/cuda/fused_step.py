"""The fused env step: hand-written CUDA kernels for whole env transitions.

Counterpart of the JAX package's `ops/pallas/fused_step.py`. The kernels
(`csrc/fused_step.cu`) run Dryden wind RK4, helicopter RK4, the task reward
(every task of `envs/tasks.py`; a `MixedTask` env evaluates the sub-task its
task id names), counters, termination at the post-step terrain height
(gathered in the kernel from the packed texel table), the collect rows and
the auto-reset select. Each transition is finished inside its launch, so the
JAX path's one-step-late flag pipelining and its XLA epilogue are gone, and
the outputs equal `HeliEnv.step_with_eta` followed by `auto_reset`.

Two launch forms share one device step function:
  * `fused_step`: one transition per launch (the evaluator, and each step of
    the policy loop);
  * `fused_rollout`: T transitions in one launch, the carry in registers
    between them (the env-only rollout, `build_fused_rollout`).
Both take CUDA tensors and launch (or raise), or CPU tensors and run
`fused_step_plain`, the same function written with the port's torch modules.
Nothing falls back from one to the other. The constant and task tables go to
the kernel by value, in its parameter block. An airframe with a wing
(`has_wing`) runs each form's winged instantiation, one without the
wingless one.

Row maps (envs contiguous within a row):
  carry (63, B): 0-17 heli (HELI_STATE_FIELDS order) | 18-22 wind |
    23-39 obs | 40-57 dots | 58-60 wind_ned | 61 steps | 62 successed_steps
  init (62, B): rows 0-60 of a fresh episode's carry (the ResetSnapshot) |
    61 task_id (a small integer, exact in f32)
  collect (39, B) per step: 0 reward | 1 done | 2 truncated | 3 failed |
    4-20 obs after auto-reset | 21 succ_step (in-tolerance flag) |
    22-38 obs before auto-reset (what the value bootstrap reads)
  act (B, 4); eta (3, B) already scaled by 1/sqrt(dt).
  tasks (n_tasks, 8), n_tasks <= MAX_TASKS: kind (index into TASK_KINDS) |
    the task's `folded()` targets, zero-padded.

`build_fused_rollout` drives it with given actions, `build_fused_policy_rollout`
with a policy in the loop (the RL collection path; on the card the whole
loop is one CUDA graph, replayed once per rollout).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...envs.env import EnvState, HeliEnv, _non_finite
from ...envs.tasks import MixedTask
from ...ops import dryden, terrain as terrain_ops
from ...ops.state import HeliState, WindState
from ...utils.constants import D2R, EPS, RK4_SIXTH, SQRT_3, TWO_D_PI
from ...utils.math import recip32

KERNEL = "fused_step"
REPLACES = "heligym_tpu/ops/pallas/fused_step.py:201"

# carry-block row offsets
H0, W0, O0, D0, N0 = 0, 18, 23, 40, 58
SROWS = 61                      # state rows
STEPS, SUCC = 61, 62
CROWS = 63
# init-block rows: the state rows, then the task id
ITID, IROWS = 61, 62
# collect-block rows
CREW, CDONE, CTRUNC, CFAIL, COBS0, CSUCC, CFINAL0, XROWS = 0, 1, 2, 3, 4, 21, 22, 39

# Bytes an env-step moves besides the carry, the action, the noise and two
# texel rows: the collect block when collected; the init block's state rows
# only in lanes whose episode ended; its task-id row for a MixedTask.
BYTES_COLLECT = 4 * XROWS
BYTES_RESET = 4 * SROWS
BYTES_TASK_ID = 4

# Env steps the kernels ran (not the plain version) since import: a one-step
# launch adds 1, a T-step launch T, a replay of the policy loop's graph T, a
# capture of that graph 1 (its warm-up launch).
launches = 0
# Host calls that ran the kernels: one-step launches, T-step launches, graph
# replays, graph captures.
calls = {"step": 0, "rollout": 0, "replay": 0, "capture": 0}

# Threads per block of every launch (one thread per env), chosen by
# measurement on the H100 (PERF.md): 32, 64 and 128 run within 5% of each
# other, 64 the best or within 2% of the best at 4096 envs. Block sizes the
# kernel takes: 32, 64, 128. Only a measurement sweeping them sets another.
BLOCK = 64

# The kernel's constant table, one f32 each, in the order of `enum Const` in
# csrc/fused_step.cu.
_IDX3 = [f"{i}{j}" for i in range(3) for j in range(3)]
CONST_NAMES = (
    "D2R",
    "COL_OS", "COL_SPAN", "COL_MID", "LON_SPAN", "LON_MID", "LAT_SPAN", "LAT_MID",
    "PED_OS", "PED_SPAN", "PED_MID",
    "WT", "T0", "LAPSE", "INV_T0", "RHO_EXP", "RO_SEA",
    "PI", "TWO_PI", "EPS", "P3", "BIG",
    "MR_GAM_OM16_DRO", "MR_KC_NUM", "MR_K1", "MR_OMEGA", "MR_DL_DA1_DRO",
    "MR_DL_DB1", "MR_IS", "MR_WB_C1", "MR_TW075", "MR_INV_VTIP", "MR_TW05",
    "MR_COEF_TH", "MR_VIDOT_C", "MR_R", "MR_FR4", "MR_VTIP", "MR_VTIP2",
    "MR_INV_OMEGA", "MR_INV_ASIGMA", "MR_2_VTIP", "VTRANS", "MR_H", "MR_D",
    "MR_INV_R",
    "TR_D", "TR_H", "TR_WB_C1", "TR_TW075", "TR_INV_VTIP", "TR_TW05",
    "TR_COEF_TH", "TR_VIDOT_C", "TR_R2", "TR_OMEGA",
    "FUS_HARM", "FUS_DARM", "FUS_COR", "FUS_XUU", "FUS_YVV", "FUS_ZWW", "FUS_H",
    "HT_HARM", "HT_DARM", "HT_D", "HT_ZMAX", "HT_ZUU", "HT_ZUW",
    "VT_D", "VT_H", "VT_YMAX", "VT_YUU", "VT_YUV",
    "WL_CG12", "LG_C", "LG_K",
    *[f"LG_LOC_{ij}" for ij in _IDX3],
    "HP_LOSS_FT", "INV_M",
    *[f"I_{ij}" for ij in _IDX3],
    *[f"IINV_{ij}" for ij in _IDX3],
    "INV_550",
    "HALF_DT", "DT", "RK4_C",
    "WM0", "WM1", "WM2",
    "TEP_RF",
    *[f"TEP_KEY_{k}" for k in range(12)],
    *[f"TEP_A_{k}" for k in range(12)],
    *[f"TEP_B_{k}" for k in range(12)],
    "TB_A", "TB_B", "P12", "P04", "SW_LO", "AZC_LO", "AZS_LO", "INV_1000",
    "TWO_D_PI", "TWO_SQRT3",
    "NORM_T", "NORM_T2", "INV_NORM_X", "INV_NORM_V", "INV_NORM_A", "THIRD",
    "TIME_UP_STEPS", "SUCC_REQ", "VTIP005", "ANG60", "NS_HALF", "EW_HALF",
    "INV_XSCALE", "INV_YSCALE", "HALF_H", "HALF_W", "HM1",
    "WN_ZUU", "WN_ZUW", "WN_ZMAX", "WN_INV_PI",
)


def const_values(env: HeliEnv) -> dict:
    """Every constant the kernel reads, folded on the host in float64 with
    the grouping of the JAX expressions it stands for (each is rounded to
    float32 once, where it meets a tensor). `recip32` marks a division by a
    constant, which XLA and PyTorch's CUDA kernels turn into a multiply by
    the float32 reciprocal."""
    p, norm = env.params, env.normalizers
    H, E, MR, TR = p.HELI, p.ENV, p.MR, p.TR
    FUS, HT, VT, WN, LG = p.FUS, p.HT, p.VT, p.WN, p.LG
    wp = env.wind_params
    r_factor, col_keys, row_a, row_b = dryden.tep_static_row(wp.turbulence_level)
    w20 = wp.turbulence_level / 7.0 * 88.61
    h, w = env.terrain.hmap.shape
    v = {
        "D2R": D2R,
        "COL_OS": H.COL_OS, "COL_SPAN": H.COL_H - H.COL_L,
        "COL_MID": 0.5 * (H.COL_H + H.COL_L),
        "LON_SPAN": H.LON_H - H.LON_L, "LON_MID": 0.5 * (H.LON_H + H.LON_L),
        "LAT_SPAN": H.LAT_H - H.LAT_L, "LAT_MID": 0.5 * (H.LAT_H + H.LAT_L),
        "PED_OS": H.PED_OS, "PED_SPAN": H.PED_H - H.PED_L,
        "PED_MID": 0.5 * (H.PED_H + H.PED_L),
        "WT": H.WT, "T0": E.T0, "LAPSE": E.LAPSE, "INV_T0": recip32(E.T0),
        "RHO_EXP": (E.GRAV / (E.LAPSE * E.R)) - 1.0, "RO_SEA": E.RO_SEA,
        "PI": math.pi, "TWO_PI": 2.0 * math.pi, "EPS": EPS, "P3": 0.3, "BIG": 1e30,
        "MR_GAM_OM16_DRO": MR.GAM_OM16_DRO,
        "MR_KC_NUM": 0.75 * MR.OMEGA * MR.E / MR.R, "MR_K1": MR.K1,
        "MR_OMEGA": MR.OMEGA, "MR_DL_DA1_DRO": MR.DL_DA1_DRO,
        "MR_DL_DB1": MR.DL_DB1, "MR_IS": MR.IS,
        "MR_WB_C1": 0.66667 * MR.V_TIP, "MR_TW075": 0.75 * MR.TWST,
        "MR_INV_VTIP": recip32(MR.V_TIP), "MR_TW05": 0.5 * MR.TWST,
        "MR_COEF_TH": MR.COEF_TH, "MR_VIDOT_C": 0.75 * math.pi / MR.R,
        "MR_R": MR.R, "MR_FR4": MR.FR / 4.0, "MR_VTIP": MR.V_TIP,
        "MR_VTIP2": MR.V_TIP * MR.V_TIP, "MR_INV_OMEGA": recip32(MR.OMEGA),
        "MR_INV_ASIGMA": recip32(MR.A_SIGMA), "MR_2_VTIP": 2.0 / MR.V_TIP,
        "VTRANS": H.VTRANS, "MR_H": MR.H, "MR_D": MR.D,
        "MR_INV_R": recip32(MR.R),
        "TR_D": TR.D, "TR_H": TR.H, "TR_WB_C1": 0.66667 * TR.V_TIP,
        "TR_TW075": 0.75 * TR.TWST, "TR_INV_VTIP": recip32(TR.V_TIP),
        "TR_TW05": 0.5 * TR.TWST, "TR_COEF_TH": TR.COEF_TH,
        "TR_VIDOT_C": 0.75 * math.pi / TR.R, "TR_R2": TR.R ** 2,
        "TR_OMEGA": TR.OMEGA,
        "FUS_HARM": MR.H - FUS.H, "FUS_DARM": FUS.D - MR.D, "FUS_COR": FUS.COR,
        "FUS_XUU": FUS.XUU, "FUS_YVV": FUS.YVV, "FUS_ZWW": FUS.ZWW,
        "FUS_H": FUS.H,
        "HT_HARM": MR.H - HT.H, "HT_DARM": HT.D - MR.D - MR.R, "HT_D": HT.D,
        "HT_ZMAX": HT.ZMAX, "HT_ZUU": HT.ZUU, "HT_ZUW": HT.ZUW,
        "VT_D": VT.D, "VT_H": VT.H, "VT_YMAX": VT.YMAX, "VT_YUU": VT.YUU,
        "VT_YUV": VT.YUV,
        "WL_CG12": H.WL_CG / 12.0, "LG_C": LG.C, "LG_K": LG.K,
        **{f"LG_LOC_{i}{j}": LG.LOC[i][j] for i in range(3) for j in range(3)},
        "HP_LOSS_FT": 550.0 * H.HP_LOSS, "INV_M": recip32(H.M),
        **{f"I_{i}{j}": H.I[i][j] for i in range(3) for j in range(3)},
        **{f"IINV_{i}{j}": H.IINV[i][j] for i in range(3) for j in range(3)},
        "INV_550": recip32(550.0),
        "HALF_DT": 0.5 * env.dt, "DT": env.dt, "RK4_C": RK4_SIXTH * env.dt,
        "WM0": wp.mean_ned[0], "WM1": wp.mean_ned[1], "WM2": wp.mean_ned[2],
        "TEP_RF": r_factor,
        **{f"TEP_KEY_{k}": col_keys[k] for k in range(12)},
        **{f"TEP_A_{k}": row_a[k] for k in range(12)},
        **{f"TEP_B_{k}": row_b[k] for k in range(12)},
        "TB_A": 0.177, "TB_B": 0.000823, "P12": 1.2, "P04": 0.4,
        "SW_LO": 0.1 * w20,
        "AZC_LO": float(np.cos(np.float32(wp.wind_dir_rad))),
        "AZS_LO": float(np.sin(np.float32(wp.wind_dir_rad))),
        "INV_1000": recip32(1000.0), "TWO_D_PI": TWO_D_PI,
        "TWO_SQRT3": 2.0 * SQRT_3,
        "NORM_T": norm.t, "NORM_T2": norm.t ** 2,
        "INV_NORM_X": recip32(norm.x), "INV_NORM_V": recip32(norm.v),
        "INV_NORM_A": recip32(norm.a), "THIRD": recip32(3.0),
        "TIME_UP_STEPS": float(env.time_up_steps),
        "SUCC_REQ": float(env.success_steps_required),
        "VTIP005": MR.V_TIP * 0.05, "ANG60": 60.0 * D2R,
        "NS_HALF": E.NS_MAX / 2.0, "EW_HALF": E.EW_MAX / 2.0,
        "INV_XSCALE": recip32(env.terrain.ns_max / h),
        "INV_YSCALE": recip32(env.terrain.ew_max / w),
        "HALF_H": float(h // 2), "HALF_W": float(w // 2), "HM1": float(h - 1),
        "WN_ZUU": WN.ZUU, "WN_ZUW": WN.ZUW, "WN_ZMAX": WN.ZMAX,
        "WN_INV_PI": recip32(math.pi),
    }
    return v


# Task kinds of the kernel's task table, in the order of `enum TaskKind` in
# csrc/fused_step.cu; a task names its kind with `Task.KIND`.
TASK_KINDS = ("none", "hover", "forward", "turning", "slalom", "landing",
              "oblique")
TASK_STRIDE = 8                 # kind + up to 5 folded targets + 2 pad
MAX_TASKS = 8                   # task-table rows the kernel's parameter block holds


def task_table(env: HeliEnv) -> np.ndarray:
    """The (n_tasks, TASK_STRIDE) f32 table the kernel reads: one row per
    sub-task of a MixedTask, one row for a plain task. Each row is the
    task's kind and its `folded()` targets — the very floats `Task.reward`
    uses — zero-padded."""
    subs = env.task.tasks if isinstance(env.task, MixedTask) else (env.task,)
    if not subs:
        raise ValueError("MixedTask needs at least one sub-task")
    table = np.zeros((len(subs), TASK_STRIDE), np.float32)
    for row, task in zip(table, subs):
        if task.KIND not in TASK_KINDS:
            raise NotImplementedError(
                f"the fused CUDA step has no reward for {type(task).__name__}")
        targets = task.folded(env.normalizers)
        row[0] = TASK_KINDS.index(task.KIND)
        row[1:1 + len(targets)] = targets
    return table


@functools.lru_cache(maxsize=8)
def _tables(env: HeliEnv) -> Tuple[np.ndarray, np.ndarray]:
    """(constant table (K_COUNT,), task table (n_tasks, TASK_STRIDE)) of
    `env`, f32 host arrays: the C entry points copy them into the kernel's
    parameter block, constants first, in `CONST_NAMES` order."""
    vals = const_values(env)
    consts = np.array([vals[n] for n in CONST_NAMES], dtype=np.float32)
    tasks = np.ascontiguousarray(task_table(env))
    if tasks.shape[0] > MAX_TASKS:
        raise ValueError(f"the fused CUDA step takes at most {MAX_TASKS} tasks, "
                         f"not {tasks.shape[0]}")
    return consts, tasks


def has_wing(env: HeliEnv) -> bool:
    """Whether `env`'s airframe has the wing term, gated as the JAX package
    gates it (`ops/aero.py::wing`): `WN.ZUW != 0`. It picks the kernels'
    winged instantiation."""
    return env.params.WN.ZUW != 0.0


# -- packing ---------------------------------------------------------------

def pack(es: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(carry (63, B), init (62, B)) from a batched EnvState."""
    carry = torch.cat([
        es.heli.rows(), es.wind.rows(), es.obs.T, es.dots.rows(), es.wind_ned.T,
        es.steps.to(torch.float32)[None],
        es.successed_steps.to(torch.float32)[None]], dim=0).contiguous()
    s = es.init
    init = torch.cat([s.heli.rows(), s.wind.rows(), s.obs.T, s.dots.rows(),
                      s.wind_ned.T, es.task_id.to(torch.float32)[None]],
                     dim=0).contiguous()
    return carry, init


def unpack(es: EnvState, carry: torch.Tensor) -> EnvState:
    """EnvState from a carry block (views of it); `es` supplies init."""
    return es.replace(
        heli=HeliState.from_rows(carry[H0:W0]),
        wind=WindState.from_rows(carry[W0:O0]),
        obs=carry[O0:D0].T, dots=HeliState.from_rows(carry[D0:N0]),
        wind_ned=carry[N0:SROWS].T,
        steps=carry[STEPS].to(torch.int32),
        successed_steps=carry[SUCC].to(torch.int32))


# -- the plain version -----------------------------------------------------

def fused_step_plain(env: HeliEnv, carry, init, act, eta, auto_reset: bool = True):
    """The kernel's function in the port's torch modules:
    (carry, init, act, eta) -> (carry', collect)."""
    heli = HeliState.from_rows(carry[H0:W0])
    wind = WindState.from_rows(carry[W0:O0])
    obs = carry[O0:D0]
    h_ground = terrain_ops.ground_height(env.terrain, heli.x, heli.y)
    wind_new, wnd, heli_new, dots, obs_t, reward, succ_step = env.step_physics(
        heli, wind, (obs[4], obs[5], obs[6], obs[16]),
        (eta[0], eta[1], eta[2]), tuple(act[:, i] for i in range(4)), h_ground,
        task_id=init[ITID].to(torch.int32))

    # counters: success counted before this step's flag is added
    steps1 = carry[STEPS] + 1.0
    succ0 = carry[SUCC]
    f_succ = succ0 >= float(env.success_steps_required)
    time_up = steps1 >= float(env.time_up_steps)
    succ1 = succ0 + succ_step.to(torch.float32)

    h_post = terrain_ops.ground_height(env.terrain, heli_new.x, heli_new.y)
    bad = _non_finite(reward) | _non_finite(heli_new.z) | _non_finite(heli_new.u)
    failed = env._is_failed(heli_new, dots, h_post) | bad
    done = failed | f_succ

    final_obs = torch.stack(obs_t)
    state = torch.cat([heli_new.rows(), wind_new.rows(), final_obs,
                       dots.rows(), torch.stack(wnd)], dim=0)
    if auto_reset:
        ended = done | time_up
        state = torch.where(ended, init[:SROWS], state)
        steps1 = torch.where(ended, 0.0, steps1)
        succ1 = torch.where(ended, 0.0, succ1)
    carry_new = torch.cat([state, steps1[None], succ1[None]], dim=0)
    f = lambda b: b.to(torch.float32)[None]
    collect = torch.cat([reward[None], f(done), f(time_up), f(failed),
                         state[O0:D0], f(succ_step), final_obs], dim=0)
    return carry_new, collect




def _plain_rollout(env: HeliEnv, carry, init, actions, eta_seq, auto_reset):
    """T transitions of the plain version: (carry', collect (T, 39, B))."""
    xs = []
    for t in range(eta_seq.shape[0]):
        act = actions[t] if actions.dim() == 3 else actions
        carry, x = fused_step_plain(env, carry, init, act, eta_seq[t], auto_reset)
        xs.append(x)
    return carry, torch.stack(xs)


# -- the wrappers ----------------------------------------------------------

def fused_step(env: HeliEnv, carry, init, act, eta, auto_reset: bool = True,
               carry_out: Optional[torch.Tensor] = None,
               collect_out: Optional[torch.Tensor] = None,
               collect: bool = True):
    """One env transition for every env: (carry, init, act, eta) ->
    (carry', collect). On CUDA tensors it launches the one-step kernel; on
    CPU tensors it runs `fused_step_plain`.

    `carry_out` may be `carry` itself (updated in place). With
    `collect=False` the collect block is not written and None is returned
    in its place."""
    global launches
    if carry.device.type == "cpu":
        return _outputs(*fused_step_plain(env, carry, init, act, eta, auto_reset),
                        carry_out, collect_out, collect)
    _check_device(carry)
    n, dev = carry.shape[1], carry.device
    carry_out = torch.empty_like(carry) if carry_out is None else carry_out
    if not collect:
        collect_out = None
    elif collect_out is None:
        collect_out = torch.empty((XROWS, n), dtype=torch.float32, device=dev)
    args = launch_args(env, carry, init, act, eta, auto_reset, carry_out,
                       collect_out)
    with torch.cuda.device(dev):
        _raise_on(kernel_fn()(*args), "fused_step")
    launches += 1
    calls["step"] += 1
    return carry_out, collect_out


def fused_rollout(env: HeliEnv, carry, init, actions, eta_seq,
                  auto_reset: bool = True,
                  carry_out: Optional[torch.Tensor] = None,
                  collect_out: Optional[torch.Tensor] = None,
                  collect: bool = True):
    """T env transitions for every env in one launch: (carry, init,
    actions, eta_seq) -> (carry', collect (T, 39, B)). `actions` is
    (T, B, 4), or (B, 4) held for every step; `eta_seq` (T, 3, B) fixes T.
    On CUDA tensors one launch runs all T steps with the carry in
    registers; on CPU tensors the plain version runs T times. The outputs
    equal T `fused_step` calls."""
    global launches
    if carry.device.type == "cpu":
        return _outputs(*_plain_rollout(env, carry, init, actions, eta_seq, auto_reset),
                        carry_out, collect_out, collect)
    _check_device(carry)
    steps, n, dev = eta_seq.shape[0], carry.shape[1], carry.device
    carry_out = torch.empty_like(carry) if carry_out is None else carry_out
    if not collect:
        collect_out = None
    elif collect_out is None:
        collect_out = torch.empty((steps, XROWS, n), dtype=torch.float32, device=dev)
    args = rollout_args(env, carry, init, actions, eta_seq, auto_reset, carry_out,
                        collect_out)
    with torch.cuda.device(dev):
        _raise_on(rollout_kernel_fn()(*args), "fused_rollout")
    launches += steps
    calls["rollout"] += 1
    return carry_out, collect_out


def _outputs(new, x, carry_out, collect_out, collect: bool):
    """The plain version's results, written into the caller's buffers where
    given."""
    if carry_out is not None:
        new = carry_out.copy_(new)
    if collect_out is not None:
        x = collect_out.copy_(x)
    return new, (x if collect else None)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the fused step runs on CUDA or CPU tensors, not {t.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _checked(env: HeliEnv, carry, init, act, eta, carry_out, collect_out,
             steps: Optional[int]) -> tuple:
    """(constant table, task table) of a launch after checking its tensors:
    each a contiguous float32 tensor of its shape on the carry's device
    (`steps` leads the shapes of a T-step launch's act, eta and collect
    blocks; a (B, 4) act is held for every step)."""
    n, dev = carry.shape[1], carry.device
    lead = () if steps is None else (steps,)
    texels = env.terrain.packed
    for name, t, shape in (
            ("carry", carry, (CROWS, n)), ("init", init, (IROWS, n)),
            ("act", act, (n, 4) if act.dim() == 2 else lead + (n, 4)),
            ("eta", eta, lead + (3, n)),
            ("terrain.packed", texels, (texels.shape[0], 3)),
            ("carry_out", carry_out, (CROWS, n)),
            ("collect_out", collect_out, lead + (XROWS, n))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected a contiguous float32 {shape} tensor on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return _tables(env)


def launch_args(env: HeliEnv, carry, init, act, eta, auto_reset, carry_out,
                collect_out) -> tuple:
    """The checked arguments of one one-step launch, in the order of the C
    entry point `heligym_fused_step`."""
    consts, tasks = _checked(env, carry, init, act, eta, carry_out, collect_out,
                             None)
    map_h, map_w = env.terrain.hmap.shape
    return (carry.data_ptr(), carry_out.data_ptr(), init.data_ptr(),
            act.data_ptr(), eta.data_ptr(), env.terrain.packed.data_ptr(),
            consts.ctypes.data, tasks.ctypes.data,
            None if collect_out is None else collect_out.data_ptr(),
            carry.shape[1], int(auto_reset), map_h, map_w, tasks.shape[0],
            int(isinstance(env.task, MixedTask)), int(has_wing(env)), BLOCK,
            torch.cuda.current_stream(carry.device).cuda_stream)


def rollout_args(env: HeliEnv, carry, init, actions, eta_seq, auto_reset,
                 carry_out, collect_out) -> tuple:
    """The checked arguments of one T-step launch, in the order of the C
    entry point `heligym_fused_rollout`."""
    steps, n = eta_seq.shape[0], carry.shape[1]
    if steps < 1:
        raise ValueError("a rollout needs at least one step")
    consts, tasks = _checked(env, carry, init, actions, eta_seq, carry_out,
                             collect_out, steps)
    map_h, map_w = env.terrain.hmap.shape
    return (carry.data_ptr(), carry_out.data_ptr(), init.data_ptr(),
            actions.data_ptr(), 0 if actions.dim() == 2 else 4 * n,
            eta_seq.data_ptr(), env.terrain.packed.data_ptr(),
            consts.ctypes.data, tasks.ctypes.data,
            None if collect_out is None else collect_out.data_ptr(),
            n, steps, int(auto_reset), map_h, map_w, tasks.shape[0],
            int(isinstance(env.task, MixedTask)), int(has_wing(env)), BLOCK,
            torch.cuda.current_stream(carry.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _lib(flags: Optional[Tuple[str, ...]] = None):
    """The kernels' library, built from csrc/ at first use (with `flags`,
    by default the port's nvcc flags), its layouts checked against this
    module's."""
    from . import build
    lib = build.load(KERNEL, flags or build.NVCC_FLAGS)
    if (lib.heligym_fused_step_const_count() != len(CONST_NAMES)
            or lib.heligym_fused_step_task_kind_count() != len(TASK_KINDS)
            or lib.heligym_fused_step_task_stride() != TASK_STRIDE
            or lib.heligym_fused_step_max_tasks() != MAX_TASKS
            or lib.heligym_fused_step_param_bytes()
            != 4 * (len(CONST_NAMES) + MAX_TASKS * TASK_STRIDE)):
        raise RuntimeError("csrc/fused_step.cu's parameter block differs from "
                           "CONST_NAMES / TASK_KINDS / MAX_TASKS")
    return lib


@functools.lru_cache(maxsize=None)
def kernel_fn(flags: Optional[Tuple[str, ...]] = None):
    """The one-step C entry point `heligym_fused_step`."""
    import ctypes
    fn = _lib(flags).heligym_fused_step
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def rollout_kernel_fn(flags: Optional[Tuple[str, ...]] = None):
    """The T-step C entry point `heligym_fused_rollout`."""
    import ctypes
    fn = _lib(flags).heligym_fused_rollout
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ctypes.c_longlong] + [vp] * 5 + [ci] * 9 + [vp]
    fn.restype = ci
    return fn


# -- the rollouts ----------------------------------------------------------

def build_fused_rollout(env: HeliEnv, num_envs: int, steps: int,
                        collect: Tuple[str, ...] = ("reward", "done"),
                        auto_reset: bool = True, eta_mode: str = "batch"):
    """Fused rollout: `rollout(es, actions, eta_seq=None, generator=None) ->
    (es', outs)`. On the card one `fused_rollout` launch runs all `steps`;
    on the CPU the plain version runs step by step.

    `actions`: (steps, num_envs, 4), or (num_envs, 4) held constant.
    `eta_mode`: "batch" draws the whole rollout's Dryden noise (steps, 3, B)
    at once with `torch.randn(generator=...)` on the state's device;
    "inject" takes an explicit `eta_seq` (steps, 3, num_envs) already
    scaled by 1/sqrt(dt) — the parity-test seam.
    `outs` holds per transition, after auto-reset: "reward" (T, B);
    "done" and "truncated" (T, B) bool; "failed" (T, B) bool; "obs"
    (T, B, 17), each when named in `collect`.
    """
    if eta_mode not in ("batch", "inject"):
        raise ValueError(f"eta_mode must be 'batch' or 'inject', not {eta_mode!r}")

    def rollout(es: EnvState, actions, eta_seq=None,
                generator: Optional[torch.Generator] = None):
        dev = es.obs.device
        if eta_mode == "inject":
            if eta_seq is None:
                raise ValueError("eta_mode='inject' needs an eta_seq")
        else:
            eta_seq = torch.randn((steps, 3, num_envs), generator=generator,
                                  device=dev) * (1.0 / env.dt) ** 0.5
        actions, eta_seq = actions.contiguous(), eta_seq.contiguous()
        carry, init = pack(es)
        xbuf = (torch.empty((steps, XROWS, num_envs), dtype=torch.float32,
                            device=dev) if collect else None)
        fused_rollout(env, carry, init, actions, eta_seq, auto_reset=auto_reset,
                      carry_out=carry, collect_out=xbuf, collect=bool(collect))
        outs = {}
        if "reward" in collect:
            outs["reward"] = xbuf[:, CREW]
        if "done" in collect:
            outs["done"] = xbuf[:, CDONE] != 0
            outs["truncated"] = xbuf[:, CTRUNC] != 0
        if "failed" in collect:
            outs["failed"] = xbuf[:, CFAIL] != 0
        if "obs" in collect:
            outs["obs"] = xbuf[:, COBS0:CSUCC].permute(0, 2, 1)
        return unpack(es, carry), outs

    return rollout


# Policy parameters as the graph holds them: every tensor and module of the
# caller's tree has a static copy inside the graph, refreshed before each
# replay; everything else (shapes, Python scalars) keys the capture.

def _static_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _static_copy(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_static_copy(v) for v in x)
    if isinstance(x, dict):
        return {k: _static_copy(v) for k, v in x.items()}
    return x


def _pairs(static, x):
    """(static tensor, caller's tensor) for every tensor of the tree `x`."""
    if isinstance(x, torch.Tensor):
        yield static, x
    elif isinstance(x, torch.nn.Module):
        yield from zip((v.detach() for v in static.state_dict(keep_vars=True).values()),
                       (v.detach() for v in x.state_dict(keep_vars=True).values()))
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _pairs(getattr(static, f.name), getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for a, b in zip(static, x):
            yield from _pairs(a, b)
    elif isinstance(x, dict):
        for k in x:
            yield from _pairs(static[k], x[k])


def _signature(x):
    """What a captured graph depends on besides tensor values."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, torch.nn.Module):
        return (type(x), tuple((k, _signature(v)) for k, v in
                               x.state_dict(keep_vars=True).items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple((f.name, _signature(getattr(x, f.name)))
                               for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _signature(v)) for k, v in sorted(x.items())))
    return ("value", type(x), x)


def build_fused_policy_rollout(env: HeliEnv, num_envs: int, steps: int,
                               policy_fn: Callable, auto_reset: bool = True):
    """Fused rollout driven by a policy in the loop (the RL collection
    path): per step, `policy_fn(policy_params, obs (B, 17), generator) ->
    (actions (B, 4) in [-1, 1], aux dict)` runs in PyTorch, then the physics
    runs in one `fused_step`. Returns `rollout(es, policy_params,
    generator=None, eta_seq=None, graphed=None) -> (es', traj)`.

    On CUDA tensors the whole loop (obs copy, `policy_fn`, action copy, the
    step kernel) of `steps` steps is captured once into one
    `torch.cuda.CUDAGraph` and replayed once per call, after the packed
    carry, init, noise and the tensors of `policy_params` are copied into
    its static buffers; `generator` is registered with the graph, so a replay
    draws what the eager loop draws. A new capture is made when the
    generator or the shapes and Python scalars of `policy_params` change.
    `graphed=False` runs the eager loop on the card instead (the reference
    the graph is held against); on CPU tensors the eager loop runs, and
    `graphed=True` raises. A capture that fails raises.

    `traj` holds per transition, leading axis `steps`: "obs" (the obs the
    policy saw: after the previous transition's auto-reset), "action",
    "reward", "terminated", "truncated", "failed", "succ_step" (bool),
    "final_obs" (the obs after the step, before auto-reset: what a
    truncation-aware GAE bootstraps from), plus the policy's aux entries.
    The Dryden noise of the whole rollout is drawn at once from
    `generator`, before the policy's draws; `eta_seq` (steps, 3, num_envs),
    already scaled by 1/sqrt(dt), replaces it (the parity-test seam).
    Nothing here records gradients.
    """
    captured = {}                       # the current graph and its buffers

    def traj_of(xbuf, obs_buf, act_buf, aux):
        return {"obs": obs_buf, "action": act_buf, "reward": xbuf[:, CREW],
                "terminated": xbuf[:, CDONE] != 0,
                "truncated": xbuf[:, CTRUNC] != 0,
                "failed": xbuf[:, CFAIL] != 0,
                "succ_step": xbuf[:, CSUCC] != 0,
                "final_obs": xbuf[:, CFINAL0:XROWS].permute(0, 2, 1), **aux}

    def loop(carry, init, eta_seq, policy_params, generator, xbuf, obs_buf,
             act_buf, launch):
        """The loop body of every path; `launch(t)` runs step t's physics."""
        aux_seq = {}
        for t in range(steps):
            # the carry's obs rows already hold the post-reset obs
            obs_buf[t].copy_(carry[O0:D0].T)
            actions, aux = policy_fn(policy_params, obs_buf[t], generator)
            act_buf[t].copy_(actions)
            for k, v in aux.items():
                aux_seq.setdefault(k, []).append(v)
            launch(t)
        return {k: torch.stack(v) for k, v in aux_seq.items()}

    def buffers(dev):
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        return new(steps, XROWS, num_envs), new(steps, num_envs, 17), \
            new(steps, num_envs, 4)

    def eager(es, policy_params, generator, eta_seq):
        carry, init = pack(es)
        xbuf, obs_buf, act_buf = buffers(carry.device)
        launch = lambda t: fused_step(env, carry, init, act_buf[t], eta_seq[t],
                                      auto_reset=auto_reset, carry_out=carry,
                                      collect_out=xbuf[t])
        aux = loop(carry, init, eta_seq, policy_params, generator, xbuf, obs_buf,
                   act_buf, launch)
        return unpack(es, carry), traj_of(xbuf, obs_buf, act_buf, aux)

    def capture(dev, policy_params, generator):
        """Static buffers, a warm-up step on a side stream (scratch noise
        generator, scratch state: cuBLAS and the allocator settle, and the
        step kernel runs once, counted in `launches`), then the capture.
        The launch arguments are checked here, once."""
        global launches
        g = {"carry": torch.zeros((CROWS, num_envs), device=dev),
             "init": torch.zeros((IROWS, num_envs), device=dev),
             "eta": torch.zeros((steps, 3, num_envs), device=dev),
             "params": _static_copy(policy_params)}
        g["xbuf"], g["obs"], g["act"] = buffers(dev)
        fn = kernel_fn()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            obs = g["carry"][O0:D0].T.contiguous()
            actions, _ = policy_fn(g["params"], obs, torch.Generator(device=dev))
            scratch = g["carry"].clone()
            _raise_on(fn(*launch_args(env, scratch, g["init"],
                                      actions.contiguous(), g["eta"][0],
                                      auto_reset, scratch, None)), "fused_step")
        launches += 1
        calls["capture"] += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # A dead graph (an old collector's, in a reference cycle) that the
        # cyclic collector frees mid-capture invalidates the capture: free
        # such cycles now and keep the collector off until the capture ends.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                args = [launch_args(env, g["carry"], g["init"], g["act"][t],
                                    g["eta"][t], auto_reset, g["carry"], g["xbuf"][t])
                        for t in range(steps)]
                g["aux"] = loop(g["carry"], g["init"], g["eta"], g["params"],
                                generator, g["xbuf"], g["obs"], g["act"],
                                lambda t: _raise_on(fn(*args[t]), "fused_step"))
        finally:
            if gc_was_on:
                gc.enable()
        g["graph"] = graph
        return g

    def graphed_run(es, policy_params, generator, eta_seq):
        global launches
        dev = es.obs.device
        key = (_signature(policy_params), dev)
        g = captured.get("g")
        if g is None or g["key"] != key or g["generator"] is not generator:
            captured.clear()            # free the old graph's pool first
            g = capture(dev, policy_params, generator)
            g["key"], g["generator"] = key, generator
            captured["g"] = g
        carry, init = pack(es)
        dst, src = zip(*_pairs((g["carry"], g["init"], g["eta"], g["params"]),
                               (carry, init, eta_seq, policy_params)))
        torch._foreach_copy_(list(dst), list(src))
        g["graph"].replay()
        launches += steps
        calls["replay"] += 1
        # the caller owns what it gets: the next replay rewrites the buffers
        aux = {k: v.clone() for k, v in g["aux"].items()}
        traj = traj_of(g["xbuf"].clone(), g["obs"].clone(), g["act"].clone(), aux)
        return unpack(es, g["carry"].clone()), traj

    def rollout(es: EnvState, policy_params,
                generator: Optional[torch.Generator] = None, eta_seq=None,
                graphed: Optional[bool] = None):
        dev = es.obs.device
        on_card = dev.type == "cuda"
        if graphed is None:
            graphed = on_card
        if graphed and not on_card:
            raise ValueError("the graphed policy rollout runs on CUDA tensors only; "
                             f"the state lies on {dev}")
        if eta_seq is None:
            eta_seq = torch.randn((steps, 3, num_envs), generator=generator,
                                  device=dev) * (1.0 / env.dt) ** 0.5
        eta_seq = eta_seq.contiguous()
        # the capture, its side stream and the replay on the state's card,
        # whichever card is current
        with torch.no_grad(), (torch.cuda.device(dev) if on_card
                               else contextlib.nullcontext()):
            if graphed:
                return graphed_run(es, policy_params, generator, eta_seq)
            return eager(es, policy_params, generator, eta_seq)

    return rollout
