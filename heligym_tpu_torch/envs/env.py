"""Functional env core: `step` over an EnvState of (batched) tensors.

All per-step logic — Dryden wind, helicopter RK4, reward, termination,
success accounting — is one function of (EnvState, action). State fields are
() for one env or (B,) for a batch; nothing here loops over envs.

Step ordering preserved from the reference:
  1. wind RK4 driven by the *previous* observation's NED velocity/ground
     altitude;
  2. helicopter RK4 under the freshly produced turbulent wind;
  3. reward from post-step state + k4 derivatives;
  4. failed/success accounting with `successed` evaluated BEFORE adding this
     step's success time.

The env runs on the CUDA card unless the caller asks for another device:
`HeliEnv.build(device=None)` means "cuda" and raises when there is no card.

Host trims are kept in a disk cache under `HELIGYM_TPU_TORCH_CACHE`
(default `~/.cache/heligym_tpu_torch`), apart from the JAX package's cache:
the two solvers stop at slightly different iterates.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import HeliParams, load_params
from ..ops import dryden, eom, terrain as terrain_ops
from ..ops.integrator import rk4, rk4_k4only
from ..ops.state import HeliState, WindState
from ..utils.constants import D2R, DT
from ..utils.math import pi_bound
from .tasks import Normalizers, Task
from .trim import TrimResult, trim


def map_tensors(fn, obj):
    """Apply `fn` to every tensor of a (nested) state dataclass."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class ResetSnapshot:
    """The episode's initial conditions, carried in EnvState so auto-reset
    needs no host sync and supports per-env initial states."""
    heli: HeliState
    wind: WindState
    dots: HeliState
    obs: torch.Tensor        # (..., 17)
    wind_ned: torch.Tensor   # (..., 3)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete per-env simulation state. The Dryden noise comes from an
    explicit `torch.Generator`, so unlike the JAX state it holds no key."""
    heli: HeliState          # helicopter dynamic state
    wind: WindState          # Dryden filter state
    dots: HeliState          # k4 state derivatives of the last step
    obs: torch.Tensor        # (..., 17) last observation
    wind_ned: torch.Tensor   # (..., 3) wind applied at the last step
    steps: torch.Tensor      # i32 step count this episode
    successed_steps: torch.Tensor  # i32 accumulated success steps
    init: ResetSnapshot      # auto-reset target
    # per-env task selector for MixedTask batches (i32, zeros by default);
    # ignored by single-task envs, kept across auto-resets
    task_id: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.task_id is None:
            object.__setattr__(self, "task_id", torch.zeros_like(self.steps))

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    failed: torch.Tensor
    successed: torch.Tensor
    time_up: torch.Tensor

    def replace(self, **kw) -> "StepOutput":
        return dataclasses.replace(self, **kw)


def _non_finite(x):
    return (x != x) | (torch.abs(x) > 1e30)


def _accum_steps_until(threshold: float, dt: float, strict: bool) -> int:
    """Smallest n such that the reference's float64 running sum of n*dt
    crosses `threshold` (strictly if `strict`): the reference accumulates
    Python-float time; the env counts integer steps and precomputes the
    crossing point exactly."""
    acc, n = 0.0, 0
    limit = int(threshold / dt) + 3
    while n <= limit:
        if (acc > threshold) if strict else (acc >= threshold):
            return n
        acc += dt
        n += 1
    return n


def _trim_cache_path(model_name, wind_params, cond) -> str:
    """The cache file of a trim: keyed by the model, the mean wind and the
    trim condition, the inputs the solve depends on."""
    blob = repr((model_name, wind_params.mean_ned,
                 sorted((k, repr(v)) for k, v in cond.items()))).encode()
    digest = hashlib.sha1(blob).hexdigest()[:16]
    root = os.environ.get("HELIGYM_TPU_TORCH_CACHE",
                          os.path.join(os.path.expanduser("~"), ".cache",
                                       "heligym_tpu_torch"))
    return os.path.join(root, f"trim_{model_name}_{digest}.npz")


def _trim_cache_load(model_name, wind_params, cond) -> Optional[TrimResult]:
    """The cached trim on the CPU, or None: a missing or unreadable file is
    a miss."""
    path = _trim_cache_path(model_name, wind_params, cond)
    try:
        with np.load(path) as z:
            return TrimResult(state=HeliState.unflatten(torch.from_numpy(z["state"])),
                              action=torch.from_numpy(z["action"]),
                              obs=torch.from_numpy(z["obs"]),
                              dots=HeliState.unflatten(torch.from_numpy(z["dots"])))
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _trim_cache_store(model_name, wind_params, cond, tr: TrimResult) -> None:
    """Write the trim through a temporary file and an atomic rename, so that
    processes storing the same key at once never leave a torn file. A cache
    that cannot be written is skipped."""
    path = _trim_cache_path(model_name, wind_params, cond)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, state=tr.state.flatten().cpu().numpy(),
                         action=tr.action.cpu().numpy(), obs=tr.obs.cpu().numpy(),
                         dots=tr.dots.flatten().cpu().numpy())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:
        pass


def resolve_device(device=None) -> torch.device:
    """The env's device: CUDA unless the caller names another. Never falls
    back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "heligym_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class HeliEnv:
    """Static env definition: parameters, task, terrain (on `device`)."""
    params: HeliParams
    task: Task
    terrain: terrain_ops.Terrain
    wind_params: dryden.WindParams
    device: torch.device
    max_time: float = 40.0           # [s] episode wall
    dt: float = DT
    trim_cond: Tuple[Tuple[str, object], ...] = ()

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, heli_name: str = "aw109", task: Optional[Task] = None,
              max_time: float = 40.0, flat_ground: bool = False,
              trim_cond: Optional[dict] = None, device=None) -> "HeliEnv":
        dev = resolve_device(device)
        params = load_params(heli_name)
        terr = (terrain_ops.flat_terrain(params.ENV, device=dev) if flat_ground
                else terrain_ops.load_terrain(params.ENV, device=dev))
        return cls(params=params, task=task or Task(), terrain=terr,
                   wind_params=dryden.WindParams.from_env(params.ENV),
                   device=dev, max_time=max_time,
                   trim_cond=tuple(sorted((trim_cond or {}).items(),
                                          key=lambda kv: kv[0])))

    def replace(self, **kw) -> "HeliEnv":
        return dataclasses.replace(self, **kw)

    # -- derived static quantities ---------------------------------------
    @property
    def normalizers(self) -> Normalizers:
        return Normalizers.from_params(self.params)

    @property
    def success_duration(self) -> float:
        return self.max_time / 4.0

    @property
    def time_up_steps(self) -> int:
        return _accum_steps_until(self.max_time, self.dt, strict=True)

    @property
    def success_steps_required(self) -> int:
        return _accum_steps_until(self.success_duration, self.dt, strict=False)

    def default_trim_cond(self) -> dict:
        cond = {"yaw": 0.0, "yaw_rate": 0.0, "ned_vel": [0.0, 0.0, 0.0],
                "gr_alt": 100.0, "xy": [0.0, 0.0], "psi_mr": 0.0, "psi_tr": 0.0}
        cond.update(dict(self.trim_cond))
        return cond

    # -- physics sub-steps -------------------------------------------------
    def heli_step_with_h(self, heli: HeliState, action4, wind_ned3, h_ground):
        """One helicopter RK4 step + post-step angle wrap, with the terrain
        height at the committed position given. `action4`/`wind_ned3` are
        tuples of (batched) scalars."""
        def f(s):
            dots, obs, _ = eom.heli_dynamics(self.params, s, action4, wind_ned3,
                                             h_ground)
            return dots, obs

        new, k4, obs = rk4(f, heli, self.dt)
        new = new.replace(psi_mr=pi_bound(new.psi_mr), psi_tr=pi_bound(new.psi_tr),
                          b0=pi_bound(new.b0), b1=pi_bound(new.b1),
                          phi=pi_bound(new.phi), theta=pi_bound(new.theta),
                          psi=pi_bound(new.psi))
        return new, k4, obs

    def wind_step(self, wind: WindState, wind_action4, eta3):
        """One Dryden step with the reference's aliased-k4 integrator."""
        def f(s):
            return dryden.wind_dynamics(self.wind_params, s, wind_action4, eta3)

        new, _, wind_ned = rk4_k4only(f, wind, self.dt)
        return new, wind_ned

    def step_physics(self, heli: HeliState, wind: WindState, wind_action4,
                     eta3, action4, h_ground, task_id=None):
        """Wind + helicopter + reward, no noise/terrain/termination: the code
        the fused step's plain version runs on row views."""
        wind_new, wind_ned = self.wind_step(wind, wind_action4, eta3)
        heli_new, dots, obs = self.heli_step_with_h(heli, action4, wind_ned,
                                                    h_ground)
        reward, success_step = self.task.reward(self.normalizers, heli_new,
                                                dots, task_id=task_id)
        return wind_new, wind_ned, heli_new, dots, obs, reward, success_step

    def _is_failed(self, heli: HeliState, dots: HeliState, h_ground):
        """Crash / out-of-bounds detection at the post-step position, whose
        terrain height is `h_ground`. The roll and pitch comparisons are
        signed, as in the reference."""
        p = self.params
        touch_alt = h_ground + p.HELI.WL_CG / 12.0
        cond1 = (-heli.z) - touch_alt < 0.0
        cond2 = dots.z > p.MR.V_TIP * 0.05
        cond3 = heli.phi > 60.0 * D2R
        cond4 = heli.theta > 60.0 * D2R
        cond5 = ((torch.abs(heli.x) > p.ENV.NS_MAX / 2.0)
                 | (torch.abs(heli.y) > p.ENV.EW_MAX / 2.0)
                 | ((-heli.z) > touch_alt + 10000.0))
        return (cond1 & (cond2 | cond3 | cond4)) | cond5

    # -- the env step ------------------------------------------------------
    def step(self, es: EnvState, action,
             generator: Optional[torch.Generator] = None) -> Tuple[EnvState, StepOutput]:
        """Env transition with Dryden noise drawn from `generator` on the
        state's device."""
        eta = torch.randn(es.obs.shape[:-1] + (3,), generator=generator,
                          device=es.obs.device) * (1.0 / self.dt) ** 0.5
        return self.step_with_eta(es, action, eta)

    def step_with_eta(self, es: EnvState, action, eta) -> Tuple[EnvState, StepOutput]:
        """Env transition with the Dryden white noise injected explicitly —
        the seam that lets parity tests replay recorded noise. `eta` (..., 3)
        must already be scaled by 1/sqrt(dt)."""
        wind_action = (es.obs[..., 4], es.obs[..., 5], es.obs[..., 6],
                       es.obs[..., 16])
        action4 = tuple(action[..., i] for i in range(4))
        eta3 = tuple(eta[..., i] for i in range(3))
        h_ground = terrain_ops.ground_height(self.terrain, es.heli.x, es.heli.y)
        wind_new, wind_ned, heli_new, dots, obs_t, reward, success_step = (
            self.step_physics(es.heli, es.wind, wind_action, eta3, action4,
                              h_ground, task_id=es.task_id))
        obs = torch.stack(obs_t, dim=-1)
        steps = es.steps + 1

        failed = self._is_failed(heli_new, dots, terrain_ops.ground_height(
            self.terrain, heli_new.x, heli_new.y))
        successed = es.successed_steps >= self.success_steps_required
        time_up = steps >= self.time_up_steps
        # The reference's NaN guard never fires; here it does, plus a
        # non-finite state failsafe: tumbling through gimbal lock produces
        # inf Euler rates without tripping the signed crash tests.
        bad = _non_finite(reward) | _non_finite(heli_new.z) | _non_finite(heli_new.u)
        done = failed | successed | bad
        failed = failed | bad
        successed_steps = es.successed_steps + success_step.to(torch.int32)

        new_es = EnvState(heli=heli_new, wind=wind_new, dots=dots, obs=obs,
                          wind_ned=torch.stack(wind_ned, dim=-1), steps=steps,
                          successed_steps=successed_steps, init=es.init,
                          task_id=es.task_id)
        out = StepOutput(obs=obs, reward=reward, done=done, truncated=time_up,
                         failed=failed, successed=successed, time_up=time_up)
        return new_es, out

    # -- reset -------------------------------------------------------------
    def trim_result(self, trim_cond: Optional[dict] = None,
                    use_cache: bool = True) -> TrimResult:
        """Host Newton trim (on the CPU) for the given condition, through
        the disk cache unless `use_cache` is False: the trim is
        deterministic in (model, condition, mean wind), and the host solve
        costs seconds."""
        cond = self.default_trim_cond()
        cond.update(trim_cond or {})
        if use_cache:
            cached = _trim_cache_load(self.params.name, self.wind_params, cond)
            if cached is not None:
                return cached
        tr = trim(self.params, self.terrain.to("cpu"),
                  dryden.mean_wind(self.wind_params), cond)
        if use_cache:
            _trim_cache_store(self.params.name, self.wind_params, cond, tr)
        return tr

    def reset_from_trim(self, tr: TrimResult) -> Tuple[EnvState, torch.Tensor]:
        """EnvState at a solved trim point, on the env's device. Like the
        reference's first reset, the trim was computed under the mean wind;
        the Dryden filter states start at zero."""
        tr = tr.to(self.device)
        wind0 = WindState.zeros(device=self.device)
        wind_mean = dryden.mean_wind(self.wind_params, device=self.device)
        snap = ResetSnapshot(heli=tr.state, wind=wind0, dots=tr.dots,
                             obs=tr.obs, wind_ned=wind_mean)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        es = EnvState(heli=tr.state, wind=wind0, dots=tr.dots, obs=tr.obs,
                      wind_ned=wind_mean, steps=zero, successed_steps=zero,
                      init=snap)
        return es, tr.obs
