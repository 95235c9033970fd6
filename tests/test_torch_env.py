"""Parity of the PyTorch port's env layer (trim, HeliEnv, VectorHeliEnv)
with the golden fixtures and the JAX package, on the CPU; and the guards
that keep the port free of JAX and on the card by default."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_rollouts import _compare_traj

from heligym_tpu_torch.envs import (EnvState, ForwardFlightTask, HeliEnv, HoverTask,
                                    ResetSnapshot, VectorHeliEnv)
from heligym_tpu_torch.envs.trim import trim
from heligym_tpu_torch.ops import dryden
from heligym_tpu_torch.ops import terrain as terrain_ops
from heligym_tpu_torch.ops.state import HeliState, WindState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env():
    return HeliEnv.build("aw109", task=HoverTask(), device="cpu")


def _default_cond(over=None):
    cond = {"yaw": 0.0, "yaw_rate": 0.0, "ned_vel": [0.0, 0.0, 0.0],
            "gr_alt": 100.0, "xy": [0.0, 0.0], "psi_mr": 0.0, "psi_tr": 0.0}
    cond.update(over or {})
    return cond


# -- trim --------------------------------------------------------------------

def test_trim_matches_fixture(fixtures, env):
    f = fixtures("trim")
    for i in range(int(f["n"])):
        cond = _default_cond(ast.literal_eval(str(f[f"cond{i}_json"])))
        tr = env.trim_result(cond)
        ours = tr.state.flatten().numpy()
        ref = f[f"cond{i}_state"]
        scale = np.maximum(np.abs(ref), 1.0)
        np.testing.assert_allclose(ours / scale, ref / scale, atol=2e-3,
                                   err_msg=f"trim cond {i}: {cond}")
        np.testing.assert_allclose(tr.action.numpy(), f[f"cond{i}_action"],
                                   atol=2e-3)


def test_trim_matches_jax_hover_trim(env, hover_trim):
    tr = env.trim_result()
    for ours, ref in ((tr.state.flatten(), hover_trim.state.flatten()),
                      (tr.dots.flatten(), hover_trim.dots.flatten()),
                      (tr.obs, hover_trim.obs)):
        ref = np.asarray(ref)
        scale = np.maximum(np.abs(ref), 1.0)
        np.testing.assert_allclose(ours.numpy() / scale, ref / scale, atol=2e-3)
    np.testing.assert_allclose(tr.action.numpy(), np.asarray(hover_trim.action),
                               atol=2e-3)


# -- the eager env against the reference rollouts ----------------------------

def replay(env, st0, obs0, etas, actions):
    heli0 = HeliState.unflatten(torch.tensor(st0, dtype=torch.float32))
    snap = ResetSnapshot(heli=heli0, wind=WindState.zeros(),
                         dots=heli0.map(torch.zeros_like),
                         obs=torch.tensor(obs0, dtype=torch.float32),
                         wind_ned=dryden.mean_wind(env.wind_params))
    zero = torch.zeros((), dtype=torch.int32)
    es = EnvState(heli=heli0, wind=snap.wind, dots=snap.dots, obs=snap.obs,
                  wind_ned=snap.wind_ned, steps=zero, successed_steps=zero,
                  init=snap)
    obs_t, rew_t, done_t, trunc_t, flags, states = [], [], [], [], [], []
    for eta, act in zip(etas, actions):
        es, out = env.step_with_eta(es, torch.tensor(act, dtype=torch.float32),
                                    torch.tensor(eta, dtype=torch.float32))
        obs_t.append(out.obs.numpy().astype(np.float64))
        rew_t.append(float(out.reward))
        done_t.append(bool(out.done))
        trunc_t.append(bool(out.truncated))
        flags.append([bool(out.failed), bool(out.successed), bool(out.time_up)])
        states.append(es.heli.flatten().numpy())
        if done_t[-1] or trunc_t[-1]:
            break
    return (np.stack(obs_t), np.asarray(rew_t), np.asarray(done_t),
            np.asarray(trunc_t), np.asarray(flags), np.stack(states))


@torch.no_grad()
def test_hover_quiet_trajectory(fixtures, env):
    f = fixtures("rollouts")
    obs, rew, done, trunc, flags, states = replay(
        env, f["hoverA_st0"], f["hoverA_obs0"], f["hoverA_etas"],
        f["hoverA_actions"])
    assert len(obs) == len(f["hoverA_obs"])
    assert not done.any() and not trunc.any()
    _compare_traj(states, f["hoverA_states"])
    _compare_traj(obs, f["hoverA_obs"])
    np.testing.assert_allclose(rew[:200], f["hoverA_rew"][:200], atol=1e-4)


@torch.no_grad()
def test_hover_turbulent_perturbed(fixtures, env):
    f = fixtures("rollouts")
    obs, rew, done, trunc, flags, states = replay(
        env, f["hoverB_st0"], f["hoverB_obs0"], f["hoverB_etas"],
        f["hoverB_actions"])
    assert len(obs) == len(f["hoverB_obs"])
    _compare_traj(states, f["hoverB_states"], horizon_tight=200,
                  tol_tight=5e-3, tol_full=1e-1)
    np.testing.assert_allclose(rew[:100], f["hoverB_rew"][:100], atol=1e-3)


@torch.no_grad()
def test_crash_detection(fixtures, env):
    f = fixtures("rollouts")
    obs, rew, done, trunc, flags, states = replay(
        env, f["crash_st0"], f["crash_obs0"], f["crash_etas"],
        f["crash_actions"])
    ref_len = len(f["crash_obs"])
    assert done[-1]
    assert flags[-1][0]          # failed=True
    assert abs(len(obs) - ref_len) <= 2
    _compare_traj(states[:ref_len - 2], f["crash_states"][:ref_len - 2],
                  horizon_tight=100, tol_tight=2e-3, tol_full=5e-2)


@torch.no_grad()
def test_forward_flight_rewards(fixtures):
    """The `fwd` case of the reference rollouts (ForwardFlightTask): rewards
    within 2e-3 over 150 steps and the same done stream, as the JAX
    package's test_rollouts.py holds its own env."""
    f = fixtures("rollouts")
    env = HeliEnv.build("aw109", task=ForwardFlightTask(), device="cpu")
    obs, rew, done, trunc, flags, states = replay(
        env, f["fwd_st0"], f["fwd_obs0"], f["fwd_etas"], f["fwd_actions"])
    n = min(len(rew), len(f["fwd_rew"]))
    np.testing.assert_allclose(rew[:150], f["fwd_rew"][:150], atol=2e-3)
    assert (done[:n] == f["fwd_done"][:n]).all()


@pytest.fixture(scope="module")
def heavy_env():
    return HeliEnv.build("aw109_heavy", task=HoverTask(), device="cpu")


@pytest.mark.parametrize("case", ["ground", "cruise"])
def test_heavy_trim_matches_reference(fixtures, heavy_env, case):
    """The second airframe's trim fixed points under the fixture's constant
    wind (normalized atol 2e-3, actions atol 2e-3), as the JAX package's
    test_second_airframe.py holds its own trim."""
    f = fixtures("rollouts_heavy")
    cond = _default_cond(ast.literal_eval(str(f[f"{case}_cond"])))
    tr = trim(heavy_env.params, heavy_env.terrain,
              torch.tensor(f[f"{case}_wind"], dtype=torch.float32), cond)
    ref = f[f"{case}_state0"]
    scale = np.maximum(np.abs(ref), 1.0)
    np.testing.assert_allclose(tr.state.flatten().numpy() / scale, ref / scale,
                               atol=2e-3, err_msg=case)
    np.testing.assert_allclose(tr.action.numpy(), f[f"{case}_action"], atol=2e-3)


@torch.no_grad()
@pytest.mark.parametrize("case", ["ground", "cruise"])
def test_heavy_rollout_matches_reference(fixtures, heavy_env, case):
    """Held-action RK4 trajectories of the second airframe from the
    reference's trim state with its frozen wind (the helicopter step alone,
    terrain height from the committed state): normalized drift below 2e-3
    over 100 steps and 5e-2 over the 250, as test_second_airframe.py."""
    f = fixtures("rollouts_heavy")
    heli = HeliState.unflatten(torch.tensor(f[f"{case}_state0"], dtype=torch.float32))
    act = tuple(torch.tensor(a, dtype=torch.float32) for a in f[f"{case}_action"])
    wind = tuple(torch.tensor(w, dtype=torch.float32) for w in f[f"{case}_wind"])
    states, obs = [], []
    for _ in range(f[f"{case}_states"].shape[0]):
        h = terrain_ops.ground_height(heavy_env.terrain, heli.x, heli.y)
        heli, _, o = heavy_env.heli_step_with_h(heli, act, wind, h)
        states.append(heli.flatten().numpy())
        obs.append(torch.stack(o, dim=-1).numpy().astype(np.float64))
    for ours, ref in ((np.stack(states), f[f"{case}_states"]),
                      (np.stack(obs), f[f"{case}_obs"])):
        scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
        err = np.abs(ours - ref) / scale
        assert err[:100].max() < 2e-3, f"{case}: drift {err[:100].max():.2e} in 100 steps"
        assert err.max() < 5e-2, f"{case}: drift {err.max():.2e} over {len(ref)} steps"


@torch.no_grad()
def test_vector_step_resets_and_draws_noise(env):
    """Batched eager step: generator-driven noise is reproducible, and a
    diving batch ends its episodes and restarts from the snapshot."""
    venv = VectorHeliEnv(env, 8)
    tr = env.trim_result()
    es, obs0 = venv.reset_from_trim(tr)
    dive = tr.action.clone()
    dive[0] = -1.0
    acts = dive.expand(8, 4)
    runs = []
    for _ in range(2):
        e, g, ended = es, torch.Generator().manual_seed(5), torch.zeros(8, dtype=torch.bool)
        for _t in range(160):
            e, out = venv.step(e, acts, generator=g)
            ended |= out.done
        runs.append((e, ended))
    assert torch.equal(runs[0][0].heli.flatten(), runs[1][0].heli.flatten())
    assert runs[0][1].all()
    assert (runs[0][0].steps < 160).all()


# -- guards ------------------------------------------------------------------

def test_build_without_device_needs_a_card():
    if torch.cuda.is_available():
        assert HeliEnv.build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HeliEnv.build()


_GUARD = r"""
import sys, torch
from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv
from heligym_tpu_torch.ops.cuda.fused_step import build_fused_rollout
env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
tr = env.trim_result()
es, _ = VectorHeliEnv(env, 4).reset_from_trim(tr)
roll = build_fused_rollout(env, 4, 2)
es, outs = roll(es, tr.action.expand(4, 4).contiguous(),
                generator=torch.Generator().manual_seed(0))
assert outs["reward"].shape == (2, 4) and torch.isfinite(outs["reward"]).all()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
       or m == "heligym_tpu" or m.startswith("heligym_tpu.")]
print("FORBIDDEN", bad)
"""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "heligym_tpu")


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout
    # chip_smoke.py, the port's tools and every module of the port name no
    # such import
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", n) for n in sorted(os.listdir(os.path.join(REPO, "tools")))
        if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "heligym_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            assert not any(_forbidden(m) for m in mods), (path, mods)
