"""The port's gymnasium surfaces (heligym_tpu_torch.envs.gym_api, .gym_core)
and its renderer feed (heligym_tpu_torch.render) against the JAX package's,
on the CPU.

`HeliEnv.reset` and `heli_step` against JAX's (one step from JAX's state:
state rtol/atol 2e-4, obs rtol 1e-4 / atol 2e-3). The facades: every id's
spec, the spaces, metadata, targets, normalizers and setters beside the JAX
classes'; 30 steps of `HeliHover` from JAX's
reset state (carried over with `convert.env_state_from_numpy`) with JAX's
Dryden noise injected (reward atol 2e-5, obs rtol 1e-4 / atol 2e-3, flags
and info identical); a 4-env `HeliVectorGymEnv` dive with JAX's per-env
noise, its end step, `final_obs`, `final_info` and masks beside JAX's; the
reset obs within the two host trims' difference (obs rtol 1e-4 / atol
2e-3); seeding; the action checks; a subprocess that makes, steps and
renders a port env without importing JAX. The renderers: `HeliState`'s
stacked views equal to JAX's, top-down and native frames byte-equal to the
JAX package's from the same state.

The file collects two tests, each running all of its checks before it
reports every one that failed: a file of at most two tests is handed out
after every long file of the JAX package under `--dist loadfile`."""
import os
import subprocess
import sys
import traceback

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import heligym_tpu  # noqa: F401  (registers the JAX ids)
from heligym_tpu.envs import gym_api as jgym
from heligym_tpu.render import native_api as jnative
from heligym_tpu.render.topdown import NumpyTopDownRenderer as JTopDown

import heligym_tpu_torch
from heligym_tpu_torch.convert import env_state_from_numpy
from heligym_tpu_torch.envs import TASKS, HeliEnv, HoverTask
from heligym_tpu_torch.envs import gym_api as tgym
from heligym_tpu_torch.ops.cuda import build as cuda_build
from heligym_tpu_torch.render import get_renderer
from heligym_tpu_torch.render import native_api as tnative
from heligym_tpu_torch.render.terminal_viewer import TerminalViewer
from heligym_tpu_torch.render.topdown import NumpyTopDownRenderer as TTopDown

from test_torch_tasks import jax_state_to_numpy
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.02
REWARD_ATOL = 2e-5
OBS_TOL = dict(rtol=1e-4, atol=2e-3)
STEPS = 30


def run_checks(checks):
    """Run every check, then fail with each one that failed."""
    failed = []
    for name, check in checks:
        try:
            check()
        except Exception:   # noqa: BLE001 - reported below, with its traceback
            failed.append(f"{name}:\n{traceback.format_exc()}")
    assert not failed, f"{len(failed)} of {len(checks)} checks failed:\n" + "\n".join(failed)


def batched(jes):
    """A single-env JAX EnvState with a leading batch axis of 1."""
    return jax.tree_util.tree_map(lambda x: x[None], jes)


def port_state(jes):
    """The port's EnvState from a batched JAX EnvState."""
    return env_state_from_numpy(jax_state_to_numpy(jes), "cpu")


@jax.jit
@jax.vmap
def _jax_eta(key):
    return jax.random.normal(jax.random.split(key)[1], (3,), jax.numpy.float32)


def jax_eta(keys):
    """The Dryden noise JAX's env step draws from each env's key (B, 2),
    scaled as the step scales it: (3, B)."""
    return np.asarray(_jax_eta(keys)).T * (1.0 / DT) ** 0.5


def jax_single(cls, hover_trim):
    """A JAX single env of `cls` whose trim cache holds the conftest's hover trim."""
    env = cls()
    env._trim_cache[tuple(sorted((k, str(v)) for k, v in env.trim_cond.items()))] = hover_trim
    return env


def inject(core, eta):
    """Make `core`'s next step draw `eta` (3, B)."""
    core._draw_eta = lambda: torch.from_numpy(np.ascontiguousarray(eta, np.float32))


# -- (a) the facades ------------------------------------------------------------------

def check_specs_spaces_and_metadata():
    assert set(heligym_tpu_torch.ENV_IDS) == set(TASKS)
    for name in heligym_tpu_torch.ENV_IDS:
        js, ts = gym.spec(f"{name}-v0"), gym.spec(f"heligym_tpu_torch/{name}-v0")
        assert ts.entry_point == f"heligym_tpu_torch.envs.gym_api:{name}", ts
        assert js.entry_point.split(":")[1] == name, js
        for field in ("max_episode_steps", "reward_threshold", "nondeterministic",
                      "order_enforce", "kwargs"):
            assert getattr(ts, field) == getattr(js, field), (name, field)
        env = gym.make(f"heligym_tpu_torch/{name}-v0", device="cpu")
        assert type(env.unwrapped) is getattr(tgym, name)
        assert env.unwrapped._core.env.device.type == "cpu"
        env.close()
    # the JAX ids still make the JAX classes in this process
    assert type(gym.make("HeliHover-v0").unwrapped) is jgym.HeliHover
    assert tgym.Heli.metadata == jgym.Heli.metadata
    assert tgym.HeliVectorGymEnv.metadata == jgym.HeliVectorGymEnv.metadata
    assert tgym.Heli.default_trim_cond == jgym.Heli.default_trim_cond
    assert tgym.Heli.default_max_time == jgym.Heli.default_max_time
    t, j = tgym.HeliHover(device="cpu"), jgym.HeliHover()
    assert t.observation_space == j.observation_space
    assert t.action_space == j.action_space
    tv, jv = tgym.HeliVectorGymEnv(3, device="cpu"), jgym.HeliVectorGymEnv(3)
    for attr in ("single_observation_space", "single_action_space",
                 "observation_space", "action_space", "num_envs"):
        assert getattr(tv, attr) == getattr(jv, attr), attr


def check_targets_normalizers_and_setters():
    for name in heligym_tpu_torch.ENV_IDS:
        t, j = getattr(tgym, name)(device="cpu"), getattr(jgym, name)()
        assert t.get_target() == j.get_target(), name
        assert t.normalizers == j.normalizers, name
        assert t.get_trim_cond() == j.get_trim_cond(), name
        assert (t.max_time, t.success_duration, t.task_duration) == \
            (j.max_time, j.success_duration, j.task_duration), name
    t, j = tgym.HeliHover(device="cpu"), jgym.HeliHover()
    for env in (t, j):
        env.set_max_time(10.0)
        env.set_target({"sea_alt": 5000.0})
        env.set_trim_cond({"gr_alt": 200.0})
        env.set_reward_weights()
    assert t.success_duration == j.success_duration == 2.5
    assert t.get_target() == j.get_target() and t.get_target()["sea_alt"] == 5000.0
    assert t._core.env.task.sea_alt == 5000.0 and t._core.env.max_time == 10.0
    assert t.get_trim_cond() == j.get_trim_cond()
    assert t.base_reward_weight.shape == j.base_reward_weight.shape == (17, 17)
    assert t.time_counter == 0.0 and t.successed_time == 0.0


def check_reset_and_steps_match_jax(hover_trim):
    """Reset obs within the trims' difference; then, from JAX's state with
    JAX's noise, `set_max_time(0.1)` and a target at the start on both, and
    30 steps: truncation from the 6th step (the reference's float sum of dt
    passes 0.1 there), success from the counter before each step."""
    t, j = tgym.HeliHover(device="cpu"), jax_single(jgym.HeliHover, hover_trim)
    tobs, tinfo = t.reset(seed=3)
    jobs, jinfo = j.reset(seed=3)
    assert tobs.dtype == np.float32 and tobs.shape == (17,)
    np.testing.assert_allclose(tobs, jobs, **OBS_TOL)
    assert tinfo == jinfo
    t._core.load(port_state(batched(j._state)))
    for env in (t, j):      # success counts from the trim's altitude on
        env.set_max_time(0.1)
        env.set_target({"sea_alt": -float(hover_trim.state.z)})
    # JAX's facade steps its own step function op by op: 30 steps take
    # seconds, against ~17 s to compile it (the vector dive compiles its)
    j._step_jit = j._step_jit.__wrapped__
    assert t.success_duration == j.success_duration == 0.025
    rng = np.random.default_rng(0)
    base = np.asarray(hover_trim.action, np.float32)
    flags = []
    for step in range(STEPS):
        a = np.clip(base + 0.05 * rng.standard_normal(4), -1, 1).astype(np.float32)
        inject(t._core, jax_eta(j._state.key[None]))
        tout, jout = t.step(a), j.step(a)
        np.testing.assert_allclose(tout[0], jout[0], **OBS_TOL, err_msg=f"step {step}")
        assert abs(tout[1] - jout[1]) <= REWARD_ATOL, (step, tout[1], jout[1])
        assert tout[2:] == jout[2:], (step, tout[2:], jout[2:])
        assert type(tout[1]) is float and type(tout[2]) is bool
        flags.append(tout[2:4])
    assert [f[1] for f in flags].index(True) == j._core.time_up_steps - 1 == 5
    assert any(f[0] for f in flags)          # the success criterion fired
    assert t.time_counter == j.time_counter == STEPS * DT
    assert t.successed_time == j.successed_time


def check_env_reset_and_heli_step(hover_env, hover_trim):
    """`HeliEnv.reset` against JAX's reset obs within the trims'
    difference; `heli_step` from JAX's reset state against JAX's (run op by
    op) at the state tolerance (rtol/atol 2e-4) and the obs tolerance."""
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
    es, obs = env.reset()
    jes, jobs = hover_env.reset_from_trim(hover_trim, jax.random.PRNGKey(0))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **OBS_TOL)
    tes = port_state(batched(jes))
    a = np.array(hover_trim.action, np.float32)
    jnew, jk4, jobs1 = hover_env.heli_step(jes.heli, tuple(a), tuple(jes.wind_ned))
    new, k4, obs1 = env.heli_step(tes.heli, tuple(torch.from_numpy(a)[:, None]),
                                  tuple(tes.wind_ned.T))
    for got, want in ((new, jnew), (k4, jk4)):
        np.testing.assert_allclose(got.flatten().numpy()[0], np.asarray(want.flatten()),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(torch.stack(obs1, -1).numpy()[0], np.stack(jobs1, -1),
                               **OBS_TOL)


def drift(ours, ref):
    """The largest difference over each component's largest magnitude (at
    least 1): `tests/test_rollouts.py::_compare_traj`'s measure."""
    scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
    return float((np.abs(ours - ref) / scale).max())


def check_vector_dive_matches_jax(hover_trim):
    """Two envs dive from 50 ft below the trim, two hold it, from JAX's
    reset state with JAX's per-env noise, until the divers end and 3 steps past. The first 30
    steps at the 30-step tolerances; the whole dive at the long-horizon
    contract (`ROADMAP.md`): identical discrete streams and end step, the
    pre-reset obs and the rewards within a drift of 2e-3."""
    n = 4
    t, j = tgym.HeliVectorGymEnv(n, device="cpu"), jgym.HeliVectorGymEnv(n)
    j._trim = hover_trim
    j.reset(seed=0)
    # the divers start 50 ft lower (their snapshots stay at the trim)
    j._state = j._state.replace(heli=j._state.heli.replace(
        z=j._state.heli.z.at[:2].add(50.0)))
    t.reset(seed=0)
    t._core.load(port_state(j._state))
    act = np.tile(np.asarray(hover_trim.action, np.float32), (n, 1))
    act[:2, 0] = -1.0
    init_obs = np.asarray(j._state.init.obs)
    ended_at, after = None, 0
    traj = {"t": [], "j": []}
    for step in range(400):
        inject(t._core, jax_eta(j._state.key))
        (to, tr, td, tt, ti), (jo, jr, jd, jt, ji) = t.step(act), j.step(act)
        assert tr.dtype == np.float32 and to.dtype == np.float32
        if step < STEPS:
            np.testing.assert_allclose(to, jo, **OBS_TOL, err_msg=f"step {step}")
            np.testing.assert_allclose(tr, jr, rtol=0, atol=REWARD_ATOL,
                                       err_msg=f"step {step}")
        for k in ("failed", "successed"):
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(td, jd, err_msg=f"done step {step}")
        np.testing.assert_array_equal(tt, jt, err_msg=f"truncated step {step}")
        assert set(ti) == set(ji), (step, set(ti), set(ji))
        pre = {"t": to.copy(), "j": jo.copy()}
        if "final_obs" in ji:
            ended_at = step if ended_at is None else ended_at
            for k in ("_final_obs", "_final_observation", "_final_info"):
                np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
            for i in range(n):
                if ji["_final_obs"][i]:
                    pre["t"][i], pre["j"][i] = ti["final_obs"][i], ji["final_obs"][i]
                    assert ti["final_observation"][i] is ti["final_obs"][i]
                    assert ti["final_info"][i] == ji["final_info"][i], i
                    # the returned obs is the fresh episode's first
                    np.testing.assert_array_equal(to[i], init_obs[i])
                    np.testing.assert_array_equal(jo[i], init_obs[i])
                else:
                    assert ti["final_obs"][i] is None and ti["final_info"][i] is None
        for k, o, r in (("t", pre["t"], tr), ("j", pre["j"], jr)):
            traj[k].append(np.concatenate([o, r[:, None]], axis=1))
        if ended_at is not None:
            after += 1
            if after > 3:
                break
    assert ended_at is not None and 30 < ended_at < 400, ended_at
    err = drift(np.stack(traj["t"]), np.stack(traj["j"]))
    assert err < 2e-3, f"drift {err:.2e} over {len(traj['t'])} steps"


def check_seeding():
    t = tgym.HeliHover(device="cpu")
    a = np.asarray([0.1, -0.1, 0.05, 0.0], np.float32)
    runs = []
    for _ in range(2):
        obs, _ = t.reset(seed=42)
        runs.append([obs] + [t.step(a)[0] for _ in range(5)])
    for x, y in zip(*runs):
        np.testing.assert_array_equal(x, y)
    assert t._core.generator.initial_seed() == 42
    t.reset()                       # a seed increments per reset
    assert t._core.generator.initial_seed() == 43
    v = tgym.HeliVectorGymEnv(2, device="cpu")
    state = lambda: v._core.generator.get_state().clone()
    v.reset(seed=0)
    s0 = state()
    v.reset()
    ua = state()
    v.reset()
    ub = state()
    v.reset(seed=0)
    assert torch.equal(s0, state())           # seeded: reproducible
    assert not torch.equal(ua, ub)            # unseeded: fresh
    assert not torch.equal(s0, ua)            # seed=0 is not unseeded
    act = np.zeros((2, 4), np.float32)
    trajectories = []
    for seed in (0, None):
        v.reset(seed=seed)
        for _ in range(20):
            obs, *_ = v.step(act)
        trajectories.append(obs)
    assert not np.allclose(*trajectories)


def check_action_guards():
    t = tgym.HeliHover(device="cpu")
    t.reset(seed=0)
    with pytest.raises(ValueError, match="shape"):
        t.step(np.zeros(3, np.float32))
    _, _, done, _, info = t.step(np.full(4, np.nan, np.float32))
    assert done and info["failed"]
    v = tgym.HeliVectorGymEnv(2, device="cpu")
    v.reset(seed=0)
    with pytest.raises(ValueError, match="shape"):
        v.step(np.zeros((3, 4), np.float32))


_NO_JAX = r"""
import sys
import gymnasium as gym
import numpy as np
import torch
import heligym_tpu_torch
env = gym.make("heligym_tpu_torch/HeliHover-v0", device="cpu", render_mode="rgb_array")
obs, info = env.reset(seed=0)
obs, r, done, trunc, info = env.step(np.zeros(4, np.float32))
frame = env.render()
assert frame.shape == (768, 1024, 3) and frame.dtype == np.uint8, frame.shape
env.close()
assert not torch.cuda.is_available()
try:
    gym.make("heligym_tpu_torch/HeliHover-v0")
    print("NO CARD, NO ERROR")
except RuntimeError as e:
    assert "CUDA" in str(e), e
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
       or m == "heligym_tpu" or m.startswith("heligym_tpu.")]
print("FORBIDDEN", bad)
"""


def check_gym_make_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout


def test_gym_surfaces_match_jax(hover_env, hover_trim):
    """Every check of the facades, each with its own tolerance (see the
    module docstring)."""
    run_checks([
        ("specs_spaces_metadata", check_specs_spaces_and_metadata),
        ("targets_normalizers_setters", check_targets_normalizers_and_setters),
        ("env_reset_heli_step", lambda: check_env_reset_and_heli_step(hover_env, hover_trim)),
        ("reset_and_steps", lambda: check_reset_and_steps_match_jax(hover_trim)),
        ("vector_dive", lambda: check_vector_dive_matches_jax(hover_trim)),
        ("seeding", check_seeding),
        ("action_guards", check_action_guards),
        ("gym_make_imports_no_jax", check_gym_make_imports_no_jax),
    ])


# -- (b) the renderer feed ---------------------------------------------------------------

def render_states(hover_env, hover_trim):
    """(JAX state, port state) pairs: the reset state of 1 env, the same
    moved, and 3 envs spread over the map."""
    jes, _ = hover_env.reset_from_trim(hover_trim, jax.random.PRNGKey(0))
    moved = jes.replace(heli=jes.heli.replace(x=jes.heli.x + 500.0, z=jes.heli.z - 200.0,
                                              psi=jes.heli.psi + 0.7))
    spread = jax.tree_util.tree_map(lambda x: jax.numpy.stack([x, x, x]), jes)
    spread = spread.replace(heli=spread.heli.replace(
        x=spread.heli.x + jax.numpy.asarray([-3000.0, 0.0, 4000.0]),
        y=spread.heli.y + jax.numpy.asarray([2000.0, -1500.0, 0.0]),
        psi=spread.heli.psi + jax.numpy.asarray([0.0, 1.5, -2.5])))
    return [(s, port_state(b)) for s, b in
            ((jes, batched(jes)), (moved, batched(moved)), (spread, spread))]


def check_stacked_views_equal(states):
    for js, ts in states:
        for view in ("betas", "uvw", "pqr", "euler", "xyz"):
            np.testing.assert_array_equal(getattr(ts.heli, view).numpy().reshape(-1),
                                          np.asarray(getattr(js.heli, view)).reshape(-1),
                                          err_msg=view)


def check_topdown_frames_equal(hover_env, env, states):
    jr, tr = JTopDown(hover_env), TTopDown(env)
    for k, (js, ts) in enumerate(states):
        jf, tf = jr.render(js), tr.render(ts)
        assert tf.dtype == np.uint8 and tf.shape == jf.shape == (1024, 1024, 3)
        np.testing.assert_array_equal(tf, jf, err_msg=f"state {k}")


def check_native_frames_equal(hover_env, env, states):
    assert jnative.native_available() and tnative.native_available()
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "heligym_tpu_torch")
    assert os.path.basename(path).startswith("render_") and os.path.exists(path)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    for k, (js, ts) in enumerate(states[:2]):
        # a fresh renderer per frame: the HUD's FPS reads 0 in the first frame
        jr = jnative.NativeRenderer(hover_env, 320, 240)
        tr = tnative.NativeRenderer(env, 320, 240)
        jf, tf = jr.render(js), tr.render(ts)
        jr.close(), tr.close()
        assert tf.shape == (240, 320, 3) and tf.dtype == np.uint8
        assert len(np.unique(tf.reshape(-1, 3), axis=0)) > 50     # not blank
        np.testing.assert_array_equal(tf, jf, err_msg=f"state {k}")
    r = get_renderer(env)
    assert isinstance(r, tnative.NativeRenderer)
    r.close()
    assert isinstance(get_renderer(env, prefer_native=False), TTopDown)


def _drain(fd) -> bytes:
    import select
    out = b""
    while select.select([fd], [], [], 0.2)[0]:
        out += os.read(fd, 1 << 16)
    return out


def check_terminal_viewer(monkeypatch):
    """As the JAX package's test_render.py: the blit, the keys, the headless
    error."""
    import pty
    monkeypatch.setenv("COLUMNS", "40")
    monkeypatch.setenv("LINES", "12")
    master, slave = pty.openpty()
    v = TerminalViewer(out_fd=slave, in_fd=slave, fps=0.0)
    frame = np.zeros((64, 96, 3), np.uint8)
    frame[:32] = (40, 80, 200)
    frame[32:] = (90, 140, 60)
    v.show(frame)
    out = _drain(master)
    assert b"\x1b[38;2;40;80;200" in out
    assert "▀".encode() in out
    os.write(master, b"w\x1b[Aq")
    assert v.poll_keys() == ["w", "up", "q"]
    v.close()
    assert b"\x1b[?1049l" in _drain(master)
    os.close(master), os.close(slave)
    r, w = os.pipe()
    with pytest.raises(RuntimeError, match="TTY"):
        TerminalViewer(out_fd=w, in_fd=r)
    os.close(r), os.close(w)


def test_render_feed_matches_jax(hover_env, hover_trim, monkeypatch):
    """The port's renderers against the JAX package's on the same states:
    byte-equal frames."""
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
    states = render_states(hover_env, hover_trim)
    run_checks([
        ("stacked_views", lambda: check_stacked_views_equal(states)),
        ("topdown_frames", lambda: check_topdown_frames_equal(hover_env, env, states)),
        ("native_frames", lambda: check_native_frames_equal(hover_env, env, states)),
        ("terminal_viewer", lambda: check_terminal_viewer(monkeypatch)),
    ])
