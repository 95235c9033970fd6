"""The port's tasks (heligym_tpu_torch.envs.tasks) and its fused step's plain
version on every task, against the JAX package, on the CPU.

The same seeded numpy states, actions and noise go through both. Rewards on
random states: rtol 1e-6 / atol 2e-6 (XLA on the CPU contracts multiply-adds
into FMAs, the port rounds each op), success flags identical. Rollouts: the
tolerances of the JAX package's test_fused.py (reward atol 2e-5, state
rtol/atol 2e-4, obs rtol 1e-4 / atol 2e-3, discrete streams identical)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heligym_tpu.envs import VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.envs.vector import auto_reset as jauto_reset
from heligym_tpu.models import load_params as jload_params
from heligym_tpu.ops.pallas import build_fused_rollout as jbuild_fused_rollout
from heligym_tpu.ops.state import WIND_STATE_FIELDS
from heligym_tpu.ops.state import HeliState as JHeliState

from heligym_tpu_torch.convert import env_state_from_numpy
from heligym_tpu_torch.envs import HeliEnv, tasks
from heligym_tpu_torch.envs.env import map_tensors
from heligym_tpu_torch.models import load_params
from heligym_tpu_torch.ops.cuda import fused_step as fs
from heligym_tpu_torch.ops.state import HeliState
from torch_trim_cache import fresh_trim_cache  # noqa: F401

SINGLE = ("hover", "forward", "turning", "slalom", "landing", "landing_touch",
          "oblique")

def compiled(fn, *args):
    """`fn` jitted and compiled once for `args`' shapes, ahead of its first
    call, with XLA's default options. (A plain `jax.jit` compiles again
    when its later calls take committed arrays where the first took
    uncommitted ones.)"""
    return jax.jit(fn).lower(*args).compile()


def make_tasks(mod, alt):
    """The seven single tasks of module `mod` (the JAX package's tasks or the
    port's) with altitude targets at `alt`, by name."""
    return {
        "hover": mod.HoverTask(sea_alt=alt, north_loc=5.0),
        "forward": mod.ForwardFlightTask(sea_alt=alt, vel=60.0),
        "turning": mod.TurningFlightTask(sea_alt=alt),
        "slalom": mod.SlalomTask(sea_alt=alt, vel=60.0),
        "landing": mod.LandingTask(pad_north=10.0),
        "landing_touch": mod.LandingTask(touch_alt=alt - 3.0),
        "oblique": mod.ObliqueFlightTask(sea_alt=alt, vel=60.0),
    }


def make_task(mod, name, alt):
    single = make_tasks(mod, alt)
    mixes = {"mixed2": ("forward", "oblique"),
             "mixed4": ("hover", "forward", "turning", "oblique"),
             "mixed7": SINGLE}
    if name in mixes:
        return mod.MixedTask(tasks=tuple(single[k] for k in mixes[name]))
    return single[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _random_states(rng, n, alt):
    """Flight states near the tasks' targets, so that in-tolerance flags fire
    in some lanes, with the degenerate lanes the rewards must agree on:
    zero speed, zero rates, NaN and inf."""
    st = np.zeros((n, 18), np.float32)
    st[:, 0] = rng.uniform(20, 60, n)
    st[:, 1] = rng.uniform(20, 80, n)
    st[:, 2:4] = rng.uniform(-np.pi, np.pi, (n, 2))
    st[:, 4:6] = rng.uniform(-0.1, 0.1, (n, 2))
    st[:, 6] = rng.uniform(30, 90, n)
    st[:, 7:9] = rng.uniform(-10, 10, (n, 2))
    st[:, 9:12] = rng.uniform(-0.3, 0.3, (n, 3))
    st[:, 12:14] = rng.uniform(-0.3, 0.3, (n, 2))
    st[:, 14] = rng.uniform(-np.pi, np.pi, n)
    st[:, 15] = rng.uniform(-8000, 8000, n)
    st[:, 16] = rng.uniform(-200, 200, n)
    st[:, 17] = -alt + rng.uniform(-40, 40, n)
    st[:64, 6:9] = 0.0                       # zero speed
    st[64:96, 6:9] = rng.uniform(-1, 1, (32, 3))   # settled (landing)
    st[64:96, 15:17] = rng.uniform(-20, 20, (32, 2))
    st[96:128, 9:12] = 0.0                   # sign(0) lanes
    st[128:136, 17] = np.nan
    st[136:144, 6] = np.inf
    st[144:152, 11] = np.nan
    return st


def _random_dots(rng, n):
    dt = np.zeros((n, 18), np.float32)
    dt[:, 6:9] = rng.uniform(-5, 5, (n, 3))
    dt[:, 9:12] = rng.uniform(-0.5, 0.5, (n, 3))
    dt[:, 15] = rng.uniform(30, 90, n)
    dt[:, 16] = rng.uniform(-60, 60, n)
    dt[:, 17] = rng.uniform(-8, 8, n)
    dt[152:160, 17] = np.nan
    return dt


@pytest.mark.parametrize("name", SINGLE + ("mixed2", "mixed4", "mixed7"))
def test_task_reward_equal_jax(name):
    rng = np.random.default_rng(5)
    n, alt = 1024, 3000.0
    st, dt = _random_states(rng, n, alt), _random_dots(rng, n)
    task, jtask = make_task(tasks, name, alt), make_task(jtasks, name, alt)
    assert task.target_dict() == jtask.target_dict()
    norm = tasks.Normalizers.from_params(load_params("aw109"))
    jnorm = jtasks.Normalizers.from_params(jload_params("aw109"))
    n_sub = len(getattr(task, "tasks", ())) or 1
    tid = (np.arange(n) % (n_sub + 1)).astype(np.int32)   # one id out of range
    r, s = task.reward(norm, HeliState.unflatten(_t(st)),
                       HeliState.unflatten(_t(dt)), task_id=torch.from_numpy(tid))
    jr, js = jax.jit(lambda a, b, i: jtask.reward(
        jnorm, JHeliState.unflatten(a), JHeliState.unflatten(b), task_id=i))(
            st, dt, tid)
    jr, js = np.asarray(jr), np.asarray(js)
    np.testing.assert_allclose(r.numpy(), jr, rtol=1e-6, atol=2e-6)
    np.testing.assert_array_equal(s.numpy(), js)
    assert np.isnan(jr).any() or name in ("landing", "landing_touch")
    if name not in ("oblique",):
        assert js.any(), "no lane in tolerance: the flags are not exercised"
    # a MixedTask without ids scores every lane on its first sub-task
    if n_sub > 1:
        r0, _ = task.reward(norm, HeliState.unflatten(_t(st)),
                            HeliState.unflatten(_t(dt)))
        r1, _ = task.tasks[0].reward(norm, HeliState.unflatten(_t(st)),
                                     HeliState.unflatten(_t(dt)))
        assert torch.equal(torch.nan_to_num(r0), torch.nan_to_num(r1))


def test_with_target_and_target_dict():
    t = tasks.ForwardFlightTask().with_target(vel=60.0, sea_alt=1234.0)
    assert t.target_dict() == {"sea_alt": 1234.0, "heading": 0.0, "vel": 60.0}
    m = tasks.MixedTask(tasks=(tasks.HoverTask(), t))
    assert m.target_dict() == {"task0": tasks.HoverTask().target_dict(),
                               "task1": t.target_dict()}
    with pytest.raises(ValueError):
        tasks.MixedTask().reward(None, None, None)


# -- rollouts ----------------------------------------------------------------

def jax_state_to_numpy(es):
    """A batched JAX EnvState flattened as `convert.STATE_KEYS` + task_id."""
    wind = lambda w: np.stack([np.asarray(getattr(w, f)) for f in WIND_STATE_FIELDS], -1)
    return {"heli": np.asarray(es.heli.flatten()), "wind": wind(es.wind),
            "dots": np.asarray(es.dots.flatten()), "obs": np.asarray(es.obs),
            "wind_ned": np.asarray(es.wind_ned), "steps": np.asarray(es.steps),
            "successed_steps": np.asarray(es.successed_steps),
            "init.heli": np.asarray(es.init.heli.flatten()),
            "init.wind": wind(es.init.wind),
            "init.dots": np.asarray(es.init.dots.flatten()),
            "init.obs": np.asarray(es.init.obs),
            "init.wind_ned": np.asarray(es.init.wind_ned),
            "task_id": np.asarray(es.task_id)}


def moving_state(jenv, hover_trim, n, task_ids, seed):
    """A JAX farm at the hover trim pushed to ~60 ft/s forward with a spread
    per lane (both the live state and the reset snapshot), so that the
    speed- and course-tracking rewards are finite and differ by lane."""
    venv = JVectorHeliEnv(jenv, n)
    es, _ = venv.reset_from_trim(hover_trim, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    u = jnp.asarray(60.0 + 5.0 * rng.standard_normal(n), jnp.float32)
    v = jnp.asarray(3.0 * rng.standard_normal(n), jnp.float32)
    heli = es.heli.replace(u=u, v=v)
    es = es.replace(heli=heli, init=es.init.replace(heli=heli))
    return venv.assign_tasks(es, task_ids)


def rollout_inputs(trim_action, steps, n, seed, dt):
    rng = np.random.default_rng(seed)
    act = np.tile(np.asarray(trim_action, np.float32), (steps, n, 1))
    act += (0.02 * rng.standard_normal(act.shape)).astype(np.float32)
    eta = (rng.standard_normal((steps, 3, n)) * (1.0 / dt) ** 0.5).astype(np.float32)
    return act, eta


@pytest.fixture(scope="module")
def start_alt(hover_trim):
    return float(-np.asarray(hover_trim.state.z))


@pytest.fixture(scope="module")
def jax_mixed7_run(hover_env, hover_trim, start_alt):
    """30 steps of JAX's eager batched step + auto_reset on a 7-task
    MixedTask farm (every single task in its own lanes), compiled once."""
    n, steps = 7 * 16, 30
    jenv = hover_env.replace(task=make_task(jtasks, "mixed7", start_alt))
    task_ids = np.arange(n) % 7
    es = moving_state(jenv, hover_trim, n, task_ids, seed=0)
    act, eta = rollout_inputs(hover_trim.action, steps, n, 0, jenv.dt)
    jstep = compiled(lambda es, a, e: jauto_reset(
        *jax.vmap(jenv.step_with_eta)(es, a, e.T)), es, act[0], eta[0])
    ref = {"reward": [], "done": [], "truncated": [], "failed": [], "obs": []}
    e = es
    for t in range(steps):
        e, out = jstep(e, act[t], eta[t])
        for k in ref:
            ref[k].append(np.asarray(getattr(out, k)))
    return {"es0": jax_state_to_numpy(es), "act": act, "eta": eta,
            "task_ids": task_ids, "ref": {k: np.stack(v) for k, v in ref.items()},
            "final": jax_state_to_numpy(e)}


@pytest.mark.parametrize("name", SINGLE + ("mixed4", "mixed7"))
def test_fused_every_task_30_steps(name, jax_mixed7_run, start_alt):
    """The port's fused rollout (its plain version here) with each task and
    with MixedTask, on the lanes of the JAX 7-task farm that run that task."""
    run = jax_mixed7_run
    task = make_task(tasks, name, start_alt)
    if name in SINGLE:
        members = (name,)
    else:
        members = ("hover", "forward", "turning", "oblique") if name == "mixed4" else SINGLE
    lanes = np.flatnonzero(np.isin(run["task_ids"], [SINGLE.index(m) for m in members]))
    es0 = {k: v[lanes] for k, v in run["es0"].items()}
    es0["task_id"] = np.asarray([members.index(SINGLE[i]) for i in es0["task_id"]],
                                np.int32)
    env = HeliEnv.build("aw109", task=task, device="cpu")
    es_t = env_state_from_numpy(es0, "cpu")
    roll = fs.build_fused_rollout(env, len(lanes), 30, eta_mode="inject",
                                  collect=("reward", "done", "failed", "obs"))
    with torch.no_grad():
        es_f, outs = roll(es_t, torch.from_numpy(run["act"][:, lanes]),
                          torch.from_numpy(run["eta"][:, :, lanes]))
    ref = {k: v[:, lanes] for k, v in run["ref"].items()}
    np.testing.assert_allclose(outs["reward"].numpy(), ref["reward"], atol=2e-5)
    np.testing.assert_allclose(outs["obs"].numpy(), ref["obs"], rtol=1e-4, atol=2e-3)
    for k in ("done", "truncated", "failed"):
        np.testing.assert_array_equal(outs[k].numpy(), ref[k], err_msg=k)
    final = run["final"]
    np.testing.assert_allclose(es_f.heli.flatten().numpy(), final["heli"][lanes],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(es_f.steps.numpy(), final["steps"][lanes])
    np.testing.assert_array_equal(es_f.successed_steps.numpy(),
                                  final["successed_steps"][lanes])
    np.testing.assert_array_equal(es_f.task_id.numpy(), es0["task_id"])
    if name not in ("landing", "landing_touch", "oblique"):
        assert es_f.successed_steps.numpy().any(), "in-tolerance flag never fired"


def test_fused_plain_matches_jax_fused_mixed(hover_env, hover_trim, start_alt):
    """MixedTask(Forward, Oblique) through the JAX fused rollout (the Pallas
    kernel in interpret mode, injected noise) and through the port's: the
    per-lane reward select by task id, every step's reward within 2e-5."""
    n, steps = 128, 10
    jenv = hover_env.replace(task=make_task(jtasks, "mixed2", start_alt))
    task_ids = np.arange(n) % 2
    es = moving_state(jenv, hover_trim, n, task_ids, seed=3)
    act, eta = rollout_inputs(hover_trim.action, steps, n, 3, jenv.dt)
    # unroll=1: one copy of the interpreted kernel to compile, not four
    act_j, eta_j = jnp.asarray(act), jnp.asarray(eta)
    jroll = compiled(jbuild_fused_rollout(jenv, n, steps, collect=("reward", "done"),
                                          eta_mode="inject", unroll=1),
                     es, act_j, eta_j)
    es_j, jouts = jroll(es, act_j, eta_j)

    env = HeliEnv.build("aw109", task=make_task(tasks, "mixed2", start_alt),
                        device="cpu")
    es_t = env_state_from_numpy(jax_state_to_numpy(es), "cpu")
    roll = fs.build_fused_rollout(env, n, steps, eta_mode="inject")
    with torch.no_grad():
        es_f, outs = roll(es_t, torch.from_numpy(act), torch.from_numpy(eta))
    reward = outs["reward"].numpy()
    np.testing.assert_allclose(reward, np.asarray(jouts["reward"]), atol=2e-5)
    np.testing.assert_array_equal(outs["done"].numpy(), np.asarray(jouts["done"]))
    np.testing.assert_allclose(es_f.heli.flatten().numpy(),
                               np.asarray(es_j.heli.flatten()), rtol=2e-4, atol=2e-4)
    # the two task populations genuinely get different rewards
    assert not np.allclose(reward[-1][task_ids == 0].mean(),
                           reward[-1][task_ids == 1].mean())


def test_state_task_id_defaults_and_survives_reset():
    """EnvState.task_id is zeros by default, rides in the init block, and
    auto-reset leaves it alone."""
    env = HeliEnv.build("aw109", task=make_task(tasks, "mixed2", 1600.0), device="cpu")
    from heligym_tpu_torch.envs import VectorHeliEnv
    venv = VectorHeliEnv(env, 6)
    es, _ = venv.reset()
    assert es.task_id.dtype == torch.int32 and not es.task_id.any()
    es = venv.assign_tasks(es, [0, 1, 0, 1, 0, 1])
    with pytest.raises(ValueError):
        venv.assign_tasks(es, [0, 1])
    carry, init = fs.pack(es)
    assert init.shape == (fs.IROWS, 6) and init[fs.ITID].tolist() == [0, 1, 0, 1, 0, 1]
    act = torch.full((6, 4), -1.0)           # dive into the ground
    eta = torch.zeros((3, 6))
    ended = torch.zeros(6, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(400):
            es, out = venv.step_with_eta(es, act, eta.T)
            ended |= out.done
    assert ended.all() and es.task_id.tolist() == [0, 1, 0, 1, 0, 1]
    sub = map_tensors(lambda x: x[:2], es)
    assert sub.task_id.tolist() == [0, 1]


def test_vector_reset_and_eager_rollout():
    """VectorHeliEnv.reset solves the trim itself; `rollout` steps a policy
    eagerly and stacks the outputs over time."""
    from heligym_tpu_torch.envs import VectorHeliEnv, rollout
    env = HeliEnv.build("aw109", task=tasks.HoverTask(), device="cpu")
    venv = VectorHeliEnv(env, 4)
    es, obs = venv.reset({"gr_alt": 50.0})
    # obs[16] is the CG's height above ground: gr_alt plus the gear's reach
    agl = 50.0 + env.params.HELI.WL_CG / 12.0
    assert obs.shape == (4, 17) and torch.allclose(obs[:, 16], torch.tensor(agl), atol=1e-2)
    trim_action = env.trim_result({"gr_alt": 50.0}).action
    policy = lambda scale, o: (trim_action * scale).expand(o.shape[0], 4)
    gen = lambda: torch.Generator().manual_seed(0)
    with torch.no_grad():
        es1, out = rollout(venv, es, policy, 6, policy_params=1.0, generator=gen())
        es2, out2 = rollout(venv, es, policy, 6, policy_params=1.0, generator=gen())
    assert out.reward.shape == (6, 4) and out.obs.shape == (6, 4, 17)
    assert out.done.dtype == torch.bool and not out.done.any()
    assert torch.equal(out.reward, out2.reward) and (es1.steps == 6).all()
    assert torch.equal(out.obs[-1], es1.obs)
