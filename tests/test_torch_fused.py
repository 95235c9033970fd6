"""The port's fused hover rollout (heligym_tpu_torch.ops.cuda.fused_step)
against the JAX package's eager batched step.

On the CPU the rollout runs the kernel's plain version. The reference is
JAX's vmapped `step_with_eta` + `auto_reset` from the same state and the same
injected noise (the JAX fused rollout in interpret mode costs minutes on the
CPU; JAX's own test_fused.py holds it equal to this eager path). Tolerances:
those of the JAX package's test_fused.py. The kernel itself is held against
the plain version on the card by test_torch_cuda.py and chip_smoke.py."""
import os
import re

import jax
import numpy as np
import pytest
import torch

from heligym_tpu.envs import VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.envs.vector import auto_reset as jauto_reset
from heligym_tpu.ops.state import WIND_STATE_FIELDS

from heligym_tpu_torch.convert import env_state_from_numpy
from heligym_tpu_torch.envs import HeliEnv, HoverTask, Task, VectorHeliEnv
from heligym_tpu_torch.ops.cuda import fused_step as fs

from test_torch_tasks import compiled
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 128


@pytest.fixture(scope="module")
def env():
    return HeliEnv.build("aw109", task=HoverTask(), device="cpu")


def jax_state_to_numpy(es):
    """A batched JAX EnvState flattened as `convert.STATE_KEYS`."""
    wind = lambda w: np.stack([np.asarray(getattr(w, f)) for f in WIND_STATE_FIELDS], -1)
    return {"heli": np.asarray(es.heli.flatten()), "wind": wind(es.wind),
            "dots": np.asarray(es.dots.flatten()), "obs": np.asarray(es.obs),
            "wind_ned": np.asarray(es.wind_ned), "steps": np.asarray(es.steps),
            "successed_steps": np.asarray(es.successed_steps),
            "init.heli": np.asarray(es.init.heli.flatten()),
            "init.wind": wind(es.init.wind),
            "init.dots": np.asarray(es.init.dots.flatten()),
            "init.obs": np.asarray(es.init.obs),
            "init.wind_ned": np.asarray(es.init.wind_ned)}


@pytest.fixture(scope="module")
def jstep(hover_env):
    """JAX's batched step + auto_reset, compiled once for the module at its
    first call (`test_torch_tasks.compiled`)."""
    fn = lambda es, a, e: jauto_reset(*jax.vmap(hover_env.step_with_eta)(es, a, e.T))
    cache = {}

    def step(es, a, e):
        if "step" not in cache:
            cache["step"] = compiled(fn, es, a, e)
        return cache["step"](es, a, e)
    return step


def _run_both(env, hover_env, hover_trim, jstep, steps, dive, seed):
    """The JAX eager batched step and the port's fused rollout from one JAX
    reset state, with the same numpy actions and noise."""
    es_j, _ = JVectorHeliEnv(hover_env, B).reset_from_trim(
        hover_trim, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    act = np.tile(np.asarray(hover_trim.action, np.float32), (steps, B, 1))
    act += (0.02 * rng.standard_normal(act.shape)).astype(np.float32)
    if dive:
        act[..., 0] = -1.0
    eta = (rng.standard_normal((steps, 3, B)) * (1.0 / hover_env.dt) ** 0.5
           ).astype(np.float32)

    es_t = env_state_from_numpy(jax_state_to_numpy(es_j), "cpu")
    ref = {"reward": [], "done": [], "truncated": [], "failed": [], "obs": []}
    e = es_j
    for t in range(steps):
        e, out = jstep(e, act[t], eta[t])
        for k in ref:
            ref[k].append(np.asarray(getattr(out, k)))
    ref = {k: np.stack(v) for k, v in ref.items()}

    roll = fs.build_fused_rollout(env, B, steps,
                                  collect=("reward", "done", "failed", "obs"),
                                  eta_mode="inject")
    with torch.no_grad():
        es_f, outs = roll(es_t, torch.from_numpy(act), torch.from_numpy(eta))
    return e, ref, es_f, outs


def test_fused_matches_jax_30_steps(env, hover_env, hover_trim, jstep):
    e, ref, es_f, outs = _run_both(env, hover_env, hover_trim, jstep, 30, False, 0)
    np.testing.assert_allclose(outs["reward"].numpy(), ref["reward"], atol=2e-5)
    np.testing.assert_allclose(es_f.heli.flatten().numpy(),
                               np.asarray(e.heli.flatten()), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(es_f.obs.numpy(), np.asarray(e.obs),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(outs["obs"].numpy(), ref["obs"], rtol=1e-4, atol=2e-3)
    for k in ("done", "truncated", "failed"):
        np.testing.assert_array_equal(outs[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_array_equal(es_f.steps.numpy(), np.asarray(e.steps))


def test_fused_dive_autoreset_matches_jax_300_steps(env, hover_env, hover_trim, jstep):
    """Collective full down: every env crashes and restarts inside the
    rollout; the done streams and the step counters equal JAX's."""
    e, ref, es_f, outs = _run_both(env, hover_env, hover_trim, jstep, 300, True, 1)
    done = outs["done"].numpy()
    assert done.any(), "dive never terminated inside the fused rollout"
    np.testing.assert_array_equal(done, ref["done"])
    np.testing.assert_array_equal(outs["truncated"].numpy(), ref["truncated"])
    np.testing.assert_array_equal(es_f.steps.numpy(), np.asarray(e.steps))
    np.testing.assert_array_equal(es_f.successed_steps.numpy(),
                                  np.asarray(e.successed_steps))
    assert (es_f.steps.numpy() < 300).all()


def test_fused_plain_equals_port_eager_step(env):
    """The plain version is the port's eager batched step + auto_reset."""
    tr = env.trim_result()
    venv = VectorHeliEnv(env, 16)
    es, _ = venv.reset_from_trim(tr)
    rng = np.random.default_rng(4)
    act = torch.from_numpy((tr.action.numpy() + 0.05 * rng.standard_normal((20, 16, 4))
                            ).astype(np.float32))
    eta = torch.from_numpy((rng.standard_normal((20, 3, 16)) * 50 ** 0.5).astype(np.float32))
    roll = fs.build_fused_rollout(env, 16, 20, collect=("reward", "done", "obs"),
                                  eta_mode="inject")
    with torch.no_grad():
        es_f, outs = roll(es, act, eta)
        for t in range(20):
            es, out = venv.step_with_eta(es, act[t], eta[t].T)
    assert torch.equal(outs["reward"][-1], out.reward)
    assert torch.equal(outs["obs"][-1], out.obs)
    assert torch.equal(es_f.heli.flatten(), es.heli.flatten())
    assert torch.equal(es_f.steps, es.steps)


def test_fused_plain_heavy_equals_port_eager_step():
    """The second airframe through the fused step's plain version (its
    constants from `const_values(env)`) equals the port's eager batched
    step + auto_reset bit for bit over 20 perturbed steps, with one lane
    out of bounds at the start (it fails on step 0 and resets)."""
    env = HeliEnv.build("aw109_heavy", task=HoverTask(), device="cpu")
    tr = env.trim_result()
    venv = VectorHeliEnv(env, 16)
    es, _ = venv.reset_from_trim(tr)
    x = es.heli.x.clone()
    x[0] = env.params.ENV.NS_MAX / 2.0 + 10.0
    es = es.replace(heli=es.heli.replace(x=x))
    rng = np.random.default_rng(5)
    act = torch.from_numpy((tr.action.numpy() + 0.05 * rng.standard_normal((20, 16, 4))
                            ).astype(np.float32))
    eta = torch.from_numpy((rng.standard_normal((20, 3, 16)) * 50 ** 0.5).astype(np.float32))
    roll = fs.build_fused_rollout(env, 16, 20, collect=("reward", "done", "obs"),
                                  eta_mode="inject")
    with torch.no_grad():
        es_f, outs = roll(es, act, eta)
        done = []
        for t in range(20):
            es, out = venv.step_with_eta(es, act[t], eta[t].T)
            done.append(out.done)
    assert torch.equal(outs["done"], torch.stack(done)) and bool(outs["done"][0, 0])
    assert torch.equal(outs["reward"][-1], out.reward)
    assert torch.equal(outs["obs"][-1], out.obs)
    assert torch.equal(es_f.heli.flatten(), es.heli.flatten())
    assert torch.equal(es_f.steps, es.steps)


def test_batch_mode_noise_from_generator(env):
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, 8).reset_from_trim(tr)
    roll = fs.build_fused_rollout(env, 8, 5)
    a = tr.action.expand(8, 4).contiguous()
    r1 = roll(es, a, generator=torch.Generator().manual_seed(3))[1]["reward"]
    r2 = roll(es, a, generator=torch.Generator().manual_seed(3))[1]["reward"]
    r3 = roll(es, a, generator=torch.Generator().manual_seed(4))[1]["reward"]
    assert r1.shape == (5, 8) and torch.equal(r1, r2) and not torch.equal(r1, r3)
    with pytest.raises(ValueError):
        fs.build_fused_rollout(env, 8, 5, eta_mode="inject")(es, a)


def test_const_names_match_cuda_enum(env):
    """The constant table's layout, defined by CONST_NAMES, equals the
    `enum Const` of the CUDA source; every name has a value."""
    with open(os.path.join(REPO, "heligym_tpu_torch", "csrc", "fused_step.cu")) as f:
        src = f.read()
    body = re.search(r"enum Const \{(.*?)\};", src, re.S).group(1)
    enum = [n.strip() for n in re.sub(r"//[^\n]*", "", body).split(",") if n.strip()]
    assert enum[-1] == "K_COUNT"
    assert enum[:-1] == ["K_" + n for n in fs.CONST_NAMES]
    assert set(fs.const_values(env)) == set(fs.CONST_NAMES)


def test_kernel_covers_every_task_and_the_wing(env):
    """What the kernel covers: every task and MixedTask, and airframes with
    and without a wing. The task table's kinds follow `enum TaskKind` of the
    CUDA source, and each row holds the floats the task's own reward uses.
    A winged airframe passes the launch checks and picks the kernels' winged
    instantiation, gated as the JAX package gates the term (`WN.ZUW != 0`);
    its constant table holds the wing's coefficients."""
    import dataclasses
    from heligym_tpu_torch.envs import (ForwardFlightTask, LandingTask, MixedTask,
                                        ObliqueFlightTask, SlalomTask,
                                        TurningFlightTask)
    with open(os.path.join(REPO, "heligym_tpu_torch", "csrc", "fused_step.cu")) as f:
        body = re.search(r"enum TaskKind \{(.*?)\};", f.read(), re.S).group(1)
    kinds = [n.strip() for n in body.split(",") if n.strip()]
    assert kinds == ["T_" + k.upper() for k in fs.TASK_KINDS] + ["T_KIND_COUNT"]

    singles = (Task(), HoverTask(), ForwardFlightTask(), TurningFlightTask(),
               SlalomTask(), LandingTask(), LandingTask(touch_alt=3900.0),
               ObliqueFlightTask())
    n = 4
    carry, init = torch.zeros(fs.CROWS, n), torch.zeros(fs.IROWS, n)
    launch_check = lambda e: fs._checked(e, carry, init, torch.zeros(n, 4),
                                         torch.zeros(3, n), carry, None, None)
    for task in singles:
        e = env.replace(task=task)
        launch_check(e)
        table = fs.task_table(e)
        assert table.shape == (1, fs.TASK_STRIDE) and table.dtype == np.float32
        assert fs.TASK_KINDS[int(table[0, 0])] == task.KIND
        folded = task.folded(e.normalizers)
        np.testing.assert_array_equal(table[0, 1:1 + len(folded)],
                                      np.asarray(folded, np.float32))
    mixed = env.replace(task=MixedTask(tasks=singles[1:]))
    assert fs.task_table(mixed).shape == (len(singles) - 1, fs.TASK_STRIDE)
    with pytest.raises(ValueError):
        fs.task_table(env.replace(task=MixedTask()))
    assert not fs.has_wing(env)
    wn = dataclasses.replace(env.params.WN, ZUU=2.0, ZUW=-170.0, ZMAX=-110.0)
    winged = env.replace(params=dataclasses.replace(env.params, WN=wn))
    consts, _ = launch_check(winged)
    assert fs.has_wing(winged)
    for name, v in (("WN_ZUU", 2.0), ("WN_ZUW", -170.0), ("WN_ZMAX", -110.0)):
        assert consts[fs.CONST_NAMES.index(name)] == np.float32(v)
    # ZUU alone makes no wing, in both packages
    lift_only = dataclasses.replace(env.params.WN, ZUU=2.0)
    assert not fs.has_wing(env.replace(
        params=dataclasses.replace(env.params, WN=lift_only)))


def test_param_block_layout(env):
    """The host tables that the C entry points copy into the kernel's
    parameter block: the constant table in CONST_NAMES order (the `enum
    Const` of the source, checked above), the task table in TASK_KINDS
    order with at most MAX_TASKS rows, and the block's two fields as the
    source declares them, inside the 4 KB of kernel parameters."""
    from heligym_tpu_torch.envs import MixedTask
    with open(os.path.join(REPO, "heligym_tpu_torch", "csrc", "fused_step.cu")) as f:
        src = f.read()
    consts, tasks = fs._tables(env)
    vals = fs.const_values(env)
    assert consts.dtype == np.float32 and consts.shape == (len(fs.CONST_NAMES),)
    np.testing.assert_array_equal(
        consts, np.asarray([vals[n] for n in fs.CONST_NAMES], np.float32))
    np.testing.assert_array_equal(tasks, fs.task_table(env))
    assert tasks.flags.c_contiguous and tasks.dtype == np.float32
    assert int(re.search(r"kMaxTasks = (\d+);", src).group(1)) == fs.MAX_TASKS
    assert int(re.search(r"kTaskStride = (\d+);", src).group(1)) == fs.TASK_STRIDE
    body = re.search(r"struct Params \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"float (\w+)\[([^\]]+)\];", body) == [
        ("c", "K_COUNT"), ("tasks", "kMaxTasks * kTaskStride")]
    assert 4 * (len(fs.CONST_NAMES) + fs.MAX_TASKS * fs.TASK_STRIDE) + 128 <= 4096
    too_many = env.replace(task=MixedTask(tasks=(HoverTask(),) * (fs.MAX_TASKS + 1)))
    with pytest.raises(ValueError):
        fs._tables(too_many)
    # the block size every launch takes is one the kernel's launch accepts
    sizes = [int(v) for v in re.findall(r"block != (\d+)", src)]
    assert sizes == [32, 64, 128] and fs.BLOCK in sizes


def test_launch_checks(env):
    """What a launch checks once, before its arguments reach the kernel:
    every block's shape (T leading the act, eta and collect blocks of a
    T-step launch; a (B, 4) act held for every step), dtype and
    contiguity."""
    n, steps = 4, 3
    z = lambda *shape: torch.zeros(shape)
    carry, init = z(fs.CROWS, n), z(fs.IROWS, n)

    def check(act, eta, x, steps=None):
        return fs._checked(env, carry, init, act, eta, carry, x, steps)
    consts, tasks = check(z(n, 4), z(3, n), z(fs.XROWS, n))
    assert consts.shape == (len(fs.CONST_NAMES),) and tasks.shape == (1, fs.TASK_STRIDE)
    check(z(n, 4), z(steps, 3, n), z(steps, fs.XROWS, n), steps)
    check(z(steps, n, 4), z(steps, 3, n), None, steps)
    for bad in ((z(steps, n, 4), z(3, n), None, None),
                (z(n, 4), z(steps, 3, n), z(fs.XROWS, n), steps),
                (z(steps + 1, n, 4), z(steps, 3, n), None, steps),
                (z(4, n).T, z(3, n), None, None),
                (z(n, 4).double(), z(3, n), None, None)):
        with pytest.raises(ValueError):
            check(*bad)


def test_fused_rollout_on_cpu_is_the_plain_loop(env):
    """`fused_rollout` on CPU tensors equals T `fused_step_plain` calls, with
    per-step and with held actions; `build_fused_rollout` on the CPU runs
    that loop."""
    tr = env.trim_result()
    n, steps = 16, 6
    es, _ = VectorHeliEnv(env, n).reset_from_trim(tr)
    rng = np.random.default_rng(6)
    act = torch.from_numpy((tr.action.numpy() + 0.05 * rng.standard_normal(
        (steps, n, 4))).astype(np.float32))
    eta = torch.from_numpy((rng.standard_normal((steps, 3, n)) * 50 ** 0.5)
                           .astype(np.float32))
    carry, init = fs.pack(es)
    rewards = []
    with torch.no_grad():
        for actions in (act, act[0]):
            c, xs = carry.clone(), []
            for t in range(steps):
                c, x = fs.fused_step_plain(
                    env, c, init, actions[t] if actions.dim() == 3 else actions, eta[t])
                xs.append(x)
            c2, x2 = fs.fused_rollout(env, carry.clone(), init, actions, eta)
            assert torch.equal(c, c2) and torch.equal(torch.stack(xs), x2)
            rewards.append(x2[:, fs.CREW])
        out = fs.build_fused_rollout(env, n, steps, collect=("reward",),
                                     eta_mode="inject")(es, act, eta)[1]["reward"]
    assert torch.equal(out, rewards[0])
