"""The port's CUDA kernels against their plain PyTorch versions and against
each other (one-step and T-step launches, every block size the kernel
takes, the graphed collector and its eager loop), on the card.

Skips where there is no CUDA card. It imports no JAX, so it also runs on a
machine without JAX, where the suite's conftest (which imports JAX) must be
left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from heligym_tpu_torch.envs import (ForwardFlightTask, HeliEnv, HoverTask,
                                    LandingTask, MixedTask, ObliqueFlightTask,
                                    SlalomTask, TurningFlightTask, VectorHeliEnv)
from heligym_tpu_torch.ops.cuda import fused_step as fs, gather

TASK_NAMES = ("hover", "forward", "turning", "slalom", "landing",
              "landing_touch", "oblique", "mixed4", "mixed7")


def make_task(name, alt):
    """Task `name` with its altitude target at `alt` [ft above sea level],
    the trim altitude, so that in-tolerance flags fire."""
    single = {
        "hover": HoverTask(sea_alt=alt),
        "forward": ForwardFlightTask(sea_alt=alt, vel=60.0),
        "turning": TurningFlightTask(sea_alt=alt),
        "slalom": SlalomTask(sea_alt=alt, vel=60.0),
        "landing": LandingTask(),
        "landing_touch": LandingTask(touch_alt=alt - 100.0),
        "oblique": ObliqueFlightTask(sea_alt=alt, vel=60.0),
    }
    if name == "mixed4":
        return MixedTask(tasks=tuple(single[k] for k in
                                     ("hover", "forward", "turning", "oblique")))
    if name == "mixed7":
        return MixedTask(tasks=tuple(single.values()))
    return single[name]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernel_vs_plain(env, es, tr, steps, dive, seed=0, equal_nan=False):
    n = es.steps.shape[0]
    rng = np.random.default_rng(seed)
    act = (tr.action.cpu().numpy() + 0.02 * rng.standard_normal((steps, n, 4))
           ).astype(np.float32)
    if dive:
        act[..., 0] = -1.0
    eta = (rng.standard_normal((steps, 3, n)) * 50 ** 0.5).astype(np.float32)
    act, eta = torch.from_numpy(act).cuda(), torch.from_numpy(eta).cuda()
    carry_k, init = fs.pack(es)
    carry_p = carry_k.clone()
    done_any = False
    for t in range(steps):
        carry_k, x_k = fs.fused_step(env, carry_k, init, act[t], eta[t])
        with torch.no_grad():
            carry_p, x_p = fs.fused_step_plain(env, carry_p, init, act[t], eta[t])
        assert torch.equal(x_k[fs.CDONE:fs.COBS0], x_p[fs.CDONE:fs.COBS0])
        assert torch.equal(x_k[fs.CSUCC], x_p[fs.CSUCC])
        done_any |= bool(x_k[fs.CDONE].any())
        if dive:
            continue
        torch.testing.assert_close(x_k[fs.CREW], x_p[fs.CREW], rtol=0, atol=2e-5,
                                   equal_nan=equal_nan)
        for lo, hi in ((fs.COBS0, fs.CSUCC), (fs.CFINAL0, fs.XROWS)):
            torch.testing.assert_close(x_k[lo:hi], x_p[lo:hi], rtol=1e-4,
                                       atol=2e-3, equal_nan=equal_nan)
    if not dive:
        torch.testing.assert_close(carry_k[:fs.SROWS], carry_p[:fs.SROWS],
                                   rtol=2e-4, atol=2e-4, equal_nan=equal_nan)
    assert torch.equal(carry_k[fs.STEPS:], carry_p[fs.STEPS:])
    return done_any


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, on the card (30 steps at
    4096 envs; tolerances of the fused parity contract)."""
    _need_card()
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, 4096).reset_from_trim(tr)
    _kernel_vs_plain(env, es, tr, 30, dive=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TASK_NAMES)
def test_kernel_matches_plain_every_task(name):
    """Every task and MixedTask through the kernel and the plain version
    from a 60 ft/s forward trim: 30 nominal steps at the parity tolerances,
    then a 300-step dive with identical flags and counters."""
    _need_card()
    env = HeliEnv.build("aw109")
    tr = env.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
    env = env.replace(task=make_task(name, float(-tr.state.z)))
    venv = VectorHeliEnv(env, 4096)
    es, _ = venv.reset_from_trim(tr)
    if isinstance(env.task, MixedTask):
        es = venv.assign_tasks(es, np.arange(4096) % len(env.task.tasks))
    _kernel_vs_plain(env, es, tr, 30, dive=False, equal_nan=True)
    assert _kernel_vs_plain(env, es, tr, 300, dive=True, seed=1), \
        "the dive never terminated"


@pytest.mark.cuda
@pytest.mark.parametrize("axis,shape", [
    (0, (8, 128)), (0, (64, 128)), (0, (64, 1024)), (0, (256, 1024)),
    (0, (1024, 1024)), (1, (8, 128)), (1, (8, 1024)), (1, (64, 1024)),
    (1, (1024, 1024)), (0, (5, 7)), (1, (5, 7))])
def test_gather_kernels_match_plain(axis, shape):
    """Each gather kernel equals its plain version exactly at the probe
    sizes (and at a ragged one), and refuses what it does not take."""
    _need_card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, shape[axis], size=shape)
                           .astype(np.int32)).cuda()
    fn = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    before = gather.launches[f"gather_axis{axis}"]
    out = fn(x, idx)
    torch.cuda.synchronize()
    assert gather.launches[f"gather_axis{axis}"] == before + 1
    assert torch.equal(out, gather.gather_plain(x, idx, axis))
    with pytest.raises(IndexError):
        fn(x, idx + shape[axis])
    with pytest.raises(ValueError):
        fn(x.T, idx.T.contiguous().T)


def _bits_equal(a, b):
    """Bit-for-bit equality of two float tensors (NaN payloads included)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _case(name, n):
    """(env, state, trim, dive) of a parity case: hover from its trim, the
    4-task MixedTask from a 60 ft/s trim, or the hover dive with resets."""
    env = HeliEnv.build("aw109", task=HoverTask())
    if name == "mixed4":
        tr = env.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
        env = env.replace(task=make_task("mixed4", float(-tr.state.z)))
        venv = VectorHeliEnv(env, n)
        es, _ = venv.reset_from_trim(tr)
        return env, venv.assign_tasks(es, np.arange(n) % 4), tr, False
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, n).reset_from_trim(tr)
    return env, es, tr, name == "dive"


def _card_inputs(tr, steps, n, dive, seed):
    rng = np.random.default_rng(seed)
    act = (tr.action.cpu().numpy() + 0.02 * rng.standard_normal((steps, n, 4))
           ).astype(np.float32)
    if dive:
        act[..., 0] = -1.0
    eta = (rng.standard_normal((steps, 3, n)) * 50 ** 0.5).astype(np.float32)
    return torch.from_numpy(act).cuda(), torch.from_numpy(eta).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hover", "mixed4", "dive"])
def test_rollout_launch_equals_step_launches(name):
    """One T-step launch equals T one-step launches bit for bit (collect
    block of every step, final carry), with per-step and with held actions;
    it counts T steps and one rollout call."""
    _need_card()
    n, steps = 4096, (300 if name == "dive" else 30)
    env, es, tr, dive = _case(name, n)
    act, eta = _card_inputs(tr, steps, n, dive, seed=2)
    carry0, init = fs.pack(es)
    for actions in (act, act[0].contiguous()):
        c1, xs = carry0.clone(), []
        for t in range(steps):
            c1, x = fs.fused_step(env, c1, init,
                                  actions[t] if actions.dim() == 3 else actions, eta[t])
            xs.append(x)
        before, calls = fs.launches, dict(fs.calls)
        c2, x2 = fs.fused_rollout(env, carry0.clone(), init, actions, eta)
        torch.cuda.synchronize()
        assert fs.launches == before + steps
        assert fs.calls["rollout"] == calls["rollout"] + 1
        assert fs.calls["step"] == calls["step"]
        assert _bits_equal(torch.stack(xs), x2) and _bits_equal(c1, c2)
    if dive:
        assert bool(x2[:, fs.CDONE].any()), "the dive never terminated"


@pytest.mark.cuda
@pytest.mark.parametrize("block", [32, 64, 128])
def test_kept_layout_equals_plain(block, monkeypatch):
    """One thread per env at each block size the kernel takes, one-step
    and T-step launches, against the plain version: every value equal (NaN
    facing NaN), every flag and counter identical, on mixed4 and on the
    dive."""
    _need_card()
    monkeypatch.setattr(fs, "BLOCK", block)
    n = 1000                    # not a multiple of a block: the ragged tail
    for name, steps in (("mixed4", 20), ("dive", 150)):
        env, es, tr, dive = _case(name, n)
        act, eta = _card_inputs(tr, steps, n, dive, seed=3)
        carry, init = fs.pack(es)
        cp, xs = carry.clone(), []
        with torch.no_grad():
            for t in range(steps):
                cp, x = fs.fused_step_plain(env, cp, init, act[t], eta[t])
                xs.append(x)
        xp = torch.stack(xs)
        same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())
        c1, x1 = fs.fused_step(env, carry, init, act[0], eta[0])
        assert same(x1, xp[0])
        ck, xk = fs.fused_rollout(env, carry, init, act, eta)
        torch.cuda.synchronize()
        assert same(xk, xp) and same(ck, cp)


@pytest.mark.cuda
def test_graphed_collector_equals_eager():
    """PPOLearner.collect as one CUDA graph replay equals the eager loop bit
    for bit (trajectory, end state, the generator's state after), over two
    consecutive rollouts, with a seeded generator and with the default one;
    a replay counts its T steps and no one-step launch, the one capture its
    one warm-up step."""
    _need_card()
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    env, n_tasks = build_env("hover", "hover,forward,turning,oblique",
                             "sea_alt=start,vel=60")
    n, steps = 512, 16
    learner = PPOLearner(env, PPOConfig(num_envs=n, rollout_steps=steps))
    ts0 = learner.init(torch.Generator().manual_seed(0),
                       task_ids=np.arange(n) % n_tasks)

    def two(graphed, gen):
        ts, out = ts0, []
        for _ in range(2):
            ts, tr = learner.collect(ts, gen, graphed=graphed)
            out.append(tr)
        return ts, out

    for seeded in (True, False):
        if seeded:
            g_graph = torch.Generator(device="cuda").manual_seed(3)
            g_eager = torch.Generator(device="cuda").manual_seed(3)
        else:
            g_graph = g_eager = None
            torch.cuda.manual_seed(3)
        before, calls = fs.launches, dict(fs.calls)
        ts_g, out_g = two(None, g_graph)
        torch.cuda.synchronize()
        assert fs.launches == before + 2 * steps + 1
        assert fs.calls["replay"] == calls["replay"] + 2
        assert fs.calls["capture"] == calls["capture"] + 1
        assert fs.calls["step"] == calls["step"]
        state_g = (g_graph or torch.cuda.default_generators[0]).get_state()
        if not seeded:
            torch.cuda.manual_seed(3)
        ts_e, out_e = two(False, g_eager)
        state_e = (g_eager or torch.cuda.default_generators[0]).get_state()
        assert torch.equal(state_g, state_e)
        for tg, te in zip(out_g, out_e):
            for f in ("obs", "action", "log_prob", "value", "reward", "terminated",
                      "truncated", "v_boot", "failed", "succ_step", "task_oh"):
                assert _bits_equal(getattr(tg, f), getattr(te, f)), f
        carry_g, _ = fs.pack(ts_g.env_state)
        carry_e, _ = fs.pack(ts_e.env_state)
        assert _bits_equal(carry_g, carry_e)
