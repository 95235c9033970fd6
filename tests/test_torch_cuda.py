"""The port's CUDA kernels against their plain PyTorch versions and against
each other (one-step and T-step launches, every block size the kernel
takes, the graphed collector and its eager loop, the graphed update and its
eager epochs), on the card.

Skips where there is no CUDA card. It imports no JAX, so it also runs on a
machine without JAX, where the suite's conftest (which imports JAX) must be
left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from heligym_tpu_torch.envs import (ForwardFlightTask, HeliEnv, HoverTask,
                                    LandingTask, MixedTask, ObliqueFlightTask,
                                    SlalomTask, TurningFlightTask, VectorHeliEnv)
from heligym_tpu_torch.ops.cuda import fused_step as fs, gather
from torch_airframes import NAME as WINGED, write_winged
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK_NAMES = ("hover", "forward", "turning", "slalom", "landing",
              "landing_touch", "oblique", "mixed4", "mixed7", "hover_heavy")


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
    return single["hover" if name == "hover_heavy" else name]


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
    then a 300-step dive with identical flags and counters; `hover_heavy`
    on the second airframe (aw109_heavy)."""
    _need_card()
    env = HeliEnv.build("aw109_heavy" if name == "hover_heavy" else "aw109")
    tr = env.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
    env = env.replace(task=make_task(name, float(-tr.state.z)))
    venv = VectorHeliEnv(env, 4096)
    es, _ = venv.reset_from_trim(tr)
    if isinstance(env.task, MixedTask):
        es = venv.assign_tasks(es, np.arange(4096) % len(env.task.tasks))
    _kernel_vs_plain(env, es, tr, 30, dive=False, equal_nan=True)
    assert _kernel_vs_plain(env, es, tr, 300, dive=True, seed=1), \
        "the dive never terminated"


PROBE = [(0, (8, 128)), (0, (64, 128)), (0, (64, 1024)), (0, (256, 1024)),
         (0, (1024, 1024)), (1, (8, 128)), (1, (8, 1024)), (1, (64, 1024)),
         (1, (1024, 1024)), (0, (5, 7)), (1, (5, 7))]
# gather_axis0's edges: a ragged last column tile with and without TMA
# (L % 4 != 0 loads by cp.async), x beyond one shared-memory tile (chunks),
# one row, a block with two groups of indices
EDGES = [(0, (1000, 33)), (0, (64, 1000)), (0, (256, 30)), (0, (4096, 64)),
         (0, (2500, 100)), (0, (1, 1024)), (0, (300, 9000))]
PATTERNS = [(axis, shape, pattern) for axis, shape in
            ((0, (1024, 1024)), (0, (4096, 64)), (0, (1000, 33)), (1, (1024, 1024)))
            for pattern in ("zeros", "last", "out_of_range")]
# gather_axis1's edges: L % 4 != 0 (the scalar path), rows over many column
# tiles, one row, many short rows to a tile, S not a multiple of the rows of
# a tile; on both axes, x one float into its buffer (gather_axis0's cp.async
# load and gather_axis1's scalar path at an aligned L)
EDGES_AXIS1 = [(1, (1024, 1022), "random"), (1, (1000, 33), "random"),
               (1, (3, 100000), "random"), (1, (1, 1024), "random"),
               (1, (4096, 64), "random"), (1, (2500, 100), "random"),
               (1, (1024, 1024), "misaligned"), (0, (1024, 1024), "misaligned"),
               (1, (3, 100000), "out_of_range")] + [
    (1, (1000, 33), pattern) for pattern in ("zeros", "last", "out_of_range")]


@pytest.mark.cuda
@pytest.mark.parametrize("axis,shape,pattern",
                         [(a, s, "random") for a, s in PROBE + EDGES] + PATTERNS
                         + EDGES_AXIS1)
def test_gather_kernels_match_plain(axis, shape, pattern):
    """Each gather kernel equals its plain version bit for bit at the probe
    sizes, at every edge of each kernel's plan, from an x that is not
    16-byte aligned and with the indices all 0, all n - 1, or out of range
    (`check=False`: the kernel clamps them), writes every output (a launch
    into an output filled with NaN), and refuses what it does not take."""
    _need_card()
    rng = np.random.default_rng(0)
    n = shape[axis]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    if pattern == "misaligned":   # a view one float into its buffer
        buf = torch.empty(x.numel() + 1, device=x.device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    idx_np = {"random": lambda: rng.integers(0, n, size=shape),
              "misaligned": lambda: rng.integers(0, n, size=shape),
              "zeros": lambda: np.zeros(shape),
              "last": lambda: np.full(shape, n - 1),
              "out_of_range": lambda: rng.integers(-n - 3, 2 * n + 3, size=shape),
              }[pattern]().astype(np.int32)
    idx = torch.from_numpy(idx_np).cuda()
    fn = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    before = gather.launches[f"gather_axis{axis}"]
    out = fn(x, idx, check=pattern != "out_of_range")
    torch.cuda.synchronize()
    assert gather.launches[f"gather_axis{axis}"] == before + 1
    want = gather.gather_plain(x, idx.clamp(0, n - 1), axis)
    assert torch.equal(out, want)
    # the launch plan covers every output: none keeps the NaN it started with
    filled = torch.full_like(x, float("nan"))
    assert gather.kernel_fns()[axis](x.data_ptr(), idx.data_ptr(), filled.data_ptr(),
                                     *shape, torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(filled, want)
    with pytest.raises(IndexError):
        fn(x, idx.clamp(0, n - 1) + n)
    with pytest.raises(ValueError):
        fn(x.T, idx.clamp(0, n - 1).T.contiguous().T)


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


@pytest.mark.cuda
def test_graph_replay_after_update_equals_eager():
    """After a train step (whose collection captured the collector's graph
    and whose update wrote the parameters in place), a replay of that same
    graph equals the eager loop with the new parameters bit for bit; and
    again after the parameters are replaced by new tensors. The rollout's
    outputs carry no autograd history."""
    _need_card()
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    env, _ = build_env("hover", None, "sea_alt=start")
    n, steps = 512, 16
    learner = PPOLearner(env, PPOConfig(num_envs=n, rollout_steps=steps, minibatches=4,
                                        epochs=1, lr=1e-3))
    ts = learner.init(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in learner.param_list(ts.params)]
    ts, _ = learner.train_step(ts)
    assert any(not torch.equal(a, b) for a, b in zip(before, learner.param_list(ts.params)))
    fields = ("obs", "action", "log_prob", "value", "reward", "terminated", "truncated",
              "v_boot", "failed", "succ_step", "task_oh")

    def replay_vs_eager(ts):
        state = ts.generator.get_state()
        calls = dict(fs.calls)
        ts_g, tr_g = learner.collect(ts, ts.generator)
        assert fs.calls["capture"] == calls["capture"]            # the same graph
        assert fs.calls["replay"] == calls["replay"] + 1
        g2 = torch.Generator(device="cuda")
        g2.set_state(state)
        ts_e, tr_e = learner.collect(ts, g2, graphed=False)
        assert torch.equal(ts.generator.get_state(), g2.get_state())
        for f in fields:
            a, b = getattr(tr_g, f), getattr(tr_e, f)
            assert not a.requires_grad and a.grad_fn is None, f
            assert _bits_equal(a, b), f
        assert _bits_equal(fs.pack(ts_g.env_state)[0], fs.pack(ts_e.env_state)[0])

    replay_vs_eager(ts)
    with torch.no_grad():
        for lin in ts.params.dense_layers():
            lin.weight = torch.nn.Parameter(lin.weight * 1.01)
            lin.bias = torch.nn.Parameter(lin.bias + 0.01)
    replay_vs_eager(ts)


@pytest.mark.cuda
def test_capture_survives_a_dead_collector_in_a_cycle(monkeypatch):
    """A learner whose collector holds a captured graph, dropped while it
    sits in a reference cycle, is freed only by Python's cyclic collector;
    a collection inside the next capture would release the dead graph
    there and invalidate the capture. Here every capture begins with a
    collection whenever the cyclic collector is on, as an automatic one
    may run at any allocation: a new learner's graphed collection still
    captures, equals its eager loop bit for bit, and the old learner is
    gone."""
    _need_card()
    import gc
    import weakref
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    env, _ = build_env("hover", None, "sea_alt=start")
    cfg = PPOConfig(num_envs=256, rollout_steps=8)
    old = PPOLearner(env, cfg)
    old_ts = old.init(torch.Generator().manual_seed(0))
    old.collect(old_ts, old_ts.generator)            # captures the old graph
    dead = weakref.ref(old)
    cycle = [old, old_ts]
    cycle.append(cycle)
    del old, old_ts, cycle
    assert dead() is not None          # only the cyclic collector frees it

    begin = torch.cuda.CUDAGraph.capture_begin

    def begin_then_collect(self, *args, **kwargs):
        begin(self, *args, **kwargs)
        if gc.isenabled():
            gc.collect()
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", begin_then_collect)

    learner = PPOLearner(env, cfg)
    ts = learner.init(torch.Generator().manual_seed(1))
    state = ts.generator.get_state()
    captures = fs.calls["capture"]
    _, tr_g = learner.collect(ts, ts.generator)
    assert fs.calls["capture"] == captures + 1
    assert dead() is None
    g2 = torch.Generator(device="cuda")
    g2.set_state(state)
    _, tr_e = learner.collect(ts, g2, graphed=False)
    for f in ("obs", "action", "log_prob", "value", "reward", "terminated"):
        assert _bits_equal(getattr(tr_g, f), getattr(tr_e, f)), f


def _benchmark_learner(name):
    """`PPOLearner` of a benchmark configuration (`perfbench/configs/`: its
    PPO settings, env and committed checkpoint), and `state(seed)`: a farm
    from `seed` with the checkpoint's parameters and statistics, its
    episode counters spread over the episode as in a farm mid-training (one
    env in ~30 reaches the time limit inside a 64-step rollout)."""
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.evaluate import build_env
    with open(os.path.join(REPO, "perfbench", "configs", name + ".json")) as f:
        config = json.load(f)
    tasks = config["tasks"]
    env, _ = build_env(tasks[0], ",".join(tasks) if len(tasks) > 1 else None,
                       config["target"], turb_level=config["turbulence_level"],
                       heli=config["airframe"])
    learner = PPOLearner(env, PPOConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                           for k, v in config["ppo"].items()}))
    ck = learner.restore(os.path.join(REPO, config["policy"]),
                         farm_size=int(config["policy_farm"]))
    if config.get("set_log_std") is not None:
        with torch.no_grad():
            ck.params.log_std.fill_(float(config["set_log_std"]))

    def state(seed):
        ids = np.arange(learner.config.num_envs) % len(tasks) if len(tasks) > 1 else None
        ts = learner.init(torch.Generator().manual_seed(seed), task_ids=ids)
        steps = torch.randint(0, env.time_up_steps, (learner.config.num_envs,),
                              generator=torch.Generator().manual_seed(seed),
                              dtype=torch.int32)
        es = ts.env_state.replace(steps=steps.to(ts.env_state.steps.device))
        return ts.replace(env_state=es, params=ck.params, obs_stats=ck.obs_stats,
                          update_count=int(config.get("start_update", 0)),
                          generator=torch.Generator(device="cuda").manual_seed(seed))
    return learner, state


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aw109-hover", "aw109-mixed4"])
def test_bootstrap_equals_full_evaluation(name, monkeypatch):
    """The collector's value bootstrap at the benchmark's sizes (16384 envs
    x 64 steps, the committed checkpoints, envs ending inside the rollout),
    3 seeds x 2 graphed collects:
    v_boot equals bit for bit the full network on all T x B pre-reset obs in
    one batch, where the rows it reuses come from the rollout's batches of
    B and the rest from one batch of the last step's and the ended rows;
    the pre-reset obs of a transition whose env did not end equals the next
    step's obs bit for bit; no layer of the actor runs after the replay."""
    _need_card()
    from heligym_tpu_torch.learner import ppo
    learner, state = _benchmark_learner(name)
    T, B = learner.config.rollout_steps, learner.config.num_envs
    ts = state(0)
    learner.collect(ts, ts.generator)                # builds the collector
    roll, seen, actor_calls = learner._fused_rollout, {}, []

    def spy(*a, **kw):
        es, traj = roll(*a, **kw)
        seen.update(traj, actor_calls=len(actor_calls))
        return es, traj

    monkeypatch.setattr(learner, "_fused_rollout", spy)
    net = ts.params
    hooks = [lin.register_forward_hook(lambda *_: actor_calls.append(1))
             for lin in [*net.actor, net.mean]]
    try:
        for seed in (5, 2 ** 31 + 11, 987654323):
            ts = state(seed)
            for _ in range(2):
                counts = (ppo.bootstrap_valued_rows, ppo.bootstrap_reused_rows)
                ts_next, tr = learner.collect(ts, ts.generator)
                assert len(actor_calls) == seen["actor_calls"]
                ended = seen["terminated"] | seen["truncated"]
                assert ended[:-1].any()
                valued = ppo.bootstrap_valued_rows - counts[0]
                assert valued == B + int(ended[:-1].sum())
                assert valued + ppo.bootstrap_reused_rows - counts[1] == T * B
                stats = ts.obs_stats if learner.config.obs_norm else None
                toh = learner._task_oh(ts.env_state.task_id)
                with torch.no_grad(), ppo._fp32_matmuls():
                    full = net(learner._net_in(seen["final_obs"], stats, toh))[2]
                assert _bits_equal(tr.v_boot, full)
                kept = ~ended[:-1]
                assert _bits_equal(seen["final_obs"][:-1][kept], seen["obs"][1:][kept])
                ts = ts_next
    finally:
        for h in hooks:
            h.remove()


def _train_state_bits(learner, ts):
    """Every tensor a train step advances: parameters, Adam's moments and
    count, the observation statistics."""
    s = ts.obs_stats
    return (learner.param_list(ts.params) + ts.opt_state.mu + ts.opt_state.nu
            + [ts.opt_state.count, s.mean, s.var, s.count])


def _assert_states_equal(learner, ts_a, m_a, ts_b, m_b):
    assert ts_a.update_count == ts_b.update_count
    for i, (a, b) in enumerate(zip(_train_state_bits(learner, ts_a),
                                   _train_state_bits(learner, ts_b))):
        assert torch.equal(a, b), i
    assert m_a.keys() == m_b.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["warmup_anneal", "kl_stop_vf_clip"])
def test_graphed_update_equals_eager(case):
    """Three train steps with the update as one CUDA graph of an epoch,
    replayed `epochs` times, against the eager update from the same state,
    bit for bit: parameters, Adam's moments and count, metrics and the
    observation statistics (unfrozen). 1024 envs x 16 steps, 2 epochs x 4
    minibatches; the critic warm-up ends between the first and second steps
    (the actor's scale goes from 0 to 1) while lr and the entropy
    coefficient anneal; `kl_stop_vf_clip` adds the KL stop and value
    clipping. The graphed run captures once, replays twice an update and
    runs no eager minibatch step; the eager run neither captures nor
    replays."""
    _need_card()
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner, ppo
    from heligym_tpu_torch.learner.evaluate import build_env
    env, _ = build_env("hover", None, "sea_alt=start")
    kw = dict(target_kl=2e-4, vf_clip_eps=0.2) if case == "kl_stop_vf_clip" \
        else dict(vf_clip_eps=0.0)
    cfg = PPOConfig(num_envs=1024, rollout_steps=16, minibatches=4, epochs=2, lr=1e-3,
                    critic_warmup=1, anneal_updates=10, freeze_obs_stats=False,
                    success_bonus=1.0, fail_penalty=5.0, **kw)
    learner = PPOLearner(env, cfg)

    def three(graphed):
        ts, out = learner.init(torch.Generator().manual_seed(0)), []
        counts = (ppo.update_captures, ppo.update_replays, ppo.eager_minibatch_steps)
        for _ in range(3):
            ts, m = learner.train_step(ts, graphed=graphed)
            out.append((ts, m))
        torch.cuda.synchronize()
        now = (ppo.update_captures, ppo.update_replays, ppo.eager_minibatch_steps)
        return out, tuple(b - a for a, b in zip(counts, now))

    graphed, n_graphed = three(None)
    eager, n_eager = three(False)
    assert n_graphed == (1, 3 * cfg.epochs, 0)
    assert n_eager == (0, 0, 3 * cfg.epochs * cfg.minibatches)
    for (ts_g, m_g), (ts_e, m_e) in zip(graphed, eager):
        _assert_states_equal(learner, ts_g, m_g, ts_e, m_e)
    if case == "kl_stop_vf_clip":
        assert any(float(m["approx_kl"]) > 0 for _, m in graphed)


@pytest.mark.cuda
def test_graphed_update_recaptures_after_restore(tmp_path):
    """After `restore` into new tensors, the next graphed update captures
    again and still equals the eager update bit for bit, and the one after
    it replays the same graph; an injected shuffle (a list of one
    permutation per epoch on the card, as `chip_smoke.py` passes it) gives
    the same update graphed and eager."""
    _need_card()
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner, ppo
    from heligym_tpu_torch.learner.evaluate import build_env
    env, _ = build_env("hover", None, "sea_alt=start")
    cfg = PPOConfig(num_envs=1024, rollout_steps=16, minibatches=4, epochs=2, lr=1e-3,
                    critic_warmup=1)
    learner = PPOLearner(env, cfg)
    ts, _ = learner.train_step(learner.init(torch.Generator().manual_seed(0)))
    path = str(tmp_path / "step.npz")
    learner.save(path, ts)

    def restored():
        return learner.restore(path, ts)

    captures = ppo.update_captures
    ts_g, m_g = learner.train_step(restored())
    assert ppo.update_captures == captures + 1
    ts_e, m_e = learner.train_step(restored(), graphed=False)
    _assert_states_equal(learner, ts_g, m_g, ts_e, m_e)
    ts_g2, m_g2 = learner.train_step(ts_g)
    ts_e2, m_e2 = learner.train_step(ts_e, graphed=False)
    assert ppo.update_captures == captures + 1
    _assert_states_equal(learner, ts_g2, m_g2, ts_e2, m_e2)

    n = cfg.num_envs * cfg.rollout_steps
    perms = [torch.randperm(n, generator=torch.Generator().manual_seed(e)).cuda()
             for e in range(cfg.epochs)]
    ts_g, ts_e = restored(), restored()
    ts_g, traj = learner.collect(ts_g, ts_g.generator)
    replays = ppo.update_replays
    ts_g, m_g = learner.update(ts_g, traj, idx=perms)
    assert ppo.update_replays == replays + cfg.epochs
    ts_e, m_e = learner.update(ts_e, traj, idx=perms, graphed=False)
    _assert_states_equal(learner, ts_g, m_g, ts_e, m_e)


@pytest.mark.cuda
def test_trim_batched_card_equals_cpu():
    """The batched Newton trim on the card converges for a band of start
    altitudes (6-55 ft, the gear near contact at the low edge) and for
    forward-flight conditions, and agrees with the same solve on the CPU:
    state over max(|CPU|, 1) and action within 5e-3."""
    _need_card()
    from heligym_tpu_torch.envs.trim import trim_batched
    from heligym_tpu_torch.learner.train import make_alt_band_sampler
    from heligym_tpu_torch.ops import dryden
    from heligym_tpu_torch.utils.constants import EPS
    env = HeliEnv.build("aw109", task=HoverTask())
    conds = make_alt_band_sampler(6.0, 55.0)(torch.Generator(device="cuda").manual_seed(1),
                                             256)
    conds["ned_vel"][:3] = torch.tensor([[0.0, 0.0, 0.0], [50.0, 0.0, 0.0],
                                         [100.0, 10.0, 0.0]], device="cuda")
    conds["gr_alt"][:3] = torch.tensor([100.0, 1000.0, 3000.0], device="cuda")
    wind = dryden.mean_wind(env.wind_params, device="cuda")
    card = trim_batched(env.params, env.terrain, wind, conds)
    cpu = trim_batched(env.params, env.terrain.to("cpu"), wind.cpu(),
                       {k: v.cpu() for k, v in conds.items()})
    assert card.result.action.is_cuda
    assert bool((card.sq_residual < EPS).all()) and card.iterations < 50
    ref = cpu.result.state.flatten()
    scale = ref.abs().clamp(min=1.0)
    torch.testing.assert_close(card.result.state.flatten().cpu() / scale, ref / scale,
                               rtol=0, atol=5e-3)
    torch.testing.assert_close(card.result.action.cpu(), cpu.result.action, rtol=0,
                               atol=5e-3)


@pytest.mark.cuda
def test_kernel_matches_plain_from_randomized_farm():
    """A farm from `reset_randomized` under the default sampler (headings,
    speeds, altitudes and x/y over +-3000 ft differ per env): the kernel
    equals its plain version bit for bit over 30 steps in which a 0.3 s
    episode wall resets every env, and each env that ends gets its own
    snapshot's rows back."""
    _need_card()
    from heligym_tpu_torch.envs.trim import trim_batched
    from heligym_tpu_torch.learner.train import default_cond_sampler
    from heligym_tpu_torch.ops import dryden
    env = HeliEnv.build("aw109", task=HoverTask()).replace(max_time=0.3)
    n = 2048
    gen = lambda: torch.Generator(device="cuda").manual_seed(11)
    es, _ = VectorHeliEnv(env, n).reset_randomized(gen(), default_cond_sampler)
    tr = trim_batched(env.params, env.terrain,
                      dryden.mean_wind(env.wind_params, device="cuda"),
                      default_cond_sampler(gen(), n)).result
    assert torch.equal(es.init.heli.flatten(), tr.state.flatten())
    rng = np.random.default_rng(4)
    act = tr.action.cpu().numpy() + 0.02 * rng.standard_normal((30, n, 4))
    eta = rng.standard_normal((30, 3, n)) * 50 ** 0.5
    act = torch.from_numpy(act.astype(np.float32)).cuda()
    eta = torch.from_numpy(eta.astype(np.float32)).cuda()
    carry_k, init = fs.pack(es)
    carry_p = carry_k.clone()
    ended_once = torch.zeros(n, dtype=torch.bool, device="cuda")
    for t in range(30):
        carry_k, x_k = fs.fused_step(env, carry_k, init, act[t], eta[t])
        with torch.no_grad():
            carry_p, x_p = fs.fused_step_plain(env, carry_p, init, act[t], eta[t])
        assert _bits_equal(carry_k, carry_p) and _bits_equal(x_k, x_p), t
        ended = (x_k[fs.CDONE] != 0) | (x_k[fs.CTRUNC] != 0)
        assert _bits_equal(carry_k[:fs.SROWS][:, ended], init[:fs.SROWS][:, ended])
        ended_once |= ended
    assert bool(ended_once.all())


def _distill_pair(n, hidden):
    """(card learner, CPU learner, network on the CPU, stats) on landing at
    the gear-contact altitude + 8 ft with a 0.36 s episode wall, so that the
    envs started below ~15 ft succeed and the others time out."""
    from heligym_tpu_torch.learner import ObsStats, PPOConfig, PPOLearner
    from heligym_tpu_torch.learner.train import _parse_target
    learners = []
    for dev in ("cuda", "cpu"):
        env = HeliEnv.build("aw109", task=LandingTask(), device=dev)
        env = env.replace(task=env.task.with_target(
            **_parse_target("touch_alt=ground+8", env)), max_time=0.36)
        learners.append(PPOLearner(env, PPOConfig(num_envs=n, hidden=hidden)))
    net = learners[1].make_network(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    stats = ObsStats(mean=torch.from_numpy(rng.standard_normal(17).astype(np.float32) * 0.3),
                     var=torch.from_numpy(rng.uniform(0.5, 2.0, 17).astype(np.float32)),
                     count=torch.tensor(3e3))
    return learners[0], learners[1], net, stats


def _on(dev, net, stats):
    import copy
    from heligym_tpu_torch.learner import ObsStats, TrainState
    return TrainState(params=copy.deepcopy(net).to(dev), env_state=None, update_count=0,
                      obs_stats=ObsStats(*(getattr(stats, k).to(dev)
                                           for k in ("mean", "var", "count"))))


@pytest.mark.cuda
def test_distill_collector_card_equals_cpu():
    """`learner/distill.py::make_collector` on the card (the step kernel,
    20 launches) against the same collector on the CPU (the plain version),
    from the same start farm with the same injected action and Dryden
    noise: obs at the fused contract (rtol 1e-4, atol 2e-3), resid at atol
    2e-5, the weights and the success fraction equal, some episodes
    succeeding and some not."""
    _need_card()
    from heligym_tpu_torch.envs.env import map_tensors
    from heligym_tpu_torch.learner import distill
    from heligym_tpu_torch.learner.train import make_alt_grid_sampler
    n, steps = 256, 20
    card, cpu, net, stats = _distill_pair(n, (64, 64))
    es, _ = VectorHeliEnv(cpu.env, n, auto_reset=False).reset_randomized(
        torch.Generator().manual_seed(0), make_alt_grid_sampler(6.0, 20.0))
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.standard_normal((steps, n, 4)).astype(np.float32))
    eta = torch.from_numpy((rng.standard_normal((steps, 3, n)) * 50 ** 0.5).astype(np.float32))
    out = {}
    for learner, dev in ((card, "cuda"), (cpu, "cpu")):
        before = fs.launches
        out[dev] = distill.make_collector(learner.env, learner, episodes=n, steps=steps,
                                          cond_sampler=None)(
            _on(dev, net, stats), None, log_std_override=-3.0,
            start=map_tensors(lambda x: x.to(dev), es), noise=noise.to(dev),
            eta_seq=eta.to(dev))
        assert fs.launches - before == (steps if dev == "cuda" else 0)
    (obs_k, resid_k, w_k, succ_k), (obs_p, resid_p, w_p, succ_p) = out["cuda"], out["cpu"]
    assert obs_k.is_cuda and torch.equal(w_k.cpu(), w_p) and succ_k == succ_p
    assert 0.0 < succ_k < 1.0
    torch.testing.assert_close(obs_k.cpu(), obs_p, rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(resid_k.cpu(), resid_p, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_bc_fit_card_equals_cpu():
    """`make_bc_fitter` on the card against the CPU: 2 epochs over 8192 rows
    in minibatches of 2048 from the same network, data and permutations;
    every parameter within 1e-4 of its tensor's largest magnitude (phase 5b's
    bar for one update), the losses within 1e-4, the critic and log_std
    bit-equal to the input's."""
    _need_card()
    from heligym_tpu_torch.learner import distill
    card, cpu, net, stats = _distill_pair(8, (256, 256))
    rng = np.random.default_rng(5)
    T, B = 4, 2048
    obs = (rng.standard_normal((T, B, 17)) * np.asarray(
        [500, 15, 15, 5, 10, 10, 5, 0.2, 0.2, 0.5, 0.3, 0.3, 0.3, 30, 30, 1700, 50]) * 0.1)
    data = [torch.from_numpy(a.astype(np.float32)) for a in
            (obs, rng.standard_normal((T, B, 4)) * 0.1,
             (rng.random((T, B)) < 0.7) * rng.uniform(0.5, 2.0, (T, B)))]
    perms = [torch.from_numpy(rng.permutation(T * B)) for _ in range(2)]
    res = {}
    for learner, dev in ((card, "cuda"), (cpu, "cpu")):
        ts = _on(dev, net, stats)
        res[dev] = distill.make_bc_fitter(learner, lr=3e-4, minibatch=2048)(
            ts, *(a.to(dev) for a in data), epochs=2, perms=[p.to(dev) for p in perms])
    (ts_k, loss_k), (ts_p, loss_p) = res["cuda"], res["cpu"]
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    moved = 0
    for (name, _, a), (_, _, b), (_, _, c) in zip(ts_k.params.flax_leaves(),
                                                  ts_p.params.flax_leaves(),
                                                  net.flax_leaves()):
        a, b, c = a.detach().cpu(), b.detach(), c.detach()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
        if name in net.actor_flax_names() - {"log_std"}:
            moved += not torch.equal(a, c)
        else:
            assert torch.equal(a, c), name
    assert moved == 6


@pytest.mark.cuda
def test_scripted_expert_lands_on_card():
    """The scripted expert (`learner/scripted.py`) flies 16 full episodes
    from a 6-30 ft start grid on the card (`tools/torch_tune_scripted.py`,
    the step kernel each step) and lands (settled on the gear at the
    contact altitude) in at least 3 of 4, as the JAX package's
    test_scripted_landing_succeeds lands from 15 ft."""
    _need_card()
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "torch_tune_scripted", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "torch_tune_scripted.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    before = fs.launches
    out = tool.main(["--envs", "16", "--band", "6:30", "--seeds", "0"])
    assert fs.launches - before == 2003
    assert out["mean_succ"] >= 0.75, out


@pytest.mark.cuda
def test_gym_cores_card_equal_cpu():
    """The gymnasium facades' cores (`envs/gym_core.py`) on the card (one
    step-kernel launch a step) against the same cores on the CPU (the plain
    version) from the same state and noise: the single env 100 steps of
    the trim action, no auto-reset; 64 envs, half diving, 200 steps with
    auto-reset. Done, truncated, failed and success streams and the
    counters equal at every step; the helicopter state, the obs and the
    final obs at the fused contract (`tests/test_fused.py`: state rtol/atol
    2e-4, obs rtol 1e-4 / atol 2e-3) for 30 steps, and within a drift of
    2e-3 (`tests/test_rollouts.py`'s measure) over the run: CUDA's and the
    CPU's transcendental functions differ by ulps, which the dynamics grow,
    most in the k4 derivatives (outside the contract: up to 2.7 times the
    state tolerance within 30 steps on the H100, where the state stays
    under 0.2% of it); every ended env's obs its snapshot's."""
    _need_card()
    from heligym_tpu_torch.envs import BatchCore, SingleCore
    for n, steps, dive in ((1, 100, False), (64, 200, True)):
        cores = {}
        for dev in ("cuda", "cpu"):
            env = HeliEnv.build("aw109", task=HoverTask(), device=dev)
            cores[dev] = SingleCore(env) if n == 1 else BatchCore(env, n)
            cores[dev].reset()
        card, cpu = cores["cuda"], cores["cpu"]
        assert torch.equal(card.carry.cpu(), cpu.carry) and torch.equal(card.init.cpu(), cpu.init)
        rng = np.random.default_rng(n)
        act = np.tile(card.trim({}).action.numpy(), (n, 1)).astype(np.float32)
        if dive:
            act[::2, 0] = -1.0
        snapshot = card.init[fs.O0:fs.D0].cpu().numpy().T
        ended, traj = 0, {"cuda": [], "cpu": []}
        for t in range(steps):
            eta = (rng.standard_normal((3, n)) * 50 ** 0.5).astype(np.float32)
            before = fs.launches
            k, p = card.step_with_eta(act, eta), cpu.step_with_eta(act, eta)
            assert fs.launches - before == 1
            for f in ("done", "truncated", "failed", "successed"):
                np.testing.assert_array_equal(getattr(k, f), getattr(p, f), err_msg=f"{f} {t}")
            carry_k = card.carry.cpu()
            assert torch.equal(carry_k[fs.STEPS:], cpu.carry[fs.STEPS:]), t
            if t < 30:
                torch.testing.assert_close(carry_k[fs.H0:fs.W0], cpu.carry[fs.H0:fs.W0],
                                           rtol=2e-4, atol=2e-4)
                torch.testing.assert_close(carry_k[fs.O0:fs.D0], cpu.carry[fs.O0:fs.D0],
                                           rtol=1e-4, atol=2e-3)
                np.testing.assert_allclose(k.final_obs, p.final_obs, rtol=1e-4, atol=2e-3)
            for key, c, x in (("cuda", carry_k, k), ("cpu", cpu.carry, p)):
                traj[key].append(torch.cat([c[fs.H0:fs.W0].T, c[fs.O0:fs.D0].T,
                                            torch.from_numpy(x.final_obs)], dim=1))
            ends = k.done | k.truncated
            ended += int(ends.sum())
            np.testing.assert_array_equal(k.obs[ends], snapshot[ends])
        a, b = torch.stack(traj["cuda"]), torch.stack(traj["cpu"])
        scale = b.abs().amax(dim=0, keepdim=True).clamp(min=1.0)
        assert float(((a - b).abs() / scale).max()) < 2e-3
        assert (ended >= n // 2) if dive else ended == 0


@pytest.mark.cuda
def test_native_frame_from_card_state_equals_cpu():
    """The native renderer draws the same frame from a state on the card as
    from its CPU copy, and so does the top-down view."""
    _need_card()
    from heligym_tpu_torch.envs.env import map_tensors
    from heligym_tpu_torch.render import NativeRenderer, NumpyTopDownRenderer, native_available
    assert native_available()
    env = HeliEnv.build("aw109", task=HoverTask(), device="cuda")
    es, _ = env.reset()
    es = es.replace(heli=es.heli.replace(x=es.heli.x + 300.0, psi=es.heli.psi + 0.4))
    host = map_tensors(lambda x: x.cpu(), es)
    for make in (lambda: NativeRenderer(env, 320, 240), lambda: NumpyTopDownRenderer(env)):
        frames = []
        for state in (es, host):
            r = make()
            frames.append(r.render(state))
            r.close()
        assert frames[0].dtype == np.uint8 and frames[0].ndim == 3
        np.testing.assert_array_equal(frames[0], frames[1])


def _sharded_step_tool():
    """tools/torch_sharded_step.py, which chip_smoke.py's phase 9 runs."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "torch_sharded_step.py")
    spec = importlib.util.spec_from_file_location("torch_sharded_step", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


SHARDED_OPTS = {"num_envs": 1024, "rollout_steps": 16, "cpu": False, "same_card": True,
                "save": None}


@pytest.mark.cuda
def test_sharded_train_step_nccl_one_rank(tmp_path):
    """A hover4k stage-1 train step (1024 envs x 16 steps, the checkpoint's
    network and Adam state) on one NCCL rank of an env mesh against the
    learner without a mesh: the rollout's discrete streams equal, its
    floats, the parameters and moments, metrics, farm_metrics and generator
    as `tools/torch_sharded_step.py` holds them; the step kernel ran."""
    _need_card()
    tool = _sharded_step_tool()
    base = tool.step_results(torch.device("cuda", 0), SHARDED_OPTS, None)
    one = tool.run_rank(0, 1, {**SHARDED_OPTS, "backend": "nccl",
                               "address": f"localhost:{tool.free_port()}"}, str(tmp_path))
    rep, fails = tool.compare(base, [one], "NCCL, 1 rank")
    assert not fails, fails
    assert rep["discrete_equal"] and int(one["launches"]) > 0


@pytest.mark.cuda
def test_sharded_train_step_gloo_two_ranks_one_card(tmp_path):
    """The same step on two gloo ranks spawned on one card (512 envs each)
    against one process without a mesh, and the 2-rank save restored in one
    process bit-equal to the ranks' farms and parameters."""
    _need_card()
    tool = _sharded_step_tool()
    base = tool.step_results(torch.device("cuda", 0), SHARDED_OPTS, None)
    save = str(tmp_path / "sharded.npz")
    two = tool.run_ranks(2, {**SHARDED_OPTS, "backend": "gloo", "save": save,
                             "address": f"localhost:{tool.free_port()}"}, str(tmp_path))
    rep, fails = tool.compare(base, two, "gloo, 2 ranks")
    assert not fails, fails
    assert tool.check_save(save, two, torch.device("cuda", 0))
    assert all(int(r["launches"]) > 0 for r in two)


@pytest.mark.cuda
def test_launches_on_a_card_that_is_not_current():
    """With cuda:0 current, the gathers, a one-step launch and the graphed
    collector on tensors of every other card run there: each gather equal
    to `gather_plain`, the step to `fused_step_plain`, the graph replay to
    the eager loop. Needs two cards."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    for k in range(1, torch.cuda.device_count()):
        torch.cuda.set_device(0)
        dev = torch.device("cuda", k)
        x = torch.randn(1024, 1024, device=dev)
        idx = torch.randint(0, 1024, (1024, 1024), device=dev, dtype=torch.int32)
        for axis, fn in ((0, gather.gather_axis0), (1, gather.gather_axis1)):
            assert torch.equal(fn(x, idx), gather.gather_plain(x, idx, axis)), (k, axis)
        env = HeliEnv.build("aw109", task=HoverTask(), device=dev)
        es, _ = VectorHeliEnv(env, 256).reset()
        carry, init = fs.pack(es)
        act = env.trim_result().action.to(dev).expand(256, 4).contiguous()
        eta = torch.randn(3, 256, device=dev) * 7.0
        got, want = fs.fused_step(env, carry, init, act, eta), \
            fs.fused_step_plain(env, carry, init, act, eta)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
        learner = PPOLearner(env, PPOConfig(num_envs=512, rollout_steps=8, hidden=(64, 64)))
        ts = learner.init(torch.Generator().manual_seed(0))
        _, graphed = learner.collect(ts, torch.Generator(device=dev).manual_seed(1),
                                     graphed=True)
        _, eager = learner.collect(ts, torch.Generator(device=dev).manual_seed(1),
                                   graphed=False)
        for f in ("obs", "action", "reward", "terminated"):
            assert torch.equal(getattr(graphed, f), getattr(eager, f)), (k, f)
        assert torch.cuda.current_device() == 0


@pytest.fixture(scope="module")
def winged_airframe(tmp_path_factory):
    """aw109_wing (tests/torch_airframes.py) registered for the module's run."""
    from heligym_tpu_torch.models import register_model_path, registry
    d = tmp_path_factory.mktemp("airframes")
    write_winged(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "_SEARCH_PATHS", list(registry._SEARCH_PATHS))
        register_model_path(str(d))
        yield WINGED


def _nan_bits_equal(a, b):
    """Every value's bits equal, a NaN facing a NaN counting equal."""
    a, b = a.contiguous(), b.contiguous()
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("auto_reset", [True, False])
def test_winged_kernel_equals_plain(winged_airframe, auto_reset, monkeypatch):
    """The kernels' winged instantiation against the plain version, bit for
    bit (a NaN facing a NaN counts equal), at every block size the kernel
    takes: one-step launches stepping their own carry and one T-step launch,
    from the winged hover trim for 30 nominal steps and a 300-step dive."""
    _need_card()
    env = HeliEnv.build(winged_airframe, task=HoverTask())
    assert fs.has_wing(env)
    tr = env.trim_result()
    n = 1000                    # not a multiple of a block: the ragged tail
    es, _ = VectorHeliEnv(env, n).reset_from_trim(tr)
    for steps, dive in ((30, False), (300, True)):
        act, eta = _card_inputs(tr, steps, n, dive, seed=5)
        carry, init = fs.pack(es)
        cp, xp = carry.clone(), []
        with torch.no_grad():
            for t in range(steps):
                cp, x = fs.fused_step_plain(env, cp, init, act[t], eta[t], auto_reset)
                xp.append(x)
        xp = torch.stack(xp)
        assert bool(xp[:, fs.CDONE].any()) == dive
        for block in (32, 64, 128):
            monkeypatch.setattr(fs, "BLOCK", block)
            ck, xk = carry.clone(), []
            for t in range(steps):
                ck, x = fs.fused_step(env, ck, init, act[t], eta[t], auto_reset)
                xk.append(x)
            cr, xr = fs.fused_rollout(env, carry, init, act, eta, auto_reset)
            torch.cuda.synchronize()
            assert _nan_bits_equal(torch.stack(xk), xp), (steps, block)
            assert _nan_bits_equal(ck, cp), (steps, block)
            assert _nan_bits_equal(xr, xp) and _nan_bits_equal(cr, cp), (steps, block)


@pytest.mark.cuda
def test_winged_graphed_collector_equals_eager(winged_airframe):
    """PPOLearner.collect on the winged airframe: the graph replay (the
    winged one-step launch captured) equals the eager loop bit for bit over
    two rollouts, and counts its steps."""
    _need_card()
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    env = HeliEnv.build(winged_airframe, task=HoverTask())
    n, steps = 512, 16
    learner = PPOLearner(env, PPOConfig(num_envs=n, rollout_steps=steps))
    ts0 = learner.init(torch.Generator().manual_seed(0))
    outs = {}
    for graphed in (True, False):
        gen = torch.Generator(device="cuda").manual_seed(3)
        before = fs.launches
        ts, trajs = ts0, []
        for _ in range(2):
            ts, tr = learner.collect(ts, gen, graphed=graphed)
            trajs.append(tr)
        torch.cuda.synchronize()
        assert fs.launches == before + 2 * steps + int(graphed)
        outs[graphed] = (fs.pack(ts.env_state)[0], trajs, gen.get_state())
    assert _bits_equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][2], outs[False][2])
    for tg, te in zip(outs[True][1], outs[False][1]):
        for f in ("obs", "action", "log_prob", "value", "reward", "terminated",
                  "truncated", "v_boot", "failed", "succ_step"):
            assert _bits_equal(getattr(tg, f), getattr(te, f)), f


@pytest.mark.cuda
def test_pytree_checkpoints_of_a_card_farm(tmp_path):
    """A farm on the card stepped 5 times, saved with `save_pytree` and with
    `save_npz`, restored against itself as the template: every leaf on the
    card and bit-equal, and one more step from each equal to the original's."""
    _need_card()
    from heligym_tpu_torch.utils import checkpoint as ckpt
    env = HeliEnv.build("aw109", task=HoverTask())
    venv = VectorHeliEnv(env, 256)
    tr = env.trim_result()
    es, _ = venv.reset_from_trim(tr)
    act = tr.action.cuda().expand(256, 4).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(5):
        es, _ = venv.step(es, act, gen)
    ckpt.save_pytree(str(tmp_path / "farm.pt"), es)
    ckpt.save_npz(str(tmp_path / "farm.npz"), es)
    eta = torch.randn(256, 3, device="cuda", generator=gen)
    _, want = venv.step_with_eta(es, act, eta)
    for restored in (ckpt.restore_pytree(str(tmp_path / "farm.pt"), es),
                     ckpt.load_npz(str(tmp_path / "farm.npz"), es)):
        assert restored.obs.device.type == "cuda"
        assert _bits_equal(fs.pack(restored)[0], fs.pack(es)[0])
        assert torch.equal(restored.steps, es.steps)
        _, got = venv.step_with_eta(restored, act, eta)
        assert _bits_equal(got.obs, want.obs) and _bits_equal(got.reward, want.reward)


@pytest.mark.cuda
def test_trace_lists_the_step_kernel(tmp_path):
    """`trace` on the card: the Chrome trace it writes names the step
    kernel, and its profile holds the kernel's device time."""
    _need_card()
    import glob
    from heligym_tpu_torch.utils.profiling import trace
    env = HeliEnv.build("aw109", task=HoverTask())
    es, _ = VectorHeliEnv(env, 256).reset_from_trim(env.trim_result())
    carry, init = fs.pack(es)
    act = env.trim_result().action.cuda().expand(256, 4).contiguous()
    with trace(str(tmp_path)) as prof:
        for _ in range(3):
            carry, _ = fs.fused_step(env, carry, init, act, torch.zeros(3, 256, device="cuda"))
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        assert "fused_step_kernel" in f.read()
    assert any("fused_step_kernel" in ev.key for ev in prof.key_averages())
