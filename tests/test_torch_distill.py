"""The port's distillation path (heligym_tpu_torch.learner.scripted and
.distill) against the JAX package, on the CPU.

The scripted law and its trim go through both packages on the same numpy
observations; the collector rolls a tiny landing farm (8 envs, 20 steps, a
0.36 s episode wall so that the envs started low succeed and the others time
out) from JAX's own `reset_randomized` farm, with the action noise and the
Dryden noise JAX draws from its keys injected into the port's seams; the BC
fitter takes JAX's permutations; the distillation tools' own expressions
(the hybrid's expert blend, the multitask student's pooled obs stats, the
scripted tool's weights and its non-finite masking) go through the port's
functions and the JAX tools' expressions on the same inputs. Each check
states its tolerance.

The file collects two tests, the collector and everything else, each
running all of its checks before it reports every one that failed: a file
of at most two tests is handed out after every long file of the JAX
package under `--dist loadfile` (xdist orders files by their test count),
so it cannot delay one of them."""
import dataclasses
import importlib.util
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heligym_tpu.envs import HeliEnv as JHeliEnv
from heligym_tpu.envs import MixedTask as JMixedTask
from heligym_tpu.envs import VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.learner import PPOConfig as JPPOConfig
from heligym_tpu.learner import PPOLearner as JPPOLearner
from heligym_tpu.learner import distill as jdistill
from heligym_tpu.learner import scripted as jscripted
from heligym_tpu.learner.ppo import TrainState as JTrainState
from heligym_tpu.learner.train import _parse_target as jparse_target
from heligym_tpu.learner.train import make_alt_grid_sampler as jgrid_sampler
from heligym_tpu.parallel import make_env_mesh

from heligym_tpu_torch.convert import env_state_from_numpy, policy_to_numpy
from heligym_tpu_torch.envs import HeliEnv, LandingTask, MixedTask
from heligym_tpu_torch.envs import tasks as ttasks
from heligym_tpu_torch.learner import PPOConfig, PPOLearner, TrainState
from heligym_tpu_torch.learner import distill as tdistill
from heligym_tpu_torch.learner import scripted as tscripted
from heligym_tpu_torch.learner.train import _parse_target

from test_torch_learner import flax_params
from test_torch_ppo import assert_tree_close, flax_to_numpy, stats_pair
from test_torch_tasks import jax_state_to_numpy
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, HIDDEN = 8, 20, (16, 16)
MAX_TIME = 0.36          # 18 steps to the time limit, 5 settled steps to succeed
TARGET = "touch_alt=ground+8"   # the envs started below ~15 ft are settled
BAND = (6.0, 20.0)
# the JAX package's own test scale (tests/test_scripted.py), where ~40% of the
# residual components clip
OBS_SCALE = np.asarray([500, 15, 15, 5, 10, 10, 5, 0.2, 0.2, 0.5, 0.3, 0.3, 0.3,
                        30, 30, 1700, 50], np.float32)


def landing_envs():
    """(JAX env, port env): landing at the gear-contact altitude + 8 ft."""
    jenv = JHeliEnv.build("aw109", task=jtasks.LandingTask())
    jenv = jenv.replace(task=jenv.task.with_target(**jparse_target(TARGET, jenv)),
                        max_time=MAX_TIME)
    env = HeliEnv.build("aw109", task=LandingTask(), device="cpu")
    env = env.replace(task=env.task.with_target(**_parse_target(TARGET, env)),
                      max_time=MAX_TIME)
    return jenv, env


@pytest.fixture(scope="module")
def learners():
    """(JAX learner, port learner) on the tiny landing env, the port's
    act_bias set to JAX's (the two host trims differ by ~2e-6: the
    trim is held to JAX's in test_scripted_policy_matches_jax)."""
    jenv, env = landing_envs()
    jl = JPPOLearner(jenv, JPPOConfig(num_envs=N, hidden=HIDDEN),
                     mesh=make_env_mesh(jax.devices()[:1]))
    tl = PPOLearner(env, PPOConfig(num_envs=N, hidden=HIDDEN))
    tl.act_bias = torch.from_numpy(np.asarray(jl.act_bias).copy())
    return jl, tl


# -- the scripted law -----------------------------------------------------------

def check_approach_gains_equal_jax(learners):
    """Every field, in order, with its default; frozen as JAX's."""
    ours = [(f.name, f.default) for f in dataclasses.fields(tscripted.ApproachGains)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jscripted.ApproachGains)]
    assert ours == theirs and len(ours) == 32
    with pytest.raises(dataclasses.FrozenInstanceError):
        tscripted.ApproachGains().k_w = 1.0


def check_landing_residual_matches_jax(learners, case):
    """`landing_residual` on 4096 observations, port against the jitted JAX
    law: max abs difference <= 1e-6 (XLA on the CPU contracts a*b+c into
    FMAs; measured 6.0e-8 around the trim, 2.1e-7 clipping). `around_trim`: the trim obs
    perturbed by 5% of the JAX test's scale, psi spread over 2 turns
    (exercising the yaw wrap; the pedal clips at large heading errors),
    altitudes across the gear band and gate zone; `clipping`: the JAX
    test's scale, where most components clip."""
    jl, _ = learners
    tr = jl.env.trim_result()
    trim_att = (float(tr.state.phi), float(tr.state.theta), float(tr.state.psi))
    rng = np.random.default_rng(0 if case == "around_trim" else 1)
    base = np.asarray(tr.obs, np.float32)
    spread = 0.05 if case == "around_trim" else 1.0
    obs = (base + rng.standard_normal((4096, 17)) * OBS_SCALE * spread).astype(np.float32)
    obs[:, 9] = rng.uniform(-4 * np.pi, 4 * np.pi, 4096)
    obs[:, 16] = rng.uniform(0.0, 30.0, 4096)
    g = jscripted.ApproachGains()
    want = np.asarray(jax.jit(lambda o: jscripted.landing_residual(o, g, trim_att))(obs))
    got = tscripted.landing_residual(torch.from_numpy(obs), tscripted.ApproachGains(),
                                     trim_att).numpy()
    assert got.shape == (4096, 4) and got.dtype == np.float32
    clipped = float(np.mean(np.abs(want) == g.resid_max))
    assert (clipped < 0.25) if case == "around_trim" else (clipped > 0.3), clipped
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # any leading shape: (2, 2048, 17) gives the same rows
    got2 = tscripted.landing_residual(torch.from_numpy(obs).reshape(2, 2048, 17),
                                      tscripted.ApproachGains(), trim_att)
    np.testing.assert_array_equal(got2.reshape(4096, 4).numpy(), got)


def check_scripted_policy_matches_jax(learners):
    """`make_scripted_policy` on the landing env: act_bias and the trim
    attitude within 1e-5 of JAX's (the two host Newton trims stop at their
    own last iterate); act_bias float32 on the env's device; at the trim
    obs the residual equals JAX's within 1e-6 and is the profile's
    collective command, with the cyclics near zero."""
    jl, tl = learners
    j_bias, j_att, j_fn = jscripted.make_scripted_policy(jl.env)
    t_bias, t_att, t_fn = tscripted.make_scripted_policy(tl.env)
    assert t_bias.dtype == torch.float32 and t_bias.device == tl.env.device
    assert all(isinstance(a, float) for a in t_att)
    np.testing.assert_allclose(t_bias.numpy(), np.asarray(j_bias), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_att, j_att, rtol=0, atol=1e-5)
    obs = np.asarray(jl.env.trim_result().obs, np.float32)
    got = t_fn(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_fn(jnp.asarray(obs))), rtol=0, atol=1e-6)
    assert abs(got[1]) < 0.02 and abs(got[2]) < 0.02 and got[0] != 0.0


# -- the collector ----------------------------------------------------------------

def jax_noise(es0, k_act, jenv):
    """The action noise (T, B, 4) and the Dryden noise (T, 3, B) that JAX's
    collector draws: its scan splits `k_act` once per step, and each env's
    `env.step` splits its own key."""
    k, noise = k_act, []
    for _ in range(STEPS):
        k, k_t = jax.random.split(k)
        noise.append(jax.random.normal(k_t, (N, 4)))
    keys, eta = es0.key, []
    for _ in range(STEPS):
        pairs = jax.vmap(jax.random.split)(keys)
        keys = pairs[:, 0]
        eta.append(jax.vmap(lambda kk: jax.random.normal(kk, (3,), jnp.float32))(
            pairs[:, 1]).T * (1.0 / jenv.dt) ** 0.5)
    return (np.asarray(jnp.stack(noise)), np.ascontiguousarray(np.asarray(jnp.stack(eta))))


def test_collector_matches_jax(learners, capsys, monkeypatch):
    """`make_collector` against JAX's on 8 envs of the 6-20 ft grid for 20
    steps, the sampling log-std capped at -3 (`std_cap`): obs at the fused
    contract (rtol 1e-4, atol 2e-3), resid at atol 2e-5, the weights and
    the success fraction exactly equal, with some episodes succeeding and
    some timing out."""
    jl, tl = learners
    net = tl.make_network(torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.mean.weight.mul_(5.0)      # actions that visibly depend on the obs
    js, ts_stats = stats_pair(2)
    jts = JTrainState(params=flax_params(net), opt_state=None, env_state=None,
                      key=None, update_count=0, obs_stats=js)
    key = jax.random.PRNGKey(3)
    jenv = jl.env
    req, up = jenv.success_steps_required, jenv.time_up_steps
    farms, reset = [], JVectorHeliEnv.reset_randomized

    def preset_reset(*args):
        """JAX's farm (kept: its batched trim costs ~15 s) with lane 1 three
        steps from its time limit with 3 settled steps to go, and lane 2
        one settled step short of success: lane 1 times out on the step its
        counter reaches the requirement, which the env does not count as
        success (the counter is read before the step)."""
        es, obs = reset(*args)
        es = es.replace(steps=es.steps.at[1].set(up - 3),
                        successed_steps=es.successed_steps.at[1].set(req - 3)
                        .at[2].set(req - 1))
        farms.append((es, obs))
        return es, obs
    monkeypatch.setattr(JVectorHeliEnv, "reset_randomized", preset_reset)
    jobs, jresid, jw, jsucc = jdistill.make_collector(
        jl.env, jl, episodes=N, steps=STEPS, cond_sampler=jgrid_sampler(*BAND))(
        jts, key, std_cap=-3.0)
    (es0, _), = farms
    noise, eta = jax_noise(es0, jax.random.split(key)[1], jenv)
    tts = TrainState(params=net, env_state=None, update_count=0, obs_stats=ts_stats)
    capsys.readouterr()
    obs, resid, w, succ = tdistill.make_collector(
        tl.env, tl, episodes=N, steps=STEPS, cond_sampler=None)(
        tts, None, std_cap=-3.0,
        start=env_state_from_numpy(jax_state_to_numpy(es0), "cpu"),
        noise=torch.from_numpy(noise), eta_seq=torch.from_numpy(eta))
    assert capsys.readouterr().out == "  sampling log_std = [-3. -3. -3. -3.]\n"
    assert obs.shape == (STEPS, N, 17) and resid.shape == (STEPS, N, 4)
    assert w.shape == (STEPS, N) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert succ == float(jsucc)
    assert 0.0 < succ < 1.0, succ
    # success fires on the step after the counter reaches the requirement:
    # step 5 from the grid's trims, step 1 in lane 2; lane 1 timed out
    weighted = w.numpy().sum(0)
    assert weighted[1] == 0.0 and weighted[2] == 2.0, weighted
    assert set(weighted[weighted > 0]) == {2.0, req + 1.0}, weighted
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(resid.numpy(), np.asarray(jresid), rtol=0, atol=2e-5)
    # the residual is the executed action less the bias, inside the clip
    assert float((resid + tl.act_bias).abs().max()) <= 1.0
    # the one-shot wrapper draws its own farm (the default trim) and noise
    obs1, _, w1, _ = tdistill.collect_successful(
        tl.env, tl, tts, episodes=2, steps=3, generator=torch.Generator().manual_seed(0),
        cond_sampler=None, log_std_override=-4.0)
    assert obs1.shape == (3, 2, 17) and w1.shape == (3, 2)


# -- the BC fitter ------------------------------------------------------------------

class _JaxStudentView:
    """JAX's duck-typed adapter of a MixedTask student for `make_bc_fitter`
    (`tools/distill_multitask.py::_StudentView`): obs rows carry the task
    one-hot after the 17 observations."""

    def __init__(self, student):
        self.student, self.network = student, self
        self.config, self._actor_keys = student.config, student._actor_keys

    def apply(self, params, x):
        return self.student.network.apply(params, x)

    def _net_in(self, obs_aug, stats, task_oh=None):
        return self.student._net_in(obs_aug[..., :17], stats, obs_aug[..., 17:])


def check_bc_fitter_matches_jax(learners, case):
    """2 epochs of `make_bc_fitter` from equal parameters with JAX's
    permutations injected: the parameters at rtol 1e-5, atol 2e-6 and the
    last epoch's mean loss at rtol 1e-5 (test_torch_ppo's tolerances for
    one update); the critic and log_std bit-equal to the input, the input
    network unchanged. `remainder`: 64 rows in minibatches of 24 (16 rows
    dropped per epoch); `below_minibatch`: minibatch 1000 > 64 rows (one
    minibatch of 64, through the one-shot `bc_fit`); `task_oh`: a 2-task
    MixedTask student with a per-row one-hot, against JAX's adapter of
    `tools/distill_multitask.py`."""
    jl, tl = learners
    if case == "task_oh":
        tasks = (jtasks.HoverTask(), jtasks.LandingTask())
        jl = JPPOLearner(jl.env.replace(task=JMixedTask(tasks=tasks)),
                         JPPOConfig(num_envs=N, hidden=HIDDEN),
                         mesh=make_env_mesh(jax.devices()[:1]))
        tl = PPOLearner(tl.env.replace(task=MixedTask(
            tasks=(ttasks.HoverTask(), ttasks.LandingTask()))),
            PPOConfig(num_envs=N, hidden=HIDDEN))
    T, B = 4, 16
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((T, B, 17)).astype(np.float32) * OBS_SCALE * 0.1
    resid = (rng.standard_normal((T, B, 4)) * 0.1).astype(np.float32)
    w = (rng.random((T, B)) < 0.7).astype(np.float32) * rng.uniform(0.5, 2.0, (T, B))
    w = w.astype(np.float32)
    oh = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]
    minibatch = 1000 if case == "below_minibatch" else 24
    lr, epochs = 1e-3, 2
    net = tl.make_network(torch.Generator().manual_seed(6))
    js, ts_stats = stats_pair(7)
    jts = JTrainState(params=flax_params(net), opt_state=None, env_state=None,
                      key=None, update_count=0, obs_stats=js)
    key = jax.random.PRNGKey(8)
    if case == "task_oh":
        jfit = jdistill.make_bc_fitter(_JaxStudentView(jl), lr=lr, minibatch=minibatch)
        jts2, jloss = jfit(jts, jnp.asarray(np.concatenate([obs, oh], -1)),
                           jnp.asarray(resid), jnp.asarray(w), epochs=epochs, key=key)
    else:
        jts2, jloss = jdistill.make_bc_fitter(jl, lr=lr, minibatch=minibatch)(
            jts, jnp.asarray(obs), jnp.asarray(resid), jnp.asarray(w),
            epochs=epochs, key=key)
    perms, k = [], key
    for _ in range(epochs):
        k, k_e = jax.random.split(k)
        perms.append(torch.from_numpy(np.asarray(jax.random.permutation(k_e, T * B)).copy()))

    before = policy_to_numpy(net)
    tts = TrainState(params=net, env_state=None, update_count=0, obs_stats=ts_stats)
    data = [torch.from_numpy(a) for a in (obs, resid, w)]
    if case == "below_minibatch":
        # one minibatch of every row: its order changes only the summation
        # order, so the one-shot wrapper's own permutations will do
        tts2, loss = tdistill.bc_fit(tl, tts, *data, epochs=epochs, lr=lr,
                                     minibatch=minibatch,
                                     generator=torch.Generator().manual_seed(0))
    else:
        tts2, loss = tdistill.make_bc_fitter(tl, lr=lr, minibatch=minibatch)(
            tts, *data, epochs=epochs, perms=perms,
            task_oh=torch.from_numpy(oh) if case == "task_oh" else None)
    after = policy_to_numpy(tts2.params)
    assert_tree_close(after, flax_to_numpy(jts2.params["params"]), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert tts.params is net and tts2.params is not net
    for name, leaf in before.items():
        same = jax.tree_util.tree_leaves(policy_to_numpy(net)[name])
        for x, y in zip(same, jax.tree_util.tree_leaves(leaf)):
            np.testing.assert_array_equal(x, y, err_msg=f"input {name}")
        moved = [not np.array_equal(x, y) for x, y in
                 zip(jax.tree_util.tree_leaves(after[name]), jax.tree_util.tree_leaves(leaf))]
        if name in net.actor_flax_names() - {"log_std"}:
            assert any(moved), name
        else:                       # the critic towers, the value head, log_std
            assert not any(moved), name


# -- the distillation tools' own expressions ------------------------------------------

def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def obs_around_trim(jl, rows, seed, agl):
    """`rows` observations around the trim (5% of the JAX test's scale),
    the altitude above ground uniform over `agl`."""
    rng = np.random.default_rng(seed)
    base = np.asarray(jl.env.trim_result().obs, np.float32)
    obs = (base + rng.standard_normal((rows, 17)) * OBS_SCALE * 0.05).astype(np.float32)
    obs[:, 16] = rng.uniform(*agl, rows)
    return obs


def check_hybrid_blend_matches_jax(learners):
    """`torch_distill_hybrid.blend_label` against the expression of
    `tools/distill_hybrid.py` (its scan's label) through the JAX network, on
    2048 observations from 0 to 80 ft AGL about the 34 ft switch (width 6),
    with two different experts, each under its own obs stats: max abs
    difference <= 1e-6. The blend spans both experts, so a flipped
    sigmoid or swapped stats would show."""
    jl, tl = learners
    nets = [tl.make_network(torch.Generator().manual_seed(s)) for s in (11, 12)]
    with torch.no_grad():
        for net in nets:
            net.mean.weight.mul_(5.0)
    (js_l, ts_l), (js_d, ts_d) = stats_pair(13), stats_pair(14)
    obs = obs_around_trim(jl, 2048, 15, (0.0, 80.0))
    switch, width = 34.0, 6.0
    m_l, _, _ = jl.network.apply(flax_params(nets[0]), jl._norm(obs, js_l))
    m_d, _, _ = jl.network.apply(flax_params(nets[1]), jl._norm(obs, js_d))
    w = jax.nn.sigmoid((obs[..., 16] - switch) / width)[..., None]
    want = np.asarray(w * m_d + (1.0 - w) * m_l)
    with torch.no_grad():
        got = load_tool("torch_distill_hybrid").blend_label(
            torch.from_numpy(obs), tl, nets[0], ts_l, tl, nets[1], ts_d, switch, width)
    assert got.shape == (2048, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    lo, hi = obs[:, 16] < 10.0, obs[:, 16] > 60.0
    gap = np.abs(np.asarray(m_d) - np.asarray(m_l))
    assert gap.max() > 0.01, gap.max()
    np.testing.assert_allclose(want[lo], np.asarray(m_l)[lo], atol=0.02 * gap.max())
    np.testing.assert_allclose(want[hi], np.asarray(m_d)[hi], atol=0.02 * gap.max())


def check_pooled_stats_match_jax(learners):
    """`torch_distill_multitask.pooled_obs_stats` against the expression of
    `tools/distill_multitask.py` (numpy, float32) on 4096 observation rows,
    a tenth of them far outside the +-50 clip of the scaled obs: the mean
    at rtol 1e-6 (atol 1e-6 for means near 0); the variance within 1e-6 of
    the float64 variance and at rtol 2e-5 of the JAX tool's float32 numpy
    one, which its float32 sums leave up to ~1.6e-5 off the float64 value
    (measured 7.5e-6 from the port here); the count 5e6."""
    jl, tl = learners
    obs = obs_around_trim(jl, 4096, 16, (0.0, 100.0))
    obs[::10] *= 200.0
    scaled = np.clip(obs / np.asarray(jl._scales), -50.0, 50.0)
    assert (np.abs(scaled) == 50.0).any()
    got = load_tool("torch_distill_multitask").pooled_obs_stats(
        torch.from_numpy(obs), tl._scales)
    np.testing.assert_allclose(got.mean.numpy(), scaled.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), scaled.var(0) + 1e-6, rtol=2e-5)
    np.testing.assert_allclose(got.var.numpy(), scaled.astype(np.float64).var(0) + 1e-6,
                               rtol=1e-6)
    assert got.count.dtype == torch.float32 and float(got.count) == 5e6


def check_scripted_weights_match_jax(learners, act_with_student):
    """`torch_distill_scripted.labelled_dataset` (the weights of a BC or
    DAgger round and `distill.mask_non_finite`) against the expressions of
    `tools/distill_scripted.py`'s collector on 40 steps x 16 envs with
    non-finite observations and labels injected: every value equal."""
    rng = np.random.default_rng(17)
    T, B = 40, 16
    obs = rng.standard_normal((T, B, 17)).astype(np.float32)
    label = rng.standard_normal((T, B, 4)).astype(np.float32)
    for arr, bad in ((obs, np.nan), (obs, np.inf), (label, -np.inf), (label, np.nan)):
        idx = rng.integers(0, T, 8), rng.integers(0, B, 8), rng.integers(0, arr.shape[-1], 8)
        arr[idx] = bad
    alive = np.arange(T)[:, None] <= rng.integers(0, T, B)[None, :]
    succ = rng.random(B) < 0.5
    w = alive if act_with_student else alive & succ[None, :]
    finite = jnp.all(jnp.isfinite(obs), axis=-1) & jnp.all(jnp.isfinite(label), axis=-1)
    want = (np.asarray(jnp.nan_to_num(obs, nan=0.0, posinf=0.0, neginf=0.0)),
            np.asarray(jnp.nan_to_num(label, nan=0.0, posinf=0.0, neginf=0.0)),
            np.asarray((w & finite).astype(jnp.float32)))
    got = load_tool("torch_distill_scripted").labelled_dataset(
        *(torch.from_numpy(a) for a in (obs, label, alive, succ)), act_with_student)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), wnt)
    assert 0 < want[2].sum() < (alive if act_with_student else alive & succ).sum()


# -- the two collected tests -----------------------------------------------------------

def run_checks(checks):
    """Run every check, then fail with each one that failed."""
    failed = []
    for name, check in checks:
        try:
            check()
        except Exception:   # noqa: BLE001 - reported below, with its traceback
            failed.append(f"{name}:\n{traceback.format_exc()}")
    assert not failed, f"{len(failed)} of {len(checks)} checks failed:\n" + "\n".join(failed)


def test_scripted_law_fitter_and_tools_match_jax(learners):
    """Every check of this file but the collector's, each with its own
    tolerance (see each check)."""
    checks = [("approach_gains", lambda: check_approach_gains_equal_jax(learners))]
    checks += [(f"landing_residual[{c}]", lambda c=c: check_landing_residual_matches_jax(
        learners, c)) for c in ("around_trim", "clipping")]
    checks += [("scripted_policy", lambda: check_scripted_policy_matches_jax(learners))]
    checks += [(f"bc_fitter[{c}]", lambda c=c: check_bc_fitter_matches_jax(learners, c))
               for c in ("remainder", "below_minibatch", "task_oh")]
    checks += [("hybrid_blend", lambda: check_hybrid_blend_matches_jax(learners)),
               ("pooled_stats", lambda: check_pooled_stats_match_jax(learners))]
    checks += [(f"scripted_weights[{m}]", lambda m=m: check_scripted_weights_match_jax(
        learners, m == "dagger")) for m in ("bc", "dagger")]
    run_checks(checks)
