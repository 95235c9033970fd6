"""The port's PPO update and training loop (heligym_tpu_torch.learner.ppo,
.optim, the checkpoint writer) against the JAX package, on the CPU.

Tiny shapes: hidden (16, 16), T = 8 steps, B = 16 envs, 4 minibatches. The
same numpy inputs, made from a seed, go through the JAX function and the
port's; each test states its tolerance. Float32 sums and matmuls in another
order differ by ulps, which the tolerances absorb; discrete decisions (the KL
stop, the clip) must be the same. JAX draws the epoch's shuffle from its
key, the port from a torch generator: the tests hand the port JAX's draw."""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.envs.env import EnvState as JEnvState
from heligym_tpu.envs.env import ResetSnapshot as JResetSnapshot
from heligym_tpu.learner import PPOConfig as JPPOConfig
from heligym_tpu.learner import PPOLearner as JPPOLearner
from heligym_tpu.learner.ppo import ObsStats as JObsStats
from heligym_tpu.learner.ppo import TrainState as JTrainState
from heligym_tpu.learner.ppo import Transition as JTransition
from heligym_tpu.ops.state import HELI_STATE_FIELDS as JHELI_FIELDS
from heligym_tpu.ops.state import WIND_STATE_FIELDS as JWIND_FIELDS
from heligym_tpu.ops.state import HeliState as JHeliState
from heligym_tpu.ops.state import WindState as JWindState
from heligym_tpu.parallel import make_env_mesh
from heligym_tpu.utils import checkpoint as jckpt

from heligym_tpu_torch.convert import (adam_state_to_numpy, env_state_to_numpy,
                                       flax_tree_of, policy_to_numpy)
from heligym_tpu_torch.envs import HeliEnv, HoverTask, LandingTask, MixedTask
from heligym_tpu_torch.learner import ObsStats, PPOConfig, PPOLearner, Transition
from heligym_tpu_torch.learner import optim

from test_torch_learner import flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, HIDDEN, MB = 8, 16, (16, 16), 4
CFG = dict(num_envs=B, rollout_steps=T, minibatches=MB, hidden=HIDDEN)


@pytest.fixture(scope="module")
def learners(hover_env):
    """(JAX learner, port learner) on hover at the tiny config."""
    jl = JPPOLearner(hover_env, JPPOConfig(**CFG), mesh=make_env_mesh(jax.devices()[:1]))
    tl = PPOLearner(HeliEnv.build("aw109", task=HoverTask(), device="cpu"),
                    PPOConfig(**CFG))
    return jl, tl


def with_config(jl, tl, **kw):
    """Copies of both learners under a changed config (same network)."""
    jl2, tl2 = copy.copy(jl), copy.copy(tl)
    jl2.config = dataclasses.replace(jl.config, **kw)
    tl2.config = dataclasses.replace(tl.config, **kw)
    return jl2, tl2


def rollout_arrays(seed, task_dim=0):
    """A random rollout (T, B) as numpy: plausible obs, raw actions, and
    termination/truncation flags, with a NaN v_boot at terminated steps
    (a blown-up env's bootstrap)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, 17)).astype(np.float32)
    obs[..., 3:7] *= 20.0                                   # velocities [ft/s]
    obs[..., 13:15] *= 300.0                                # positions [ft]
    obs[..., 16] = rng.uniform(0.0, 120.0, (T, B))          # altitude above ground
    term = (rng.random((T, B)) < 0.08).astype(np.float32)
    trunc = ((rng.random((T, B)) < 0.08) & (term == 0)).astype(np.float32)
    failed = term * (rng.random((T, B)) < 0.5)
    v_boot = rng.standard_normal((T, B)).astype(np.float32) * 5.0
    v_boot[np.nonzero(term)[0][:3], np.nonzero(term)[1][:3]] = np.nan
    assert term.any() and trunc.any() and np.isnan(v_boot).any()
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    task_oh = np.zeros((T, B, task_dim), np.float32)
    return {"obs": obs, "action": f(T, B, 4) * 0.3, "log_prob": f(T, B),
            "value": f(T, B) * 5.0, "reward": f(T, B), "terminated": term,
            "truncated": trunc, "v_boot": v_boot, "failed": failed.astype(np.float32),
            "succ_step": (rng.random((T, B)) < 0.3).astype(np.float32),
            "task_oh": task_oh}


def jtraj(a):
    return JTransition(**{k: jnp.asarray(v) for k, v in a.items()})


def ttraj(a):
    return Transition(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()})


def stats_pair(seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(17).astype(np.float32) * 0.3
    var = rng.uniform(0.5, 2.0, 17).astype(np.float32)
    return (JObsStats(mean=jnp.asarray(mean), var=jnp.asarray(var), count=jnp.float32(3e3)),
            ObsStats(mean=torch.from_numpy(mean), var=torch.from_numpy(var),
                     count=torch.tensor(3e3)))


def flax_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_tree_close(port_tree, jax_tree, **tol):
    """Two flax trees of numpy arrays, leaf by leaf."""
    p = jax.tree_util.tree_leaves_with_path(port_tree)
    j = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert [k for k, _ in p] == [k for k, _ in j]
    for (path, a), (_, b) in zip(p, j):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path),
                                   **tol)


# -- statistics, GAE, loss ----------------------------------------------------

def test_merge_stats_equal_jax(learners):
    """The Chan merge with NaN and +-inf rows in the batch (zeroed out of
    it), values clipped to +-50, the count capped at 5e6: mean, population
    variance and count at rtol 2e-5, atol 1e-6."""
    jl, tl = learners
    rng = np.random.default_rng(0)
    obs = (rng.standard_normal((T, B, 17)) * tl._scales.numpy() * 3).astype(np.float32)
    obs[0, :3, 2] = np.nan
    obs[1, :3, 5] = np.inf
    obs[2, :3, 9] = -np.inf
    obs[3, :3, 0] = 1e30                                   # clipped to 50
    for count in (3e3, 4.99999e6):
        js, ts = stats_pair(1)
        js = js.replace(count=jnp.float32(count))
        ts = dataclasses.replace(ts, count=torch.tensor(count, dtype=torch.float32))
        want = jl._merge_stats(js, jnp.asarray(obs))
        got = tl._merge_stats(ts, torch.from_numpy(obs))
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=2e-5, atol=1e-6, err_msg=k)
        assert bool(torch.isfinite(got.var).all())
    assert float(got.count) == 5e6


SHAPED = dict(agl_shaping=0.3, flare_shaping=0.2, prof_shaping=0.1, vel_shaping=0.05,
              track_shaping=0.01, vel_target_n=10.0, vel_target_e=-5.0)


@pytest.mark.parametrize("case", ["plain", "bonus_penalty", "all_potentials"])
def test_gae_equal_jax(learners, case):
    """GAE over a rollout with terminations (a NaN v_boot among them: it
    must not poison the recursion) and truncations (bootstrapped, the
    accumulation cut): no shaping; success bonus and fail penalty; those
    and all five potentials together. Advantages and returns at rtol 1e-5,
    atol 2e-5, all finite."""
    kw = {"plain": {}, "bonus_penalty": dict(success_bonus=1.0, fail_penalty=5.0),
          "all_potentials": dict(success_bonus=1.0, fail_penalty=5.0, **SHAPED)}[case]
    jl, tl = with_config(*learners, **kw)
    a = rollout_arrays(2)
    jadv, jret = jax.jit(jl._gae)(jtraj(a))
    adv, ret = tl._gae(ttraj(a))
    assert bool(torch.isfinite(adv).all())
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=2e-5)
    if case == "all_potentials":   # the shaping moved the advantages
        base, _ = with_config(*learners, success_bonus=1.0, fail_penalty=5.0)[1]._gae(ttraj(a))
        assert float((adv - base).abs().max()) > 1e-2


def batch_for(tl, net, seed, stats):
    """A rollout whose log-probs and values are the network's own (ratio 1
    at the start), with random advantages and returns."""
    a = rollout_arrays(seed)
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        mean, log_std, value = net(tl._net_in(torch.from_numpy(a["obs"]), stats))
        from heligym_tpu_torch.learner import gaussian_log_prob
        act = mean + torch.exp(log_std) * torch.from_numpy(a["action"])
        a["action"] = act.numpy()
        a["log_prob"] = gaussian_log_prob(mean, log_std, act).numpy()
        a["value"] = value.numpy()
    adv = rng.standard_normal(T * B).astype(np.float32) * 3.0
    ret = (a["value"].reshape(-1) + rng.standard_normal(T * B) * 2.0).astype(np.float32)
    return a, adv, ret


@pytest.mark.parametrize("vf_clip_eps", [0.0, 0.2])
def test_loss_and_grads_equal_jax(learners, vf_clip_eps):
    """The clipped PPO loss, its metrics and its gradient in every
    parameter against `jax.value_and_grad(PPOLearner._loss)`, with a
    log-std ceiling that binds (its gradient into log_std is 0), value
    clipping off and on, and perturbed parameters so that both clips act.
    Loss and metrics at rtol 1e-5, atol 1e-6; gradients at rtol 1e-4, atol
    1e-6."""
    jl, tl = with_config(*learners, vf_clip_eps=vf_clip_eps)
    net = tl.make_network(torch.Generator().manual_seed(3))
    js, ts = stats_pair(4)
    a, adv, ret = batch_for(tl, net, 5, ts)
    with torch.no_grad():                # move the policy off the rollout's
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
    flat = {k: v.reshape((T * B,) + v.shape[2:]) for k, v in a.items()}
    cap, ent = -1.0, 1e-3
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jl._loss, has_aux=True))(
        flax_params(net), jtraj(flat), jnp.asarray(adv), jnp.asarray(ret), js,
        jnp.float32(ent), jnp.float32(cap))
    loss, aux = tl._loss(net, ttraj(flat), torch.from_numpy(adv), torch.from_numpy(ret),
                         ts, ent, torch.tensor(cap))
    grads = torch.autograd.grad(loss, tl.param_list(net))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(aux["approx_kl"]) > 1e-4             # the clip acted
    assert_tree_close(flax_tree_of(net, grads), flax_to_numpy(jgrads["params"]),
                      rtol=1e-4, atol=1e-6)
    assert float(grads[-1].abs().max()) == 0.0        # log_std: the cap binds


# -- the optimizer -----------------------------------------------------------

def test_optimizer_equal_optax():
    """Three steps of clip_by_global_norm(0.5) + scale_by_adam + the -lr
    step against optax: the second step's gradient is clipped, the third
    has lr 0 (the KL stop: moments and count still advance) and its first
    parameter scaled by 0 (critic warm-up). Parameters, mu, nu at rtol
    1e-6, atol 1e-8; count exact."""
    rng = np.random.default_rng(7)
    shapes = [(5,), (3, 5), (4,)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.from_numpy(p.copy()) for p in p_np]
    jparams = [jnp.asarray(p) for p in p_np]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_adam())
    jstate = tx.init(jparams)
    state = optim.adam_init(params)
    for step, (gscale, lr, scale0) in enumerate(((0.01, 1e-2, None), (10.0, 1e-2, None),
                                                (0.1, 0.0, 0.0))):
        g = [(rng.standard_normal(s) * gscale).astype(np.float32) for s in shapes]
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        assert (norm >= 0.5) == (step == 1)
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate)
        upd = [-lr * u for u in upd]
        if scale0 is not None:
            upd[0] = upd[0] * scale0
        jparams = optax.apply_updates(jparams, upd)
        state = optim.apply_step(params, [torch.from_numpy(x) for x in g], state,
                                 torch.tensor(lr), 0.5, None if scale0 is None else [0],
                                 scale0)
        adam = jstate[1]
        assert int(state.count) == int(adam.count) == step + 1
        for ours, theirs in ((params, jparams), (state.mu, adam.mu), (state.nu, adam.nu)):
            for x, y in zip(ours, theirs):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(params[0].numpy(), np.asarray(jparams[0]))


# -- the minibatch epoch -----------------------------------------------------

def jax_perm(key, n):
    """The shuffle JAX's `_update_epoch` draws from `key`."""
    _, k_shift = jax.random.split(key)
    return np.asarray(jax.random.permutation(k_shift, n))


@pytest.mark.parametrize("case", ["kl_stop", "critic_warmup"])
def test_update_epoch_equal_jax(learners, case):
    """One epoch of 4 minibatch steps from equal parameters and Adam state
    (count 3, nonzero moments), JAX's permutation injected. `kl_stop`:
    target_kl stops the later minibatches (their parameters stay, the
    moments advance); `critic_warmup`: the actor scaled by 0 (its
    parameters stay exactly). Parameters at rtol 1e-5, atol 2e-6; mu, nu at
    rtol 1e-4, atol 1e-8; count exact; per-minibatch metrics at rtol 1e-4,
    atol 1e-6, and the same KL decisions."""
    kw = dict(target_kl=3e-6) if case == "kl_stop" else {}
    jl, tl = with_config(*learners, vf_clip_eps=0.2, **kw)
    net = tl.make_network(torch.Generator().manual_seed(8))
    js, ts = stats_pair(9)
    a, adv, ret = batch_for(tl, net, 10, ts)
    flat = {k: v.reshape((T * B,) + v.shape[2:]) for k, v in a.items()}
    rng = np.random.default_rng(11)
    moments = [rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-2
               for p in tl.param_list(net)]
    start = optim.AdamState(count=torch.tensor(3, dtype=torch.int32),
                            mu=[torch.from_numpy(m) for m in moments],
                            nu=[torch.from_numpy(m * m * 2.0) for m in moments])
    adam_np = adam_state_to_numpy(net, start)
    jopt = (optax.EmptyState(), optax.ScaleByAdamState(
        count=jnp.asarray(adam_np["count"]),
        mu={"params": jax.tree_util.tree_map(jnp.asarray, adam_np["mu"])},
        nu={"params": jax.tree_util.tree_map(jnp.asarray, adam_np["nu"])}))
    key = jax.random.PRNGKey(12)
    lr, ent, cap = 3e-3, 1e-3, 1e9
    actor_scale = 0.0 if case == "critic_warmup" else None
    carry = (flax_params(net), jopt, key, jtraj(flat), jnp.asarray(adv), jnp.asarray(ret))
    (jp, jo, *_), jm = jax.jit(
        lambda c: jl._update_epoch(c, None, js, jnp.float32(ent), jnp.float32(lr),
                                   jnp.float32(cap), actor_scale))(carry)
    before = policy_to_numpy(net)
    state, m = tl._update_epoch(net, start, ttraj(flat), torch.from_numpy(adv),
                                torch.from_numpy(ret), ts, ent, lr, torch.tensor(cap),
                                actor_scale, idx=torch.from_numpy(jax_perm(key, T * B).copy()))
    after = policy_to_numpy(net)
    assert_tree_close(after, flax_to_numpy(jp["params"]), rtol=1e-5, atol=2e-6)
    got = adam_state_to_numpy(net, state)
    assert int(got["count"]) == int(jo[1].count) == 3 + MB
    assert_tree_close(got["mu"], flax_to_numpy(jo[1].mu["params"]), rtol=1e-4, atol=1e-8)
    assert_tree_close(got["nu"], flax_to_numpy(jo[1].nu["params"]), rtol=1e-4, atol=1e-8)
    for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if case == "kl_stop":
        stop = np.asarray(jm["approx_kl"]) >= 3e-6
        assert stop.any() and not stop.all(), np.asarray(jm["approx_kl"])
        assert np.array_equal(m["approx_kl"].numpy() >= 3e-6, stop)
    else:
        for name in net.actor_flax_names():
            for x, y in zip(jax.tree_util.tree_leaves(after[name]),
                            jax.tree_util.tree_leaves(before[name])):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert not np.array_equal(after["Dense_3"]["kernel"], before["Dense_3"]["kernel"])


def test_actor_mapping_at_depth_3(hover_env):
    """The flax names of the actor (Dense_0 .. Dense_L and log_std) at three
    hidden layers, and the update scaling through them, against JAX's
    `_actor_keys` and `_scale_actor_updates` (exact)."""
    hidden = (8, 8, 8)
    jl = JPPOLearner(hover_env, JPPOConfig(num_envs=B, hidden=hidden),
                     mesh=make_env_mesh(jax.devices()[:1]))
    tl = PPOLearner(HeliEnv.build("aw109", task=HoverTask(), device="cpu"),
                    PPOConfig(num_envs=B, hidden=hidden))
    net = tl.make_network(torch.Generator().manual_seed(0))
    assert net.actor_flax_names() == set(jl._actor_keys) == {
        "Dense_0", "Dense_1", "Dense_2", "Dense_3", "log_std"}
    ones = jax.tree_util.tree_map(jnp.ones_like, flax_params(net))
    scaled = jl._scale_actor_updates(ones, 0.0)["params"]
    actor = tl._actor_indices(net)
    for i, (name, leaf, _) in enumerate(net.flax_leaves()):
        j = scaled[name] if leaf is None else scaled[name][leaf]
        assert float(jnp.max(j)) == (0.0 if i in actor else 1.0), (name, leaf)
    assert [n for n, _, _ in net.flax_leaves()][::2][:8] == [f"Dense_{i}" for i in range(8)]


# -- checkpoints and the loop ------------------------------------------------

def jax_state(ts, env_keys=None):
    """The port's TrainState `ts` as the JAX package's TrainState, numpy
    leaves: what the JAX package would hold for it (the per-env keys
    `env_keys`, or zeros)."""
    adam = adam_state_to_numpy(ts.params, ts.opt_state)
    env = env_state_to_numpy(ts.env_state)
    cols = lambda cls, fields, a: cls(**{f: a[:, i] for i, f in enumerate(fields)})
    heli = lambda a: cols(JHeliState, JHELI_FIELDS, a)
    wind = lambda a: cols(JWindState, JWIND_FIELDS, a)
    n = env["steps"].shape[0]
    init = JResetSnapshot(heli=heli(env["init.heli"]), wind=wind(env["init.wind"]),
                          dots=heli(env["init.dots"]), obs=env["init.obs"],
                          wind_ned=env["init.wind_ned"])
    es = JEnvState(heli=heli(env["heli"]), wind=wind(env["wind"]), dots=heli(env["dots"]),
                   obs=env["obs"], wind_ned=env["wind_ned"], steps=env["steps"],
                   successed_steps=env["successed_steps"],
                   key=np.zeros((n, 2), np.uint32) if env_keys is None else env_keys,
                   init=init, task_id=env["task_id"])
    s = ts.obs_stats
    return JTrainState(
        params={"params": policy_to_numpy(ts.params)},
        opt_state=(optax.EmptyState(), optax.ScaleByAdamState(
            count=adam["count"], mu={"params": adam["mu"]}, nu={"params": adam["nu"]})),
        env_state=es, key=np.asarray([3, 4], np.uint32),
        update_count=np.int32(ts.update_count),
        obs_stats=JObsStats(mean=s.mean.numpy(), var=s.var.numpy(), count=s.count.numpy()))


def assert_leaves_equal(a, b):
    """Every leaf of two JAX TrainStates bit-equal, but the RNG keys: the
    port derives those from its generator (shape and dtype must agree)."""
    la, lb = (jax.tree_util.tree_leaves_with_path(x) for x in (a, b))
    assert [k for k, _ in la] == [k for k, _ in lb] and len(la) == 135
    for (path, x), (_, y) in zip(la, lb):
        name = jax.tree_util.keystr(path)
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if not name.endswith(".key"):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_checkpoint_round_trip_with_jax(learners, tmp_path):
    """The port's `save` read by the JAX package's `load_npz` against a
    template of the same config, and the JAX package's `save_npz` read by
    the port's `restore`: every leaf bit-equal (params, Adam's count and
    moments, the env farm with its reset snapshots and task ids, the
    counter, the statistics) but the RNG keys, whose meaning differs; the
    treedef strings equal."""
    _, tl = learners
    ts = tl.init(torch.Generator().manual_seed(1))
    ts, _ = tl.train_step(ts)
    mine = jax_state(ts)
    assert tl._treedef(ts.params) == str(jax.tree_util.tree_structure(mine))

    # port -> JAX
    path = str(tmp_path / "port.npz")
    tl.save(path, ts)
    got = jckpt.load_npz(path, mine)
    assert_leaves_equal(got, mine)
    assert int(got.update_count) == 1 and int(got.opt_state[1].count) == 4 * MB
    assert np.asarray(got.env_state.key).dtype == np.uint32

    # JAX -> port: another farm, counter and statistics
    ts2, _ = tl.collect(ts, ts.generator)
    ts2 = ts2.replace(update_count=7, obs_stats=ObsStats(
        mean=torch.full((17,), 0.25), var=torch.full((17,), 2.0),
        count=torch.tensor(1234.0)))
    theirs = jax_state(ts2, np.arange(2 * B, dtype=np.uint32).reshape(B, 2))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_npz(jpath, theirs)
    back = tl.restore(jpath, tl.init(torch.Generator().manual_seed(2)))
    assert back.update_count == 7 and back.generator.device == torch.device("cpu")
    assert_leaves_equal(jax_state(back), theirs)
    # a farm of another size needs the scale-up resume
    small = PPOLearner(tl.env, PPOConfig(**{**CFG, "num_envs": 8}))
    with pytest.raises(ValueError, match="resume_num_envs"):
        small.restore(jpath, small.init(torch.Generator().manual_seed(0)))


def test_train_loop_save_and_scale_up_resume(tmp_path):
    """`train` at 16 envs (two updates and a checkpoint), the port's own resume (the generator continues its stream), and
    a scale-up resume at 32 envs: parameters, Adam's state and observation
    statistics transplanted, update_count 0, the farm the fresh one."""
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu", max_time=0.2)
    small = PPOLearner(env, PPOConfig(**CFG))
    path = str(tmp_path / "run.npz")
    ts, hist = small.train(torch.Generator().manual_seed(0), num_updates=2, log_every=1,
                           checkpoint_path=path)
    assert [h["update"] for h in hist] == [1, 2] and ts.update_count == 2
    # no rollout ended in success, so no best-so-far copy was written
    assert os.path.exists(path) and not os.path.exists(path + ".best.npz")
    assert all(np.isfinite(v) for h in hist for v in h.values())
    same = small.restore(path, small.init(torch.Generator().manual_seed(5)))
    assert torch.equal(same.generator.get_state(), ts.generator.get_state())
    assert same.update_count == 2 and int(same.opt_state.count) == 2 * 4 * MB

    big = PPOLearner(env, PPOConfig(**{**CFG, "num_envs": 32}))
    with pytest.raises(ValueError, match="resume_num_envs"):
        big.train(torch.Generator().manual_seed(1), num_updates=0, resume_from=path)
    ts2, _ = big.train(torch.Generator().manual_seed(1), num_updates=0, resume_from=path,
                       resume_num_envs=B)
    assert ts2.update_count == 0 and ts2.env_state.steps.shape == (32,)
    assert not ts2.env_state.steps.any()
    for a, b in zip(big.param_list(ts2.params), small.param_list(ts.params)):
        assert torch.equal(a, b)
    for x, y in ((ts2.opt_state.mu, ts.opt_state.mu), (ts2.opt_state.nu, ts.opt_state.nu)):
        assert all(torch.equal(a, b) for a, b in zip(x, y))
    assert torch.equal(ts2.opt_state.count, ts.opt_state.count)
    assert torch.equal(ts2.obs_stats.mean, ts.obs_stats.mean)


def test_train_step_metrics_match_jax_keys(hover_env):
    """One train step of the port at 16 envs on a 2-task MixedTask: the
    metric keys are JAX's train step's (its shapes traced, not run), with
    the per-sub-task keys; every value finite; the update count, Adam's
    count and the farm advanced; the critic moved, the actor not (critic
    warm-up); the observation statistics merged."""
    jenv = hover_env.replace(task=jtasks.MixedTask(tasks=(jtasks.HoverTask(),
                                                          jtasks.LandingTask())))
    kw = dict(CFG, critic_warmup=1, success_bonus=1.0, fail_penalty=5.0, anneal_updates=10)
    jl = JPPOLearner(jenv, JPPOConfig(**kw), mesh=make_env_mesh(jax.devices()[:1]))
    env = HeliEnv.build("aw109", task=MixedTask(tasks=(HoverTask(), LandingTask())),
                        device="cpu")
    tl = PPOLearner(env, PPOConfig(**kw))
    ts = tl.init(torch.Generator().manual_seed(0), task_ids=np.arange(B) % 2)
    _, jmetrics = jax.eval_shape(jl.train_step_fn(), jax_state(ts))
    before = policy_to_numpy(ts.params)
    stats0 = ts.obs_stats.mean.clone()
    ts1, metrics = tl.train_step(ts)
    assert set(metrics) == set(jmetrics)
    assert {"success_ep_frac_t1", "in_tol_t0"} <= set(metrics)
    assert all(bool(torch.isfinite(v)) and v.shape == () for v in metrics.values())
    assert float(metrics["lr"]) == np.float32(3e-4)
    assert ts1.update_count == 1 and int(ts1.opt_state.count) == 4 * MB
    assert (ts1.env_state.steps == T).all()
    after = policy_to_numpy(ts1.params)
    assert np.array_equal(after["Dense_0"]["kernel"], before["Dense_0"]["kernel"])
    assert not np.array_equal(after["Dense_4"]["kernel"], before["Dense_4"]["kernel"])
    assert not torch.equal(ts1.obs_stats.mean, stats0)


# -- the torch bench -----------------------------------------------------------

def test_torch_bench_prints_one_json_line():
    """tools/torch_bench.py on the CPU (8 envs x 4 steps, one chunk): one
    JSON line with the metric, its value, unit and ratio to 500 env-steps/s."""
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_bench.py"),
                          "--device", "cpu", "--num-envs", "8", "--chunk-steps", "4",
                          "--chunks", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if l.strip()]
    out = json.loads(lines[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["unit"] == "env-steps/s" and out["value"] > 0
    assert abs(out["vs_baseline"] - out["value"] / 500.0) < 1e-6 * out["vs_baseline"]
