"""The port's learner modules (heligym_tpu_torch.learner, .utils.checkpoint,
.convert and the fused policy rollout) against the JAX package, on the CPU.

The committed checkpoints go through flax and through the port's network on
the same numpy observations (atol 1e-5: float32 matmuls summed in another
order); the policy rollout runs a deterministic mean policy with the same
Dryden noise through JAX's `build_fused_policy_rollout` (the Pallas kernel in
interpret mode) and the port's, at the tolerances of the JAX package's
test_fused.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heligym_tpu.envs import VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.learner import PPOConfig as JPPOConfig
from heligym_tpu.learner import PPOLearner as JPPOLearner
from heligym_tpu.learner import networks as jnetworks
from heligym_tpu.learner.ppo import ObsStats as JObsStats
from heligym_tpu.models import load_params as jload_params
from heligym_tpu.ops.pallas import build_fused_policy_rollout as jbuild_policy_rollout
from heligym_tpu.parallel import make_env_mesh

from heligym_tpu_torch.convert import (env_state_from_numpy, obs_stats_from_numpy,
                                       policy_from_numpy)
from heligym_tpu_torch.envs import HeliEnv, HoverTask, LandingTask, MixedTask
from heligym_tpu_torch.envs import tasks as ttasks
from heligym_tpu_torch.learner import (ActorCritic, ObsStats, PPOConfig, PPOLearner,
                                       gaussian_entropy, gaussian_log_prob,
                                       obs_scales)
from heligym_tpu_torch.learner.evaluate import (build_env, evaluate,
                                                multi_seed_evaluate, seeded_generator)
from heligym_tpu_torch.learner.train import TASKS, _parse_target
from heligym_tpu_torch.ops.cuda import fused_step as fs
from heligym_tpu_torch.utils.checkpoint import (TreedefError, load_policy_npz,
                                                parse_treedef)

from test_torch_tasks import compiled, jax_state_to_numpy, make_task
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def flax_params(net: ActorCritic):
    """The port network's parameters as the flax tree of the JAX network."""
    tree = {f"Dense_{i}": {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                           "bias": jnp.asarray(lin.bias.detach().numpy())}
            for i, lin in enumerate(net.dense_layers())}
    tree["log_std"] = jnp.asarray(net.log_std.detach().numpy())
    return {"params": tree}


# -- network, checkpoint reader ------------------------------------------------

@pytest.mark.parametrize("name,in_dim", [("hover4k", 17), ("multitask4", 21)])
def test_actor_critic_matches_flax_on_checkpoint(name, in_dim):
    ckpt = load_policy_npz(os.path.join(EXAMPLES, f"{name}_policy.npz"))
    net = policy_from_numpy(ckpt["params"])
    assert net.actor[0].in_features == in_dim and len(net.actor) == 2
    obs = np.random.default_rng(0).standard_normal((64, in_dim)).astype(np.float32)
    with torch.no_grad():
        mean, log_std, value = net(torch.from_numpy(obs))
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, ckpt["params"])}
    jmean, jlog_std, jvalue = jnetworks.ActorCritic(hidden=(256, 256)).apply(jparams, obs)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(jlog_std))
    # and back: the port's tree equals the checkpoint's
    back = flax_params(net)["params"]
    for k, v in ckpt["params"].items():
        if k == "log_std":
            np.testing.assert_array_equal(np.asarray(back[k]), v)
        else:
            np.testing.assert_array_equal(np.asarray(back[k]["kernel"]), v["kernel"])
    stats = obs_stats_from_numpy(ckpt["obs_stats"])
    assert stats.mean.shape == (17,) and float(stats.count) > 1e6


def test_actor_critic_init_matches_flax_statistics():
    """Orthogonal init with the JAX gains from an explicit generator; zero
    biases; the state-free log_std."""
    net = ActorCritic(in_dim=21, hidden=(64, 48), log_std_init=-1.5,
                      generator=torch.Generator().manual_seed(0))
    again = ActorCritic(in_dim=21, hidden=(64, 48), log_std_init=-1.5,
                        generator=torch.Generator().manual_seed(0))
    gains = [2 ** 0.5, 2 ** 0.5, 0.01, 2 ** 0.5, 2 ** 0.5, 1.0]
    shapes = [(64, 21), (48, 64), (4, 48), (64, 21), (48, 64), (1, 48)]
    for lin, lin2, gain, shape in zip(net.dense_layers(), again.dense_layers(),
                                      gains, shapes):
        w = lin.weight.detach()
        assert tuple(w.shape) == shape and torch.equal(w, lin2.weight)
        assert not lin.bias.any()
        small = w @ w.T if shape[0] <= shape[1] else w.T @ w
        torch.testing.assert_close(small, gain ** 2 * torch.eye(small.shape[0]),
                                   atol=1e-5, rtol=0)
    assert net.log_std.tolist() == [-1.5] * 4
    jparams = flax_params(net)
    obs = np.random.default_rng(1).standard_normal((5, 3, 21)).astype(np.float32)
    with torch.no_grad():
        mean, log_std, value = net(torch.from_numpy(obs))
    jmean, jls, jvalue = jnetworks.ActorCritic(hidden=(64, 48)).apply(jparams, obs)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)
    assert log_std.shape == mean.shape == (5, 3, 4) and value.shape == (5, 3)


def test_gaussian_log_prob_and_entropy_equal_jax():
    rng = np.random.default_rng(2)
    mean, act = (rng.standard_normal((7, 33, 4)).astype(np.float32) for _ in range(2))
    log_std = rng.uniform(-3.5, 0.0, (7, 33, 4)).astype(np.float32)
    lp = gaussian_log_prob(*(torch.from_numpy(a) for a in (mean, log_std, act)))
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jnetworks.gaussian_log_prob(mean, log_std, act)),
        rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(
        gaussian_entropy(torch.from_numpy(log_std)).numpy(),
        np.asarray(jnetworks.gaussian_entropy(log_std)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(obs_scales(HeliEnv.build("aw109", device="cpu").params),
                                  jnetworks.obs_scales(jload_params("aw109")))


def test_checkpoint_reader_rejects_unknown_treedef(tmp_path):
    src = os.path.join(EXAMPLES, "hover4k_policy.npz")
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    tree, n = parse_treedef(str(arrays["treedef"]))
    assert n == int(arrays["n"]) == 135 and tree[1] == "TrainState"

    def rewrite(treedef, **extra):
        path = str(tmp_path / "bad.npz")
        np.savez(path, **{**arrays, "treedef": treedef, **extra})
        return path

    good = str(arrays["treedef"])
    for bad in (good.replace("TrainState", "OtherState"),
                good.replace("ObsStats", "Stats"),
                good.replace("'Dense_5'", "'Conv_5'"),
                good.replace("PyTreeDef(", "Tree("),
                good[:-3],
                good.replace("*", "?", 1)):
        with pytest.raises(TreedefError):
            load_policy_npz(rewrite(bad))
    with pytest.raises(TreedefError):
        load_policy_npz(rewrite(good, n=np.asarray(134)))
    with pytest.raises(ValueError):
        policy_from_numpy({"Dense_0": {}, "log_std": np.zeros(4)})


# -- the learner's network input -----------------------------------------------

@pytest.fixture(scope="module")
def learners(hover_env):
    """(JAX learner, port learner) on a 4-task MixedTask env."""
    alt = 1600.0
    jenv = hover_env.replace(task=make_task(jtasks, "mixed4", alt))
    jl = JPPOLearner(jenv, JPPOConfig(num_envs=128, rollout_steps=8, hidden=(32, 32)),
                     mesh=make_env_mesh(jax.devices()[:1]))
    env = HeliEnv.build("aw109", task=make_task(ttasks, "mixed4", alt), device="cpu")
    tl = PPOLearner(env, PPOConfig(num_envs=128, rollout_steps=8, hidden=(32, 32)))
    return jl, tl


def test_norm_net_in_task_oh_equal_jax(learners):
    jl, tl = learners
    assert tl.task_dim == jl.task_dim == 4
    # both host Newton trims stop at their own last iterate
    np.testing.assert_allclose(tl.act_bias.numpy(), np.asarray(jl.act_bias), atol=1e-5)
    rng = np.random.default_rng(3)
    obs = (rng.standard_normal((6, 128, 17)) * obs_scales(tl.env.params) * 3
           ).astype(np.float32)
    obs[0, :4, 3] = np.inf
    obs[1, :4, 5] = -np.inf
    obs[2, :4, 7] = np.nan
    obs[3, :4, 0] = 1e30
    mean = rng.standard_normal(17).astype(np.float32)
    var = rng.uniform(1e-3, 4.0, 17).astype(np.float32)
    jstats = JObsStats(mean=jnp.asarray(mean), var=jnp.asarray(var),
                       count=jnp.float32(100.0))
    stats = ObsStats(mean=torch.from_numpy(mean), var=torch.from_numpy(var),
                     count=torch.tensor(100.0))
    tid = (np.arange(128) % 5).astype(np.int32)       # id 4 is out of range
    toh = tl._task_oh(torch.from_numpy(tid))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(jl._task_oh(jnp.asarray(tid))))
    for js, ts_ in ((None, None), (jstats, stats)):
        np.testing.assert_allclose(
            tl._norm(torch.from_numpy(obs), ts_).numpy(),
            np.asarray(jl._norm(jnp.asarray(obs), js)), rtol=1e-6, atol=1e-6)
        x = tl._net_in(torch.from_numpy(obs), ts_, toh)
        assert x.shape == (6, 128, 21)
        np.testing.assert_allclose(
            x.numpy(), np.asarray(jl._net_in(jnp.asarray(obs), js, jnp.asarray(toh.numpy()))),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tl._net_in(torch.from_numpy(obs), None)
    assert tl.log_std_cap(7) == 1e9
    capped = PPOLearner.__new__(PPOLearner)
    capped.config = PPOConfig(log_std_init=-1.0, std_cap_final=-3.0, std_cap_updates=10)
    assert capped.log_std_cap(0) == -1.0 and capped.log_std_cap(5) == -2.0 \
        and capped.log_std_cap(99) == -3.0


def test_policy_and_restore(learners):
    """Mean and stochastic actions of a restored checkpoint; restore refuses
    a checkpoint of another shape."""
    _, tl = learners
    env, _ = build_env(tasks="hover,forward,turning,oblique", device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=8))
    ts = learner.restore(os.path.join(EXAMPLES, "multitask4_policy.npz"))
    assert ts.env_state is None and ts.update_count == 0
    obs = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 17))
                           .astype(np.float32)) * learner._scales
    toh = learner._task_oh(torch.arange(8, dtype=torch.int32) % 4)
    with torch.no_grad():
        a0 = learner.policy(ts.params, obs, None, ts.obs_stats, toh)
        a1 = learner.policy(ts.params, obs, torch.Generator().manual_seed(0),
                            ts.obs_stats, toh, stochastic=True)
    assert a0.shape == (8, 4) and float(a0.abs().max()) <= 1.0
    assert not torch.equal(a0, a1) and float((a0 - a1).abs().max()) < 0.5
    with pytest.raises(ValueError):
        tl.restore(os.path.join(EXAMPLES, "multitask4_policy.npz"))


# -- the policy rollout ---------------------------------------------------------

def test_fused_policy_rollout_matches_jax(learners, hover_trim):
    """A deterministic (mean) policy in the loop, the same Dryden noise, one
    lane out of bounds at the start (it fails on step 0 and resets): obs,
    action, reward and the pre-reset final_obs within the fused tolerances,
    the flag streams identical."""
    jl, tl = learners
    n, steps = 128, 8
    jenv, env = jl.env, tl.env
    venv = JVectorHeliEnv(jenv, n)
    es, _ = venv.reset_from_trim(hover_trim, jax.random.PRNGKey(5))
    es = venv.assign_tasks(es, np.arange(n) % 4)
    x0 = es.heli.x.at[0].set(jenv.params.ENV.NS_MAX / 2.0 + 10.0)
    es = es.replace(heli=es.heli.replace(x=x0))

    net = tl.make_network(torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.mean.weight.mul_(20.0)       # actions that visibly depend on the obs
    jparams = flax_params(net)
    jtoh = jl._task_oh(es.task_id)

    def jpolicy_fn(p, obs, key):
        mean, _, value = jl.network.apply(p, jl._net_in(obs, None, jtoh))
        return jnp.clip(jl.act_bias + mean, -1.0, 1.0), {"value": value}

    key = jax.random.PRNGKey(0)
    jroll = compiled(jbuild_policy_rollout(jenv, n, steps, jpolicy_fn), es, jparams, key)
    es_j, jtraj = jroll(es, jparams, key)

    # the noise JAX drew from the per-env keys (fused_step.py draw_eta)
    def draw(k):
        _, sub = jax.random.split(k)
        return jax.random.normal(sub, (steps, 3), jnp.float32)
    eta = np.asarray(jnp.moveaxis(jax.vmap(draw)(es.key), 0, -1)
                     * (1.0 / jenv.dt) ** 0.5)

    toh = tl._task_oh(torch.arange(n, dtype=torch.int32) % 4)

    def policy_fn(p, obs, generator):
        mean, _, value = p(tl._net_in(obs, None, toh))
        return torch.clamp(tl.act_bias + mean, -1.0, 1.0), {"value": value}

    roll = fs.build_fused_policy_rollout(env, n, steps, policy_fn)
    es_f, traj = roll(env_state_from_numpy(jax_state_to_numpy(es), "cpu"), net,
                      eta_seq=torch.from_numpy(eta))
    assert set(traj) == set(jtraj)
    for k in ("terminated", "truncated", "failed", "succ_step"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    assert traj["failed"][0, 0] and not traj["failed"][0, 1:].any()
    np.testing.assert_allclose(traj["reward"].numpy(), np.asarray(jtraj["reward"]),
                               atol=2e-5)
    for k in ("obs", "final_obs"):
        assert traj[k].shape == (steps, n, 17)
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]),
                                   rtol=1e-4, atol=2e-3, err_msg=k)
    np.testing.assert_allclose(traj["action"].numpy(), np.asarray(jtraj["action"]),
                               atol=2e-5)
    np.testing.assert_allclose(traj["value"].numpy(), np.asarray(jtraj["value"]),
                               atol=1e-4)
    # lane 0 was reset: its next obs is the snapshot's, not the failed step's
    assert not np.allclose(traj["final_obs"][0, 0].numpy(), traj["obs"][1, 0].numpy())
    np.testing.assert_array_equal(traj["obs"][1, 0].numpy(), np.asarray(es.init.obs[0]))
    np.testing.assert_array_equal(traj["final_obs"][0, 1:].numpy(),
                                  traj["obs"][1, 1:].numpy())
    np.testing.assert_allclose(es_f.heli.flatten().numpy(),
                               np.asarray(es_j.heli.flatten()), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(es_f.steps.numpy(), np.asarray(es_j.steps))


def test_collect_through_learner(learners):
    """PPOLearner.collect: the Transition's shapes, the sanitised reward,
    v_boot from the pre-reset obs, reproducible from the generator."""
    _, tl = learners
    ts = tl.init(torch.Generator().manual_seed(0), task_ids=np.arange(128) % 4)
    assert ts.env_state.task_id.tolist() == (np.arange(128) % 4).tolist()
    ts1, tr = tl.collect(ts, torch.Generator().manual_seed(7))
    _, tr2 = tl.collect(ts, torch.Generator().manual_seed(7))
    T, B = 8, 128
    assert tr.obs.shape == (T, B, 17) and tr.action.shape == (T, B, 4)
    for f in ("log_prob", "value", "reward", "terminated", "truncated", "v_boot",
              "failed", "succ_step"):
        v = getattr(tr, f)
        assert v.shape == (T, B) and v.dtype == torch.float32 and bool(
            torch.isfinite(v).all()), f
        assert torch.equal(v, getattr(tr2, f)), f
    assert tr.task_oh.shape == (T, B, 4)
    assert float(tr.reward.abs().max()) <= 100.0
    assert (ts1.env_state.steps == T).all() and (ts.env_state.steps == 0).all()
    # the four task populations see different rewards
    means = [float(tr.reward[:, i::4].mean()) for i in range(4)]
    assert len({round(m, 6) for m in means}) == 4
    with torch.no_grad():
        v_next = tl._value_of(ts.params, None, tr.obs[1:], tl._task_oh(
            ts.env_state.task_id))
    torch.testing.assert_close(tr.v_boot[:-1], v_next, atol=1e-6, rtol=0)


@pytest.mark.parametrize("task", ["hover", "mixed4"])
def test_bootstrap_reuses_values_where_no_env_ended(task, monkeypatch):
    """The collector's bootstrap on a farm whose envs end mid-rollout (a
    6-step episode wall reached at staggered steps, and two lanes that fail
    on their first step): v_boot equals the full network's value of every
    pre-reset obs; a transition whose env did not end takes the rollout's
    own next value, and the counters split the T x B rows between the two."""
    from heligym_tpu_torch.learner import ppo

    T, B = 8, 32
    env = HeliEnv.build("aw109", task=make_task(ttasks, task, 1600.0), device="cpu",
                        max_time=0.1)
    assert env.time_up_steps < T
    tl = PPOLearner(env, PPOConfig(num_envs=B, rollout_steps=T, hidden=(32, 32)))
    ts = tl.init(torch.Generator().manual_seed(0),
                 task_ids=np.arange(B) % 4 if task == "mixed4" else None)
    es = ts.env_state
    # lanes 0 and 1 far above the ceiling (out of bounds: failed), the rest
    # at staggered points of their episodes
    z = es.heli.z.clone()
    z[:2] -= 20000.0
    ts = ts.replace(env_state=es.replace(heli=es.heli.replace(z=z),
                                         steps=torch.arange(B, dtype=torch.int32)
                                         % env.time_up_steps))
    seen = {}
    tl.collect(ts, torch.Generator().manual_seed(7))      # builds the collector
    roll = tl._fused_rollout

    def spy(*a, **kw):
        es_out, traj = roll(*a, **kw)
        seen.update(traj)
        return es_out, traj

    monkeypatch.setattr(tl, "_fused_rollout", spy)
    before = (ppo.bootstrap_valued_rows, ppo.bootstrap_reused_rows)
    _, tr = tl.collect(ts, torch.Generator().manual_seed(7))
    valued = ppo.bootstrap_valued_rows - before[0]
    reused = ppo.bootstrap_reused_rows - before[1]

    ended = seen["terminated"] | seen["truncated"]
    assert seen["failed"][0, :2].all() and seen["truncated"].any()
    assert ended[:-1].any() and not ended[:-1].all()
    assert valued + reused == T * B and valued >= B
    assert valued == B + int(ended[:-1].sum())
    toh = tl._task_oh(ts.env_state.task_id)
    with torch.no_grad():
        full = ts.params(tl._net_in(seen["final_obs"], ts.obs_stats, toh))[2]
    torch.testing.assert_close(tr.v_boot, full, atol=1e-6, rtol=0)
    kept = ~ended[:-1]
    assert torch.equal(tr.v_boot[:-1][kept], tr.value[1:][kept])
    assert torch.equal(seen["final_obs"][:-1][kept], seen["obs"][1:][kept])


def test_graphed_rollout_refuses_cpu(learners):
    """The graphed collector is a CUDA graph: asked for on CPU tensors it
    raises, it never falls back to the eager loop."""
    _, tl = learners
    ts = tl.init(torch.Generator().manual_seed(0), task_ids=np.arange(128) % 4)
    with pytest.raises(ValueError):
        tl.collect(ts, torch.Generator().manual_seed(0), graphed=True)
    roll = fs.build_fused_policy_rollout(tl.env, 128, 2, lambda p, o, g: (o[:, :4], {}))
    with pytest.raises(ValueError):
        roll(ts.env_state, None, graphed=True)


# -- the evaluator ---------------------------------------------------------------

def test_evaluate_partitions_outcomes():
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=8, rollout_steps=4,
                                        hidden=(32, 32), log_std_init=-2.5))
    ts = learner.init(torch.Generator().manual_seed(0))
    res = evaluate(env, learner, ts, episodes=8, steps=5,
                   generator=seeded_generator(env, 1))
    assert res["episodes"] == 8
    total = res["success_frac"] + res["fail_frac"] + res["timeout_frac"]
    assert abs(total - 1.0) < 1e-6
    # an untrained trim-centered mean policy neither succeeds nor crashes
    # within 5 steps (success needs 10 s of in-tolerance time)
    assert res["success_frac"] == 0.0 and res["fail_frac"] == 0.0
    assert res["median_end_step"] == 5 and np.isfinite(res["mean_episode_reward"])
    again = evaluate(env, learner, ts, episodes=8, steps=5,
                     generator=seeded_generator(env, 1))
    assert again == res


def test_evaluate_latches_first_termination():
    """A short episode wall: every episode ends once, by time-up, at the
    wall's step, whatever happens after."""
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu", max_time=0.1)
    learner = PPOLearner(env, PPOConfig(num_envs=8, hidden=(32, 32)))
    ts = learner.init(torch.Generator().manual_seed(0))
    res = evaluate(env, learner, ts, episodes=8, steps=env.time_up_steps + 3,
                   generator=seeded_generator(env, 0), stochastic=True)
    assert res["timeout_frac"] == 1.0
    assert res["median_end_step"] == env.time_up_steps - 1


def test_evaluate_per_task_breakdown():
    env = HeliEnv.build("aw109", task=MixedTask(tasks=(HoverTask(), LandingTask())),
                        device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=8, rollout_steps=4,
                                        hidden=(32, 32), log_std_init=-2.5))
    ts = learner.init(torch.Generator().manual_seed(0))
    task_ids = np.arange(8) % 2
    res = multi_seed_evaluate(env, learner, ts, episodes=8, steps=5, seeds=(0, 1),
                              task_ids=task_ids)
    assert res["seeds"] == [0, 1] and set(res["per_seed"]) == {"mean", "stochastic"}
    for rows in res["per_seed"].values():
        assert [r["seed"] for r in rows] == [0, 1]
        assert all("success_frac_t0" in r and "fail_frac_t1" in r for r in rows)
    agg = res["aggregate"]["mean"]
    assert set(agg["success_frac_t1"]) == {"mean", "std", "min", "max"}
    assert "timeout_frac" in agg and "median_end_step" not in agg


def test_cli_helpers_build_the_eval_env():
    """TASKS, _parse_target and build_env as the evaluator's command line
    uses them (the multitask4 line of the JAX package's eval script)."""
    assert sorted(TASKS) == ["forward", "hover", "landing", "oblique", "slalom",
                             "turning"]
    env, n = build_env(tasks="hover,forward,turning,oblique",
                       target="sea_alt=start,vel=60", turb_level=2, max_time=20.0,
                       device="cpu")
    assert n == 4 and env.wind_params.turbulence_level == 2 and env.max_time == 20.0
    start = float(-env.trim_result().state.z)
    subs = env.task.tasks
    assert [type(t).__name__ for t in subs] == [
        "HoverTask", "ForwardFlightTask", "TurningFlightTask", "ObliqueFlightTask"]
    assert all(abs(t.sea_alt - start) < 1e-2 for t in subs)
    assert [t.vel for t in subs[1:]] == [60.0, 60.0, 60.0]
    upd = _parse_target("touch_alt=ground+30,pad_north=5", env)
    assert abs(upd["touch_alt"] - (start - 100.0 + 30.0)) < 1e-2 and upd["pad_north"] == 5.0
    env1, n1 = build_env("landing", target="touch_alt=ground", device="cpu")
    assert n1 == 0 and abs(env1.task.touch_alt - (start - 100.0)) < 1e-2
