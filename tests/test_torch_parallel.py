"""The port's multi-device layer (heligym_tpu_torch.parallel, the sharded
PPOLearner and the trainer under torchrun) against the single-process port
and the JAX package, on the CPU with 2 gloo ranks.

Each multi-rank check spawns 2 processes (`tests/torch_parallel_workers.py`)
that meet in a file under `tmp_path` and write what they computed; the test
holds it against a single-process run here and against the JAX package's
functions on the same inputs. The JAX references are the tiny configuration
of `tests/test_torch_ppo.py` (hidden (16, 16), T = 8, B = 16, 4
minibatches); the farm checks are `tests/test_sharding.py`'s, with its
tolerances. Every random draw of a rank is its rows of the global draw from
a generator held in the same state on every rank, so a rank's envs see
exactly the single process's noise.

The file collects two tests, each running all of its checks before it
reports every one that failed: a file of at most two tests is handed out
after every long file of the JAX package under `--dist loadfile`."""
import dataclasses
import glob
import os
import subprocess
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from heligym_tpu.envs.env import StepOutput as JStepOutput
from heligym_tpu.parallel import farm_metrics as jfarm_metrics
from heligym_tpu.utils import checkpoint as jckpt

from heligym_tpu_torch.convert import (adam_state_to_numpy, env_state_to_numpy,
                                       policy_to_numpy)
from heligym_tpu_torch.envs import HeliEnv, HoverTask, LandingTask, MixedTask
from heligym_tpu_torch.learner import PPOConfig, PPOLearner, optim
from heligym_tpu_torch.learner.train import make_alt_band_sampler
from heligym_tpu_torch.ops.cuda.fused_step import build_fused_rollout
from heligym_tpu_torch.parallel import EnvFarm

import torch_parallel_workers as workers
from test_torch_ppo import (CFG, MB, B, T, assert_leaves_equal, batch_for, flax_params,
                            jax_perm, jax_state, jtraj, learners, stats_pair,  # noqa: F401
                            with_config)
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def run_checks(checks):
    """Run every check, then fail with each one that failed."""
    failed = []
    for name, check in checks:
        try:
            check()
        except Exception:   # noqa: BLE001 - reported below, with its traceback
            failed.append(f"{name}:\n{traceback.format_exc()}")
    assert not failed, f"{len(failed)} of {len(checks)} checks failed:\n" + "\n".join(failed)


def joined(res, key, axis=0):
    """Every rank's block of a per-env array, in rank order."""
    return np.concatenate([r[key] for r in res], axis=axis)


def tree_of(res, prefix):
    """The entries `prefix/...` of a rank's results."""
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def assert_close_trees(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# -- the farm --------------------------------------------------------------------

def test_farm_layout_invariance(tmp_path):
    """The env farm on 2 ranks against 1: the meshes' sizes and axis names
    (`make_env_mesh`, `make_train_mesh`) and their placements; the
    divisibility ValueError (`EnvFarm`, `PPOLearner`); `shard_env_state`'s
    rows; a 16-env farm stepped 20 times through
    `step_fn` bit-equal to one process's; `rollout_fn`'s outputs (10, 32,
    17) over the ranks; `farm_metrics` of its last step (all-reduced)
    against the JAX package's `farm_metrics` on the same outputs (rtol
    1e-6; the reward mean also atol 1e-6 of the mean |reward|); `build_sharded_fused_rollout` at 1024 envs x 8 steps against
    `build_fused_rollout` at `test_sharding.py`'s tolerances (reward atol
    1e-4, done and step counters equal, state rtol 1e-3 / atol 1e-4)."""
    eta = (np.random.default_rng(0).standard_normal((8, 3, 1024)) * 50 ** 0.5
           ).astype(np.float32)
    res = workers.spawn(workers.farm, WORLD, tmp_path / "farm", {"eta": eta})
    env = workers.hover_env()
    trim = env.trim_result().action

    def mesh():
        for r in res:
            assert int(r["mesh_size"]) == WORLD and list(r["mesh_names"]) == ["env"]
            assert list(r["train_mesh_shape"]) == [WORLD, 1]
            assert list(r["train_mesh_names"]) == ["env", "model"]
            assert list(r["placements"]) == ["(Shard(dim=0),)", "(Replicate(),)",
                                             "(Shard(dim=0), Replicate())"]
            assert bool(r["farm_divisibility_raised"])
            assert bool(r["learner_divisibility_raised"])
        from heligym_tpu_torch.ops.cuda import fused_step as fs
        whole, _ = EnvFarm.build(env, 16).reset()
        whole = whole.replace(steps=torch.arange(16, dtype=torch.int32))
        np.testing.assert_array_equal(joined(res, "shard_rows", axis=1),
                                      fs.pack(whole)[0].numpy())

    def step_fn():
        farm = EnvFarm.build(env, 16)
        es, _ = farm.reset()
        step = farm.step_fn()
        gen = torch.Generator().manual_seed(9)
        for _ in range(20):
            es, out = step(es, trim.expand(16, 4), gen)
        from heligym_tpu_torch.ops.cuda import fused_step as fs
        np.testing.assert_array_equal(joined(res, "step_obs"), out.obs.numpy())
        np.testing.assert_array_equal(joined(res, "step_carry", axis=1),
                                      fs.pack(es)[0].numpy())

    def rollout_and_metrics():
        obs = joined(res, "roll_obs", axis=1)
        assert obs.shape == (10, 32, 17) and np.isfinite(obs).all()
        last = {f.name: jnp.asarray(joined(res, f"roll_{f.name}", axis=1)[-1])
                for f in dataclasses.fields(JStepOutput)}
        want = jfarm_metrics(JStepOutput(**last))
        # a mean of mixed-sign rewards near 0 carries float32 summation error
        # relative to the summands, not to itself
        scale = float(np.abs(np.asarray(last["reward"])).mean())
        for r in res:
            for k, v in want.items():
                np.testing.assert_allclose(r[f"metric_{k}"], np.asarray(v), rtol=1e-6,
                                           atol=1e-6 * scale if k == "reward_mean" else 0,
                                           err_msg=k)

    def sharded_fused_rollout():
        n = eta.shape[-1]
        es, _ = EnvFarm.build(env, n).reset()
        es1, o1 = build_fused_rollout(env, n, eta.shape[0], eta_mode="inject")(
            es, trim.expand(n, 4), torch.from_numpy(eta))
        np.testing.assert_allclose(joined(res, "sharded_reward", axis=1), o1["reward"].numpy(),
                                   atol=1e-4)
        np.testing.assert_array_equal(joined(res, "sharded_done", axis=1), o1["done"].numpy())
        np.testing.assert_array_equal(joined(res, "sharded_steps"), es1.steps.numpy())
        np.testing.assert_allclose(joined(res, "sharded_heli"), es1.heli.flatten().numpy(),
                                   rtol=1e-3, atol=1e-4)

    run_checks([("mesh and divisibility", mesh), ("step_fn, 1 vs 2 ranks", step_fn),
                ("rollout_fn and farm_metrics", rollout_and_metrics),
                ("build_sharded_fused_rollout", sharded_fused_rollout)])


# -- the learner -----------------------------------------------------------------

def test_sharded_learner(learners, tmp_path):
    """The learner on 2 ranks: `_update_epoch` (kl stop at target_kl 3e-6,
    value clipping) on each rank's env columns of a rollout with JAX's
    permutation injected, against JAX's `_update_epoch` at
    `test_update_epoch_equal_jax`'s tolerances (parameters rtol 1e-5 / atol
    2e-6, moments rtol 1e-4 / atol 1e-8, metrics rtol 1e-4 / atol 1e-6)
    with the same KL stop decisions, the parameters the same on both
    ranks; `_merge_stats` against JAX's (rtol 2e-5 / atol 1e-6); one
    `train_step` on hover and on a 2-task MixedTask (task ids arange % 2)
    against one process at `test_sharding.py`'s tolerances (parameters rtol
    2e-4 / atol 2e-6, statistics rtol 1e-5 / atol 1e-7, loss, reward,
    approx_kl and success rtol 1e-3 / atol 1e-5), the generators' states
    equal; a 2-rank `save` read by JAX's `load_npz` and restored by a
    1-rank learner, every leaf equal to the ranks' states put together; a
    farm of randomized resets (altitude band 6-55 ft, each rank trimming
    its rows of the global draw) against one process, after the reset and
    after one `train_step`: steps, success counters and task ids exact, the
    floats at `test_sharding.py`'s rtol 1e-3 / atol 1e-4, the generators'
    states equal; and
    the trainer under `torch.distributed.run` with 2 CPU ranks (one
    `devices:` line listing both, one evaluation, finite update lines, the
    checkpoint and its best copy, of the whole farm)."""
    jl, tl = with_config(*learners, vf_clip_eps=0.2, target_kl=3e-6)
    # the epoch: JAX's on the whole rollout, the ranks' on their columns
    net = tl.make_network(torch.Generator().manual_seed(8))
    js, ts_stats = stats_pair(9)
    a, adv, ret = batch_for(tl, net, 10, ts_stats)
    flat = {k: v.reshape((T * B,) + v.shape[2:]) for k, v in a.items()}
    rng = np.random.default_rng(11)
    mu = [rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-2
          for p in tl.param_list(net)]
    nu = [m * m * 2.0 for m in mu]
    adam_np = adam_state_to_numpy(net, optim.AdamState(
        count=torch.tensor(3, dtype=torch.int32), mu=[torch.from_numpy(m) for m in mu],
        nu=[torch.from_numpy(m) for m in nu]))
    jopt = (optax.EmptyState(), optax.ScaleByAdamState(
        count=jnp.asarray(adam_np["count"]),
        mu={"params": jax.tree_util.tree_map(jnp.asarray, adam_np["mu"])},
        nu={"params": jax.tree_util.tree_map(jnp.asarray, adam_np["nu"])}))
    key = jax.random.PRNGKey(12)
    lr, ent, cap = 3e-3, 1e-3, 1e9
    carry = (flax_params(net), jopt, key, jtraj(flat), jnp.asarray(adv), jnp.asarray(ret))
    (jp, jo, *_), jm = jax.jit(
        lambda c: jl._update_epoch(c, None, js, jnp.float32(ent), jnp.float32(lr),
                                   jnp.float32(cap), None))(carry)

    merge_obs = (np.random.default_rng(0).standard_normal((T, B, 17))
                 * tl._scales.numpy() * 3).astype(np.float32)
    merge_obs[0, :3, 2] = np.nan
    merge_obs[1, 5:9, 5] = np.inf
    merge_obs[3, 9:12, 0] = 1e30
    jmerged = jl._merge_stats(js, jnp.asarray(merge_obs))

    band = (6.0, 55.0)
    payload = {"cfg": CFG, "merge_obs": merge_obs, "band": band, "epoch": {
        "net_seed": 8, "traj": a, "adv": adv.reshape(T, B), "ret": ret.reshape(T, B),
        "mu": mu, "nu": nu, "perm": jax_perm(key, T * B).copy(),
        "stats": {k: np.asarray(getattr(ts_stats, k)) for k in ("mean", "var", "count")},
        "lr": lr, "ent": ent, "cap": cap}}
    res = workers.spawn(workers.learner, WORLD, tmp_path / "learner", payload)

    # one process: the same train steps
    single = {}
    for case in ("hover", "mixed"):
        task = MixedTask(tasks=(HoverTask(), LandingTask())) if case == "mixed" else HoverTask()
        one = PPOLearner(HeliEnv.build("aw109", task=task, device="cpu"), PPOConfig(**CFG))
        ts = one.init(torch.Generator().manual_seed(0),
                      task_ids=np.arange(B) % 2 if case == "mixed" else None)
        ts, metrics = one.train_step(ts)
        single[case] = (one, ts, metrics)
    one = PPOLearner(HeliEnv.build("aw109", task=HoverTask(), device="cpu"), PPOConfig(**CFG))
    ts = one.init(torch.Generator().manual_seed(4),
                  cond_sampler=make_alt_band_sampler(*band))
    band_farms = {"reset": env_state_to_numpy(ts.env_state)}
    ts, _ = one.train_step(ts)
    band_farms["step"] = env_state_to_numpy(ts.env_state)
    band_generator = ts.generator.get_state().numpy()

    def update_epoch():
        want = flat_tree(jax.tree_util.tree_map(np.asarray, jp["params"]))
        for r in res:
            assert_close_trees(tree_of(r, "epoch/params"), want, rtol=1e-5, atol=2e-6)
            assert int(r["epoch/adam/count"]) == int(jo[1].count) == 3 + MB
            for part in ("mu", "nu"):
                assert_close_trees(tree_of(r, f"epoch/adam/{part}"),
                                   flat_tree(jax.tree_util.tree_map(
                                       np.asarray, getattr(jo[1], part)["params"])),
                                   rtol=1e-4, atol=1e-8)
            for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
                np.testing.assert_allclose(r[f"epoch/metric/{k}"], np.asarray(jm[k]),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
            stop = np.asarray(jm["approx_kl"]) >= 3e-6
            assert stop.any() and not stop.all(), np.asarray(jm["approx_kl"])
            assert np.array_equal(r["epoch/metric/approx_kl"] >= 3e-6, stop)
        for k, v in tree_of(res[0], "epoch/params").items():
            np.testing.assert_array_equal(v, res[1][f"epoch/params/{k}"], err_msg=k)

    def merge_stats():
        for r in res:
            for k in ("mean", "var", "count"):
                np.testing.assert_allclose(r[f"merge/{k}"], np.asarray(getattr(jmerged, k)),
                                           rtol=2e-5, atol=1e-6, err_msg=k)

    def train_step(case):
        one, ts, metrics = single[case]
        want = flat_tree(policy_to_numpy(ts.params))
        for r in res:
            assert_close_trees(tree_of(r, f"{case}/params"), want, rtol=2e-4, atol=2e-6)
            for k in ("mean", "var"):
                np.testing.assert_allclose(r[f"{case}/stats/{k}"],
                                           getattr(ts.obs_stats, k).numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
            assert sorted(k for k in tree_of(r, f"{case}/metric")) == sorted(metrics)
            for k in ("loss", "reward_mean", "approx_kl", "success_ep_frac"):
                np.testing.assert_allclose(r[f"{case}/metric/{k}"], float(metrics[k]),
                                           rtol=1e-3, atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r[f"{case}/generator"],
                                          ts.generator.get_state().numpy())
        farm = env_state_to_numpy(ts.env_state)
        np.testing.assert_array_equal(joined(res, f"{case}/farm/steps"), farm["steps"])
        np.testing.assert_array_equal(joined(res, f"{case}/farm/task_id"), farm["task_id"])
        np.testing.assert_allclose(joined(res, f"{case}/farm/heli"), farm["heli"],
                                   rtol=1e-3, atol=1e-4)

    def save_restore():
        one, ts, _ = single["hover"]
        path = str(tmp_path / "learner" / "sharded.npz")
        back = one.restore(path, one.init(torch.Generator().manual_seed(3)))
        farm = env_state_to_numpy(back.env_state)
        for k in farm:
            np.testing.assert_array_equal(farm[k], joined(res, f"hover/farm/{k}"), err_msg=k)
        for k, v in flat_tree(policy_to_numpy(back.params)).items():
            np.testing.assert_array_equal(v, res[0][f"hover/params/{k}"], err_msg=k)
        for k, v in flat_tree(adam_state_to_numpy(back.params, back.opt_state)).items():
            np.testing.assert_array_equal(v, res[0][f"hover/adam/{k}"], err_msg=k)
        assert back.update_count == 1
        np.testing.assert_array_equal(back.generator.get_state().numpy(),
                                      res[0]["hover/generator"])
        mine = jax_state(back)
        assert_leaves_equal(jckpt.load_npz(path, mine), mine)

    def randomized_resets():
        for when, farm in band_farms.items():
            for k, v in farm.items():
                got = joined(res, f"band/{when}/{k}")
                if v.dtype.kind == "i":
                    np.testing.assert_array_equal(got, v, err_msg=f"{when} {k}")
                else:
                    np.testing.assert_allclose(got, v, rtol=1e-3, atol=1e-4,
                                               err_msg=f"{when} {k}")
        for r in res:
            np.testing.assert_array_equal(r["band/generator"], band_generator)

    def torchrun_cli():
        ckpt = str(tmp_path / "cli.npz")
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=2", "-m", "heligym_tpu_torch.learner.train", "--cpu",
             "--task", "hover", "--num-envs", "16", "--rollout-steps", "8",
             "--updates", "1", "--epochs", "1", "--minibatches", "2", "--log-every", "1",
             "--eval-every", "1", "--eval-episodes", "4", "--max-time", "0.5",
             "--checkpoint", ckpt],
            cwd=REPO, capture_output=True, text=True, timeout=240,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stdout + out.stderr
        lines = out.stdout.splitlines()
        devices = [l for l in lines if l.startswith("devices:")]
        assert len(devices) == 1 and devices[0].startswith("devices: [cpu, cpu]  "), \
            out.stdout
        upd = [l for l in lines if l.startswith("update 1:")]
        assert len(upd) == 1, out.stdout
        # rank 0 alone evaluates; its success reaches every rank's choice
        evals = [l for l in lines if l.strip().startswith("eval @ update 1:")]
        assert len(evals) == 1, out.stdout
        nums = [float(x.split("=")[1]) for x in upd[0].split()[2:]]
        assert len(nums) == 6 and np.isfinite(nums).all(), upd
        # the checkpoint and its best copy (the evaluation's), from rank 0 only
        assert sorted(glob.glob(str(tmp_path / "*.npz"))) == [ckpt, ckpt + ".best.npz"]
        # both ranks' rows in the file: every env of the farm stepped 8 times
        cli = PPOLearner(single["hover"][0].env, PPOConfig(num_envs=16, rollout_steps=8))
        back = cli.restore(ckpt, with_farm=True)
        assert back.update_count == 1 and back.env_state.steps.tolist() == [8] * 16

    run_checks([("_update_epoch vs JAX", update_epoch), ("_merge_stats vs JAX", merge_stats),
                ("train_step hover, 1 vs 2 ranks", lambda: train_step("hover")),
                ("train_step MixedTask, 1 vs 2 ranks", lambda: train_step("mixed")),
                ("save on 2 ranks -> JAX load_npz, 1-rank restore", save_restore),
                ("randomized resets, 1 vs 2 ranks", randomized_resets),
                ("trainer under torch.distributed.run", torchrun_cli)])
