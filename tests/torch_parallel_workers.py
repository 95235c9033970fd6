"""The ranks of tests/test_torch_parallel.py's multi-process checks.

`spawn(fn, world, tmp_path, payload)` starts `world` processes with
`torch.multiprocessing.spawn`; each joins a gloo group that meets in a file
under `tmp_path`, runs `fn(rank, world, payload, out)` on the CPU with its
rows of the farm, and writes what `fn` returns (a dict of numpy arrays and
numbers) to `out/rank<r>.npz`. The test reads every rank's file back and
holds it against the single-process run and the JAX package. These
functions import no JAX: they are the port as a multi-process run uses it.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.multiprocessing as mp


def _flat(prefix, tree, out):
    """A nested dict of arrays as flat `prefix/key/...` entries of `out`."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _entry(rank, fn, world, tmp, payload):
    import torch.distributed as dist
    from heligym_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(tmp, 'store')}", world, rank, cpu=True)
    try:
        res = fn(rank, world, payload, tmp)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, payload):
    """Run `fn` on `world` gloo ranks; returns each rank's results."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(fn, world, tmp, payload), nprocs=world, join=True)
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def hover_env():
    from heligym_tpu_torch.envs import HeliEnv, HoverTask
    return HeliEnv.build("aw109", task=HoverTask(), device="cpu")


# -- the farm ------------------------------------------------------------------

def farm(rank, world, payload, tmp):
    """The mesh, the divisibility check, a 16-env farm stepped 20 times, a
    32-env `rollout_fn` of 10 steps and its last step's `farm_metrics`, and
    `build_sharded_fused_rollout` over `payload["eta"]`."""
    from heligym_tpu_torch.parallel import (EnvFarm, env_sharding, farm_metrics,
                                            make_env_mesh, make_train_mesh,
                                            replicated_sharding, shard_env_state)
    from heligym_tpu_torch.parallel.farm import build_sharded_fused_rollout
    from heligym_tpu_torch.ops.cuda import fused_step as fs

    mesh = make_env_mesh()
    train_mesh = make_train_mesh()
    res = {"mesh_size": mesh.size(), "mesh_names": np.array(mesh.mesh_dim_names),
           "train_mesh_shape": np.array(train_mesh.shape),
           "train_mesh_names": np.array(train_mesh.mesh_dim_names),
           "placements": np.array([str(env_sharding(mesh)), str(replicated_sharding(mesh)),
                                   str(env_sharding(train_mesh))])}
    env = hover_env()
    for name, build in (("farm", lambda: EnvFarm.build(env, 15, mesh=mesh)),
                        ("learner", lambda: _learner({"cfg": {"num_envs": 15}}, mesh))):
        try:
            build()
            res[f"{name}_divisibility_raised"] = False
        except ValueError:
            res[f"{name}_divisibility_raised"] = True
    trim = env.trim_result().action

    f16 = EnvFarm.build(env, 16, mesh=mesh)
    es, _ = f16.reset()
    # the rows of a 16-env farm that shard_env_state keeps, by their steps
    whole, _ = EnvFarm.build(env, 16).reset()
    whole = whole.replace(steps=torch.arange(16, dtype=torch.int32))
    res["shard_rows"] = fs.pack(shard_env_state(whole, mesh))[0].numpy()
    step = f16.step_fn()
    gen = torch.Generator().manual_seed(9)
    for _ in range(20):
        es, out = step(es, trim.expand(f16.venv.num_envs, 4), gen)
    res["step_obs"] = out.obs.numpy()
    res["step_carry"] = fs.pack(es)[0].numpy()

    f32 = EnvFarm.build(env, 32, mesh=mesh)
    es, _ = f32.reset()
    roll = f32.rollout_fn(lambda p, obs: trim.expand(obs.shape[0], 4), steps=10)
    _, outs = roll(es, None, torch.Generator().manual_seed(2))
    for f in dataclasses.fields(outs):
        res[f"roll_{f.name}"] = getattr(outs, f.name).numpy()
    last = outs.__class__(**{f.name: getattr(outs, f.name)[-1]
                             for f in dataclasses.fields(outs)})
    for k, v in farm_metrics(last, mesh).items():
        res[f"metric_{k}"] = v.numpy()

    eta = torch.from_numpy(payload["eta"])
    n = eta.shape[-1]
    big = EnvFarm.build(env, n, mesh=mesh)
    es, _ = big.reset()
    run = build_sharded_fused_rollout(env, n, eta.shape[0], mesh=mesh)
    es, o = run(es, trim.expand(big.venv.num_envs, 4), eta_seq=eta)
    res.update(sharded_reward=o["reward"].numpy(), sharded_done=o["done"].numpy(),
               sharded_steps=es.steps.numpy(), sharded_heli=es.heli.flatten().numpy())
    return res


# -- the learner -----------------------------------------------------------------

def _learner(payload, mesh, **kw):
    from heligym_tpu_torch.envs import HeliEnv, HoverTask, LandingTask, MixedTask
    from heligym_tpu_torch.learner import PPOConfig, PPOLearner
    task = (MixedTask(tasks=(HoverTask(), LandingTask())) if kw.pop("mixed", False)
            else HoverTask())
    env = HeliEnv.build("aw109", task=task, device="cpu")
    return PPOLearner(env, PPOConfig(**{**payload["cfg"], **kw}), mesh=mesh)


def learner(rank, world, payload, tmp):
    """This rank's `_update_epoch` and `_merge_stats` on its columns of the
    test's rollout, one `train_step` on hover and on a 2-task MixedTask from
    seeded states, a `save` of the hover state, and a hover farm from
    randomized resets (`payload["band"]`'s altitude band) before and after
    one `train_step`."""
    from heligym_tpu_torch.convert import (adam_state_to_numpy, env_state_to_numpy,
                                           policy_to_numpy)
    from heligym_tpu_torch.learner import ObsStats, Transition
    from heligym_tpu_torch.learner import optim
    from heligym_tpu_torch.learner.train import make_alt_band_sampler
    from heligym_tpu_torch.parallel import make_env_mesh

    mesh = make_env_mesh()
    res = {}
    ep = payload["epoch"]
    tl = _learner(payload, mesh, vf_clip_eps=0.2, target_kl=3e-6)
    cols = lambda a: np.ascontiguousarray(a[:, tl.rows])        # (T, B, ...) -> rank's
    flat = lambda a: torch.from_numpy(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]))
    T, B = ep["adv"].shape
    net = tl.make_network(torch.Generator().manual_seed(ep["net_seed"]))
    start = optim.AdamState(count=torch.tensor(3, dtype=torch.int32),
                            mu=[torch.from_numpy(m) for m in ep["mu"]],
                            nu=[torch.from_numpy(m) for m in ep["nu"]])
    stats = ObsStats(**{k: torch.from_numpy(np.asarray(v)) for k, v in ep["stats"].items()})
    traj = Transition(**{k: flat(cols(v)) for k, v in ep["traj"].items()})
    state, m = tl._update_epoch(net, start, traj, flat(cols(ep["adv"])),
                                flat(cols(ep["ret"])), stats, ep["ent"], ep["lr"],
                                torch.tensor(ep["cap"]), None,
                                idx=torch.from_numpy(ep["perm"]))
    _flat("epoch/params", policy_to_numpy(net), res)
    _flat("epoch/adam", adam_state_to_numpy(net, state), res)
    for k, v in m.items():
        res[f"epoch/metric/{k}"] = v.numpy()

    merged = tl._merge_stats(stats, torch.from_numpy(cols(payload["merge_obs"])))
    for k in ("mean", "var", "count"):
        res[f"merge/{k}"] = getattr(merged, k).numpy()

    for case in ("hover", "mixed"):
        tl = _learner(payload, mesh, mixed=case == "mixed")
        ids = np.arange(tl.config.num_envs) % 2 if case == "mixed" else None
        ts = tl.init(torch.Generator().manual_seed(0), task_ids=ids)
        ts, metrics = tl.train_step(ts)
        _flat(f"{case}/params", policy_to_numpy(ts.params), res)
        for k in ("mean", "var", "count"):
            res[f"{case}/stats/{k}"] = getattr(ts.obs_stats, k).numpy()
        for k, v in metrics.items():
            res[f"{case}/metric/{k}"] = v.numpy()
        for k, v in env_state_to_numpy(ts.env_state).items():
            res[f"{case}/farm/{k}"] = v
        res[f"{case}/generator"] = ts.generator.get_state().numpy()
        if case == "hover":
            _flat("hover/adam", adam_state_to_numpy(ts.params, ts.opt_state), res)
            tl.save(os.path.join(tmp, "sharded.npz"), ts)

    tl = _learner(payload, mesh)
    ts = tl.init(torch.Generator().manual_seed(4),
                 cond_sampler=make_alt_band_sampler(*payload["band"]))
    for k, v in env_state_to_numpy(ts.env_state).items():
        res[f"band/reset/{k}"] = v
    ts, _ = tl.train_step(ts)
    for k, v in env_state_to_numpy(ts.env_state).items():
        res[f"band/step/{k}"] = v
    res["band/generator"] = ts.generator.get_state().numpy()
    return res
