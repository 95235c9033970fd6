"""The port's trainer command line, its start-condition samplers and the
randomized farm they start, the evaluator's start-condition grid and the
periodic evaluation of `PPOLearner.train`, on the CPU. The command line is held to the JAX
package's, read from its source with `ast` (the JAX trainer is not run)."""
import argparse
import ast
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from heligym_tpu.learner import train as jtrain

from heligym_tpu_torch.envs import (HeliEnv, HoverTask, LandingTask, MixedTask,
                                    VectorHeliEnv)
from heligym_tpu_torch.learner import PPOConfig, PPOLearner
from heligym_tpu_torch.learner import evaluate as tevaluate, train as ttrain
from heligym_tpu_torch.ops import dryden
from heligym_tpu_torch.ops.cuda import fused_step as fs
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TRAIN = os.path.join(REPO, "heligym_tpu", "learner", "train.py")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "examples", "*_training_metrics.json")))
SAMPLERS = {
    "default": ttrain.default_cond_sampler,
    "alt_band": ttrain.make_alt_band_sampler(6.0, 55.0),
    "yaw_band": ttrain.make_yaw_band_sampler(-3.0, 3.0, alt_band=(50.0, 150.0)),
    "alt_grid": ttrain.make_alt_grid_sampler(6.0, 55.0),
}
# (field, low, high) each sampler's draws must lie in
RANGES = {
    "default": [("yaw", -np.pi, np.pi), ("gr_alt", 50.0, 2000.0),
                ("xy", -3000.0, 3000.0), ("psi_mr", 0.0, 2 * np.pi),
                ("psi_tr", 0.0, 2 * np.pi)],
    "alt_band": [("gr_alt", 6.0, 55.0)],
    "yaw_band": [("yaw", -3.0, 3.0), ("gr_alt", 50.0, 150.0)],
    "alt_grid": [("gr_alt", 6.0, 55.0)],
}
SHAPES = {"yaw": (), "yaw_rate": (), "ned_vel": (3,), "gr_alt": (), "xy": (2,),
          "psi_mr": (), "psi_tr": ()}


# -- the samplers ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_shapes_and_ranges(name):
    n = 64
    c = SAMPLERS[name](torch.Generator().manual_seed(2), n)
    assert set(c) == set(SHAPES)
    for k, shape in SHAPES.items():
        assert c[k].shape == (n,) + shape and c[k].dtype == torch.float32, k
    for k, lo, hi in RANGES[name]:
        v = c[k].numpy()
        assert ((lo <= v) & (v <= hi)).all(), k
        assert len(np.unique(v.round(1))) > 10, k       # actually spread
    if name == "default":
        speed = torch.linalg.vector_norm(c["ned_vel"], dim=-1).numpy()
        assert (speed <= 50.0 + 1e-3).all() and speed.std() > 5.0
        assert not c["yaw_rate"].any() and not c["ned_vel"][:, 2].any()
    else:
        for k in ("yaw_rate", "ned_vel", "xy", "psi_mr", "psi_tr"):
            assert not c[k].any(), k


def test_yaw_band_without_alt_band_keeps_100ft():
    c = ttrain.make_yaw_band_sampler(0.0, 1.0)(torch.Generator().manual_seed(1), 4)
    np.testing.assert_array_equal(c["gr_alt"].numpy(), np.full(4, 100.0, np.float32))


def test_alt_grid_is_linspace_and_ignores_generator():
    grid = ttrain.make_alt_grid_sampler(6.0, 55.0)
    a = grid(torch.Generator().manual_seed(0), 256)["gr_alt"].numpy()
    b = grid(torch.Generator().manual_seed(1), 256)["gr_alt"].numpy()
    np.testing.assert_array_equal(a, np.linspace(6.0, 55.0, 256).astype(np.float32))
    np.testing.assert_array_equal(a, b)
    # the JAX package's grid, which jnp.linspace computes in float32: within
    # two float32 roundings of each value
    ref = np.asarray(jtrain.make_alt_grid_sampler(6.0, 55.0)(jax.random.PRNGKey(0),
                                                             256)["gr_alt"])
    np.testing.assert_allclose(a, ref, rtol=2 * 2 ** -23, atol=0)


# -- randomized resets ----------------------------------------------------------

def test_reset_randomized_per_env_snapshots():
    """A randomized farm: each env starts at, and auto-resets to, its own
    trim. A full-down collective drives the envs into the ground and a 1 s
    episode wall ends the others; on the step an env ends, the plain fused
    step puts its own snapshot's rows back."""
    n = 6
    env = HeliEnv.build("aw109", task=HoverTask(), max_time=1.0, device="cpu")
    venv = VectorHeliEnv(env, n)
    es, obs = venv.reset_randomized(torch.Generator().manual_seed(3),
                                    ttrain.make_alt_band_sampler(6.0, 55.0))
    gr_alt = obs[:, 16] - env.params.HELI.WL_CG / 12.0
    assert ((gr_alt > 6.0 - 1e-3) & (gr_alt < 55.0 + 1e-3)).all()
    assert len(set(np.round(gr_alt.numpy(), 3))) == n
    assert torch.equal(es.init.heli.flatten(), es.heli.flatten())
    assert torch.equal(es.init.obs, es.obs)
    assert not bool(es.wind.flatten().any()) and not bool(es.steps.any())
    mean = dryden.mean_wind(env.wind_params)
    assert torch.equal(es.wind_ned, mean.expand(n, 3))
    assert es.heli.z.data_ptr() != es.init.heli.z.data_ptr()

    carry, init = fs.pack(es)
    act = torch.zeros((n, 4))
    act[:, 0] = -1.0
    eta = torch.zeros((3, n))
    ended = torch.zeros(n, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(env.time_up_steps):
            carry, x = fs.fused_step_plain(env, carry, init, act, eta)
            now = (x[fs.CDONE] != 0) | (x[fs.CTRUNC] != 0)
            if now.any():
                assert torch.equal(carry[:fs.SROWS, now], init[:fs.SROWS, now])
                assert not bool(carry[fs.STEPS, now].any())
            ended |= now
            if ended.all():
                break
    assert ended.all(), "the dive did not end every episode"


# -- the evaluator's start conditions --------------------------------------------

@pytest.fixture(scope="module")
def hover():
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=4, rollout_steps=2, hidden=(16, 16)))
    return env, learner, learner.init(torch.Generator().manual_seed(6))


def test_evaluator_cond_sampler_grid(hover):
    """The evaluator takes a cond_sampler (the batched Newton trim) and
    returns per-episode stats over the grid, each episode from its own
    start altitude."""
    env, learner, ts = hover
    grid = ttrain.make_alt_grid_sampler(40.0, 120.0)
    ev = tevaluate.make_evaluator(env, learner, episodes=4, steps=6, cond_sampler=grid)
    r = ev(ts, torch.Generator().manual_seed(7))
    assert r["episodes"] == 4
    for key in ("success_frac", "fail_frac", "timeout_frac"):
        assert 0.0 <= r[key] <= 1.0
    es, obs = learner.venv.reset_randomized(torch.Generator(), grid)
    alt = obs[:, 16] - env.params.HELI.WL_CG / 12.0
    np.testing.assert_allclose(alt.numpy(), np.linspace(40.0, 120.0, 4), atol=1e-3)


def test_evaluate_cli_start_band_excludes_start_alt(capsys):
    with pytest.raises(SystemExit) as e:
        tevaluate.main(["--checkpoint", "x.npz", "--cpu", "--start-band", "6:55",
                        "--start-alt", "25"])
    assert e.value.code == 2
    assert "--start-band and --start-alt are mutually exclusive" in capsys.readouterr().err


def test_train_periodic_evaluation_mixed_task(tmp_path, monkeypatch):
    """`train(eval_every=...)` on a MixedTask from a randomized farm: the
    evaluator's episodes are split over the sub-tasks, every evaluation
    lands in the metrics with its per-task fractions, and the best and last
    checkpoints are written. Every evaluation starts from a generator
    seeded with 1234 afresh; the best checkpoint follows the worst
    sub-task's success (here scripted so that it differs from the mean's
    choice), and the training success fraction is not tracked beside it."""
    env = HeliEnv.build("aw109", task=MixedTask(tasks=(HoverTask(), LandingTask())),
                        max_time=0.5, device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=4, rollout_steps=2, epochs=1,
                                        minibatches=1, hidden=(16, 16)))
    # per update: the two sub-tasks' success; min picks update 2, the mean update 1
    scripted = [(1.0, 0.0), (0.25, 0.5), (0.75, 0.0)]
    gen_states, real = [], []
    make_evaluator = tevaluate.make_evaluator

    def spy(*args, **kwargs):
        ev = make_evaluator(*args, **kwargs)

        def run(ts, generator):
            gen_states.append(generator.get_state())
            r = ev(ts, generator)
            real.append(r)
            t0, t1 = scripted[len(real) - 1]
            return {**r, "success_frac": (t0 + t1) / 2, "success_frac_t0": t0,
                    "success_frac_t1": t1}
        return run
    monkeypatch.setattr(tevaluate, "make_evaluator", spy)
    train_step = learner.train_step

    def step(ts, graphed=None):
        ts, m = train_step(ts, graphed)
        # a training success the best-tracking must ignore while evaluating
        return ts, {**m, "success_ep_frac": torch.tensor(1.0 if ts.update_count == 3
                                                         else 0.0)}
    monkeypatch.setattr(learner, "train_step", step)
    ck = str(tmp_path / "ck.npz")
    ts, hist = learner.train(torch.Generator().manual_seed(0), num_updates=3,
                             log_every=1, task_ids=np.arange(4) % 2, checkpoint_path=ck,
                             eval_every=1, eval_episodes=4,
                             cond_sampler=ttrain.make_alt_band_sampler(50.0, 60.0))
    assert [h["update"] for h in hist] == [1, 2, 3]
    for h, r, (t0, t1) in zip(hist, real, scripted):
        for k in ("eval_success_frac", "eval_fail_frac", "eval_timeout_frac",
                  "eval_success_frac_t0", "eval_success_frac_t1"):
            assert 0.0 <= h[k] <= 1.0, k
        assert (h["eval_success_frac_t0"], h["eval_success_frac_t1"]) == (t0, t1)
        assert h["eval_fail_frac"] == r["fail_frac"]
        for k in ("success_frac", "success_frac_t0", "success_frac_t1"):
            assert 0.0 <= r[k] <= 1.0, k
    fresh = torch.Generator().manual_seed(1234).get_state()
    assert len(gen_states) == 3 and all(torch.equal(g, fresh) for g in gen_states)
    assert os.path.exists(ck) and os.path.exists(ck + ".best.npz")
    assert learner.restore(ck + ".best.npz", ts).update_count == 2
    assert learner.restore(ck, ts).update_count == 3


# -- the command line -------------------------------------------------------------

def _jax_flags():
    """{flag: {"default", "choices", "type", "action"}} of the JAX trainer's
    add_argument calls, read from its source."""
    tree = ast.parse(open(JAX_TRAIN).read())
    tasks = next(n for n in tree.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "TASKS")
    names = {"TASKS": dict.fromkeys(ast.literal_eval(k) for k in tasks.value.keys),
             "sorted": sorted, "int": int, "float": float, "str": str}
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: eval(compile(ast.Expression(k.value), JAX_TRAIN, "eval"), names)
                  for k in node.keywords if k.arg in ("default", "choices", "type",
                                                      "action")}
            flags[ast.literal_eval(node.args[0])] = kw
    return flags


def _port_flags():
    flags = {}
    for a in ttrain.build_parser()._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        kw = {"default": a.default}
        if isinstance(a, argparse._StoreTrueAction):
            kw["action"] = "store_true"
        else:
            if a.choices is not None:
                kw["choices"] = list(a.choices)
            if a.type is not None:
                kw["type"] = a.type
        flags[a.option_strings[0]] = kw
    return flags


def test_cli_flags_equal_jax():
    """The same 54 flags: names, defaults, choices and types."""
    ours, theirs = _port_flags(), _jax_flags()
    assert len(theirs) == 54
    assert sorted(ours) == sorted(theirs)
    for flag, kw in theirs.items():
        kw = {**kw}
        if kw.get("action") == "store_true":
            kw.setdefault("default", False)
        else:
            kw.setdefault("default", None)
        if "choices" in kw:
            kw["choices"] = list(kw["choices"])
        assert ours[flag] == kw, flag


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_committed_configs_are_port_flags(path):
    with open(path) as f:
        doc = json.load(f)
    if "config" not in doc:
        assert "stages" in doc
        return
    dests = {a.dest for a in ttrain.build_parser()._actions}
    assert set(doc["config"]) <= dests


def test_cli_cpu_run(tmp_path, capsys):
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "metrics.json")
    ttrain.main(["--cpu", "--task", "landing", "--num-envs", "8", "--rollout-steps", "4",
                 "--updates", "2", "--epochs", "1", "--minibatches", "2",
                 "--rand-start-alt", "6:55", "--eval-start-band", "--eval-every", "1",
                 "--eval-episodes", "4", "--max-time", "0.5", "--checkpoint", ck,
                 "--metrics-out", out])
    with open(out) as f:
        doc = json.load(f)
    assert doc["config"]["rand_start_alt"] == "6:55" and doc["config"]["cpu"]
    assert [h["update"] for h in doc["history"]] == [2]
    assert 0.0 <= doc["history"][-1]["eval_success_frac"] <= 1.0
    assert all(np.isfinite(v) for v in doc["history"][-1].values())
    assert os.path.exists(ck) and os.path.exists(ck + ".best.npz")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("devices: [cpu]  task: landing@T0.5  envs: 8")
    assert any(line.startswith("  eval @ update 2: det success=") for line in lines)
    assert lines[-1].startswith("trained 64 env-steps in ")


def test_cli_eval_start_band_needs_rand_start_alt(capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--cpu", "--eval-start-band"])
    assert e.value.code == 2
    assert ("--eval-start-band requires --rand-start-alt LO:HI"
            in capsys.readouterr().err)


@pytest.mark.parametrize("weights,message", [
    ("1", "--task-weights needs one weight per task"),
    ("1,0", "--task-weights values must be positive integers")])
def test_cli_task_weights_checks(weights, message, capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--cpu", "--tasks", "hover,landing", "--task-weights", weights])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
