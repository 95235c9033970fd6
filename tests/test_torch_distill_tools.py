"""The command lines of the port's distillation path, on the CPU:
`python -m heligym_tpu_torch.learner.distill` and `tools/torch_tune_scripted.py`,
`torch_distill_scripted.py`, `torch_distill_multitask.py` and
`torch_distill_hybrid.py`. Each parser is held to its JAX source, read with
`ast` (the JAX tools are not run); each `main` runs once at a tiny size, the
episode wall cut to 0.4 s by patching `HeliEnv.build` (the JAX command lines
have no --max-time flag).

The file collects two tests, the parsers and the runs, each running all of
its checks before it reports every one that failed: a file of at most two
tests is handed out after every long file of the JAX package under
`--dist loadfile` (xdist orders files by their test count), so it cannot
delay one of them."""
import argparse
import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from heligym_tpu.learner import train as jtrain
from heligym_tpu.utils import checkpoint as jckpt

from heligym_tpu_torch.envs import HeliEnv, LandingTask
from heligym_tpu_torch.learner import PPOConfig, PPOLearner
from heligym_tpu_torch.learner import distill as tdistill
from heligym_tpu_torch.learner.evaluate import build_env
from heligym_tpu_torch.ops.cuda import fused_step as fs

from test_torch_distill import run_checks
from test_torch_ppo import assert_leaves_equal, jax_state
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
MAX_TIME = 0.4            # 20 steps to the time limit, 5 settled steps to succeed


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (port parser factory, JAX source) of each command line
CLIS = {
    "distill": (lambda: tdistill.build_parser(),
                os.path.join(REPO, "heligym_tpu", "learner", "distill.py")),
    **{name: (lambda name=name: load_tool("torch_" + name).build_parser(),
              os.path.join(REPO, "tools", name + ".py"))
       for name in ("tune_scripted", "distill_scripted", "distill_multitask",
                    "distill_hybrid")},
}
KEYS = ("default", "choices", "type", "action", "nargs", "required", "dest")


def _jax_flags(path):
    """{flag: {key: value}} of the add_argument calls in a JAX source."""
    tree = ast.parse(open(path).read())
    names = {"TASKS": dict.fromkeys(jtrain.TASKS), "sorted": sorted, "int": int,
             "float": float, "str": str}
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: eval(compile(ast.Expression(k.value), path, "eval"), names)
                  for k in node.keywords if k.arg in KEYS}
            flag = ast.literal_eval(node.args[0])
            kw.setdefault("dest", flag[2:].replace("-", "_"))
            kw.setdefault("required", False)
            if kw.get("action") == "store_true":
                kw.setdefault("default", False)
            elif kw.get("action") != "store_false":
                kw.setdefault("default", None)
            if "choices" in kw:
                kw["choices"] = list(kw["choices"])
            flags[flag] = kw
    return flags


def _port_flags(parser):
    flags = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        kw = {"default": a.default, "dest": a.dest, "required": a.required}
        if isinstance(a, argparse._StoreTrueAction):
            kw["action"] = "store_true"
        elif isinstance(a, argparse._StoreFalseAction):
            kw["action"] = "store_false"
        else:
            for k in ("choices", "type", "nargs"):
                v = getattr(a, k)
                if v is not None:
                    kw[k] = list(v) if k == "choices" else v
        flags[a.option_strings[0]] = kw
    return flags


def check_cli_flags_equal_jax(name):
    """The same flags with the same names, defaults, choices, types, nargs,
    destinations and required-ness as the JAX source. The one difference:
    the JAX tune tool runs on the CPU by default and takes --tpu; the
    port's, like every entry point of the port, runs on the card and takes
    --cpu."""
    make, path = CLIS[name]
    ours, theirs = _port_flags(make()), _jax_flags(path)
    if name == "tune_scripted":
        assert theirs.pop("--tpu") == {"dest": "cpu", "action": "store_false",
                                       "required": False}
        assert theirs["--cpu"]["default"] is True
        theirs["--cpu"]["default"] = False
    assert "--cpu" in ours and "--tpu" not in ours
    assert sorted(ours) == sorted(theirs)
    for flag, kw in theirs.items():
        assert ours[flag] == kw, flag


@pytest.fixture
def short_episodes(monkeypatch):
    """Every env the command lines build gets a 0.4 s episode wall."""
    build = HeliEnv.build.__func__
    monkeypatch.setattr(HeliEnv, "build", classmethod(
        lambda cls, *a, **k: build(cls, *a, **k).replace(max_time=MAX_TIME)))


@pytest.fixture(scope="module")
def near_trim(tmp_path_factory):
    """A fresh landing policy checkpoint (hidden 256, 256, the mean head's
    0.01-gain init, log_std -3, an 8-env farm): it flies near the trim, so
    that the envs started within a raised touch altitude succeed."""
    env = HeliEnv.build("aw109", task=LandingTask(), device="cpu")
    learner = PPOLearner(env, PPOConfig(num_envs=8, log_std_init=-3.0))
    path = str(tmp_path_factory.mktemp("near_trim") / "near_trim.npz")
    learner.save(path, learner.init(torch.Generator().manual_seed(0)))
    return path


def check_distill_main(tmp_path, capsys, near_trim):
    """Two rounds on 8 envs of the 6-20 ft band at touch_alt=ground+8: the
    JAX tool's lines, the metrics file, successful episodes cloned, the
    critic and log_std bit-equal to the input's, and the output read by the
    JAX package's `load_npz` against the template of its own config, every
    leaf equal to what the port restores."""
    out, metrics = str(tmp_path / "d.npz"), str(tmp_path / "d.json")
    tdistill.main(["--cpu", "--checkpoint", near_trim, "--target", "touch_alt=ground+8",
                   "--band", "6:20", "--episodes", "8", "--eval-episodes", "8",
                   "--rounds", "2", "--epochs", "2", "--minibatch", "64",
                   "--out", out, "--metrics-out", metrics])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 0 (input): det band success=")
    assert lines[1] == "  sampling log_std = [-3. -3. -3. -3.]"
    assert lines[2].startswith("round 1: collected 8 episodes, stochastic success=")
    assert any(line.startswith("round 2: bc_loss=") for line in lines)
    assert lines[-1].startswith(f"final: last round -> {out}; best det band success=")
    with open(metrics) as f:
        doc = json.load(f)
    assert set(doc) == {"config", "history"} and doc["config"]["cpu"]
    assert [h["round"] for h in doc["history"]] == [0, 1, 2]
    for h in doc["history"][1:]:
        assert 0.0 < h["stoch_success"] < 1.0 and np.isfinite(h["bc_loss"])
    learner = PPOLearner(HeliEnv.build("aw109", task=LandingTask(), device="cpu"),
                         PPOConfig(num_envs=4096))
    before = learner.restore(near_trim, with_farm=True)
    for path in (out, out + ".best.npz"):
        ts = learner.restore(path, with_farm=True)
        assert ts.env_state.steps.shape == (8,)
        assert_leaves_equal(jckpt.load_npz(path, jax_state(ts)), jax_state(ts))
        for a, b in ((ts.params.critic, before.params.critic),
                     (ts.params.value, before.params.value)):
            for x, y in zip(a.parameters(), b.parameters()):
                assert torch.equal(x, y)
        assert torch.equal(ts.params.log_std, before.params.log_std)
    assert not torch.equal(learner.restore(out).params.mean.weight,
                           before.params.mean.weight)


def check_tune_scripted_main(tmp_path, capsys, near_trim):
    """Two seeds of a 4-altitude grid with a gain override: a line per seed
    and the JSON summary, the --json-out file with the overridden gains."""
    path = str(tmp_path / "tune.json")
    out = load_tool("torch_tune_scripted").main(
        ["--cpu", "--envs", "4", "--band", "6:100", "--seeds", "0,1",
         "--set", "vmax=7", "--json-out", path])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("seed 0: succ=") and "band 6:55: succ=" in lines[1]
    summary = json.loads(lines[-1])
    assert set(summary) == {"mean_succ", "mean_fail"}
    with open(path) as f:
        doc = json.load(f)
    assert doc == out and doc["gains"]["vmax"] == 7.0 and doc["envs"] == 4
    assert [s["seed"] for s in doc["per_seed"]] == [0, 1]
    assert doc["mean_succ"] == summary["mean_succ"]


def check_distill_scripted_main(tmp_path, capsys, near_trim):
    """One BC round (the expert's episodes all time out in 0.4 s, so it
    stops: nothing to clone) and, in a second run, two DAgger rounds fitted
    on both rounds' data (--replay 2): every alive step of the student's
    rollouts labelled; the JAX tool's metrics keys."""
    out, metrics = str(tmp_path / "s.npz"), str(tmp_path / "s.json")
    tool = load_tool("torch_distill_scripted")
    common = ["--cpu", "--init", near_trim, "--band", "6:20", "--episodes", "8",
              "--eval-episodes", "4", "--epochs", "1", "--minibatch", "64",
              "--out", out, "--metrics-out", metrics]
    tool.main(common + ["--bc-rounds", "1", "--dagger-rounds", "0"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "round 1 [bc]: acting success=0.000, 0 labeled steps"
    assert lines[2] == "no labeled steps - stopping"
    history = tool.main(common + ["--bc-rounds", "0", "--dagger-rounds", "2",
                                  "--replay", "2"])
    lines = capsys.readouterr().out.splitlines()
    # without auto-reset every episode times out at step 19: 20 alive steps
    assert lines[1] == "round 1 [dagger]: acting success=0.000, 160 labeled steps"
    assert [h.get("phase") for h in history] == [None, "dagger", "dagger"]
    with open(metrics) as f:
        doc = json.load(f)
    assert set(doc) == {"history", "best", "args"} and doc["args"]["replay"] == 2
    assert all(np.isfinite(h["bc_loss"]) for h in doc["history"][1:])
    assert os.path.exists(out) and os.path.exists(out + ".best.npz")


def check_distill_multitask_main(tmp_path, capsys, near_trim):
    """Two committed experts, 6 collection steps of 8 envs each, a weighted
    fit and one DAgger round on one task: the per-task lines, the student's
    pooled statistics, the metrics file and the checkpoints."""
    out, metrics = str(tmp_path / "m.npz"), str(tmp_path / "m.json")
    history = load_tool("torch_distill_multitask").main(
        ["--cpu", "--experts", f"hover={EXAMPLES}/hover4k_policy.npz:4096,"
         f"forward={EXAMPLES}/forward_policy.npz:512", "--target", "sea_alt=start,vel=60",
         "--collect-steps", "6", "--collect-envs", "8", "--epochs", "2",
         "--minibatch", "32", "--task-loss-weights", "2,1", "--dagger-rounds", "1",
         "--dagger-tasks", "forward", "--out-num-envs", "8", "--eval-episodes", "8",
         "--seed", "63", "--out", out, "--metrics-out", metrics])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["task hover: +48 samples (expert-driven)",
                         "task forward: +48 samples (expert-driven)"]
    assert lines[2].startswith("round 0: bc_loss=")
    assert lines[3] == "task forward: +24 samples (student-driven)"
    assert lines[-1].startswith(f"saved {out}; best (min per-task ")
    assert [h["round"] for h in history] == [0, 1]
    assert {"success_frac_t0", "success_frac_t1"} <= set(history[-1])
    with open(metrics) as f:
        assert set(json.load(f)) == {"config", "history", "best_eval"}
    with pytest.raises(ValueError, match="not this learner's"):
        PPOLearner(HeliEnv.build("aw109", task=LandingTask(), device="cpu"),
                   PPOConfig(num_envs=8)).restore(out)
    env2, _ = build_env(tasks="hover,forward", target="sea_alt=start,vel=60",
                        device="cpu")
    ts = PPOLearner(env2, PPOConfig(num_envs=8)).restore(out, with_farm=True)
    assert ts.env_state.task_id.tolist() == [0, 1] * 4
    assert float(ts.obs_stats.count) == 5e6 and bool((ts.obs_stats.var > 1e-6).all())
    assert torch.equal(ts.params.log_std, torch.full((4,), -3.0))


def check_distill_hybrid_main(tmp_path, capsys, near_trim):
    """One round with the same policy as lander and descender (the blend is
    then that policy's own mean): the kept-sample line, a finite loss, the
    checkpoints; the step kernel's plain version ran (CPU)."""
    out, metrics = str(tmp_path / "h.npz"), str(tmp_path / "h.json")
    before = fs.launches
    history = load_tool("torch_distill_hybrid").main(
        ["--cpu", "--lander", f"{near_trim}:8", "--descender", f"{near_trim}:8",
         "--band", "6:20", "--episodes", "8", "--eval-episodes", "4", "--rounds", "1",
         "--epochs", "2", "--minibatch", "64", "--out", out, "--metrics-out", metrics])
    assert fs.launches == before            # CPU tensors: no kernel launch
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 0 (lander): det band success=")
    assert lines[1].startswith("  kept ") and lines[1].endswith("/184 finite samples")
    assert lines[-1].startswith("final best det band success=")
    assert [h["round"] for h in history] == [0, 1] and np.isfinite(history[1]["bc_loss"])
    with open(metrics) as f:
        assert set(json.load(f)) == {"config", "history"}
    assert os.path.exists(out) and os.path.exists(out + ".best.npz")


def test_cli_flags_equal_jax():
    """The five command lines' flags against their JAX sources."""
    run_checks([(name, lambda name=name: check_cli_flags_equal_jax(name))
                for name in sorted(CLIS)])


def test_mains_run_on_the_cpu(tmp_path, capsys, short_episodes, near_trim):
    """One CPU run of each command line's `main`, each in a directory of
    its own, the output of any earlier check discarded first."""
    def check(fn):
        def run():
            capsys.readouterr()
            path = tmp_path / fn.__name__
            path.mkdir()
            fn(path, capsys, near_trim)
        return fn.__name__, run
    run_checks([check(fn) for fn in (check_distill_main, check_tune_scripted_main,
                                     check_distill_scripted_main,
                                     check_distill_multitask_main,
                                     check_distill_hybrid_main)])
