"""The port's curriculum tools and demos, on the CPU:
tools/torch_widen_checkpoint.py, torch_stats_surgery.py, torch_respan_stats.py
and examples/torch_rollout_demo.py, torch_render_demo.py, torch_policy_demo.py.

Each parser is held to its JAX source, read with `ast`. Each tool runs once
on committed checkpoints. The JAX widening and re-span tools run beside the
port's on the same inputs (~15 s together), and the port's outputs must
equal theirs bit for bit in every parameter and statistic. The JAX stats
surgery costs ~20 s of trims on this box, so its arithmetic is replayed
here, on the checkpoint's statistics and the anchors' scaled values that
the port's tool found. Each demo's work runs at a tiny size.

The file collects two tests, each running all of its checks before it
reports every one that failed: a file of at most two tests is handed out
after every long file of the JAX package under `--dist loadfile`."""
import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

from heligym_tpu.utils import checkpoint as jckpt

from heligym_tpu_torch.envs import HeliEnv, MixedTask
from heligym_tpu_torch.learner import PPOConfig, PPOLearner
from heligym_tpu_torch.learner.train import TASKS, _parse_target
from heligym_tpu_torch.models import register_model_path, registry
from heligym_tpu_torch.utils.checkpoint import load_train_state_npz

from test_torch_distill import run_checks
from test_torch_distill_tools import _jax_flags, _port_flags
from test_torch_ppo import assert_leaves_equal, jax_state
from torch_airframes import NAME as WINGED, write_winged
from torch_trim_cache import fresh_trim_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tool(name, port=True):
    return load(os.path.join(REPO, "tools", ("torch_" if port else "") + name + ".py"),
                ("torch_" if port else "jax_") + name)


def demo(name):
    return load(os.path.join(EXAMPLES, f"torch_{name}.py"), f"torch_{name}")


# (port parser factory, JAX source) of each command line
CLIS = {
    **{name: (lambda name=name: tool(name).build_parser(),
              os.path.join(REPO, "tools", name + ".py"))
       for name in ("widen_checkpoint", "stats_surgery", "respan_stats")},
    **{name: (lambda name=name: demo(name).build_parser(),
              os.path.join(EXAMPLES, name + ".py"))
       for name in ("rollout_demo", "render_demo", "policy_demo")},
}


def check_flags_equal_jax(name):
    """The same flags with the same names, defaults, choices, types, nargs,
    actions, destinations and required-ness as the JAX source. The one
    difference: where the JAX command line has no --cpu (it runs on the
    CPU, or on JAX's default device), the port's takes --cpu, as every
    entry point of the port runs on the card unless asked."""
    make, path = CLIS[name]
    parser = make()
    ours, theirs = _port_flags(parser), _jax_flags(path)
    for a in parser._actions:
        if isinstance(a, argparse._AppendAction):
            ours[a.option_strings[0]]["action"] = "append"
    if "--cpu" not in theirs:
        assert ours.pop("--cpu") == {"default": False, "dest": "cpu", "required": False,
                                     "action": "store_true"}
    assert sorted(ours) == sorted(theirs)
    for flag, kw in theirs.items():
        assert ours[flag] == kw, flag


def test_flags_equal_jax():
    """The three tools' and the three demos' flags against their JAX
    sources."""
    run_checks([(name, lambda name=name: check_flags_equal_jax(name))
                for name in sorted(CLIS)])


def policy_arrays(path):
    """The network parameters and observation statistics of a checkpoint,
    flat: {"Dense_i/bias", ..., "log_std", "obs.mean", "obs.var",
    "obs.count"}."""
    ck = load_train_state_npz(path)
    out = {"log_std": ck["params"]["log_std"]}
    for name, leaf in ck["params"].items():
        if name != "log_std":
            out.update({f"{name}/{k}": v for k, v in leaf.items()})
    out.update({f"obs.{k}": v for k, v in ck["obs_stats"].items()})
    return out, ck["treedef"]


def assert_outputs_equal(ours, theirs):
    """Two checkpoints with the same treedef, every parameter and statistic
    bit-equal."""
    a, ta = policy_arrays(ours)
    b, tb = policy_arrays(theirs)
    assert ta == tb and sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def read_by_jax(path, learner):
    """The JAX package's `load_npz` reads the port's output against the
    template of the learner's configuration."""
    ts = learner.restore(path, with_farm=True)
    assert_leaves_equal(jckpt.load_npz(path, jax_state(ts)), jax_state(ts))
    return ts


def check_widen(tmp_path):
    """hover (512 envs) widened into hover+forward with forward's stats
    mixed in: the port's output equals the JAX tool's; JAX reads it; the
    widened policy acts as the source for every task id."""
    argv = ["--checkpoint", f"{EXAMPLES}/hover_policy.npz", "--task", "hover",
            "--train-num-envs", "512", "--tasks", "hover,forward",
            "--target", "sea_alt=start,vel=60", "--out-num-envs", "8",
            "--mix-stats-from", f"{EXAMPLES}/forward_policy.npz",
            "--mix-stats-task", "forward", "--mix-stats-num-envs", "512"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tool("widen_checkpoint").main(argv + ["--cpu", "--out", ours])
    tool("widen_checkpoint", port=False).main(argv + ["--out", theirs])
    assert_outputs_equal(ours, theirs)

    src_env = HeliEnv.build("aw109", task=TASKS["hover"](), device="cpu")
    dst_env = src_env.replace(task=MixedTask(tasks=(TASKS["hover"](), TASKS["forward"]())))
    updates = _parse_target("sea_alt=start,vel=60", src_env)
    pick = lambda t: t.with_target(**{k: v for k, v in updates.items()
                                      if k in t.target_dict()})
    src_env = src_env.replace(task=pick(src_env.task))
    dst_env = dst_env.replace(task=MixedTask(tasks=tuple(map(pick, dst_env.task.tasks))))
    src = PPOLearner(src_env, PPOConfig(num_envs=512))
    dst = PPOLearner(dst_env, PPOConfig(num_envs=8))
    ts_src = src.restore(f"{EXAMPLES}/hover_policy.npz")
    ts_dst = read_by_jax(ours, dst)
    assert ts_dst.env_state.task_id.tolist() == [0, 1] * 4
    _, obs0 = src_env.reset()
    sig = torch.sqrt(ts_src.obs_stats.var) * src._scales
    obs = obs0[None] + torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 17)).astype(np.float32)) * sig
    with torch.no_grad():
        want = src.policy(ts_src.params, obs, obs_stats=ts_src.obs_stats)
        for tid in range(2):
            got = dst.policy(ts_dst.params, obs, obs_stats=ts_dst.obs_stats,
                             task_oh=dst._task_oh(torch.full((16,), tid)))
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def check_respan(tmp_path):
    """forward (512 envs) re-spanned for oblique on two channels: the port's
    output equals the JAX tool's, which passed the JAX tool's identity
    check; JAX reads it."""
    argv = ["--checkpoint", f"{EXAMPLES}/forward_policy.npz", "--task", "oblique",
            "--target", "sea_alt=start,vel=60", "--train-num-envs", "512",
            "--respan", "9:0:1.0:3", "--respan", "5:0:1.8:3"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tool("respan_stats").main(argv + ["--cpu", "--out", ours])
    tool("respan_stats", port=False).main(argv + ["--out", theirs])
    assert_outputs_equal(ours, theirs)
    env = HeliEnv.build("aw109", task=TASKS["oblique"](), device="cpu")
    env = env.replace(task=env.task.with_target(**_parse_target("sea_alt=start,vel=60", env)))
    read_by_jax(ours, PPOLearner(env, PPOConfig(num_envs=512)))


def check_stats_surgery(tmp_path):
    """landing25 (1024 envs), obs[16] re-spanned to 6-120 ft: the output's
    statistics are the JAX tool's arithmetic on the checkpoint's statistics
    and the anchors the port found; z(anchor) is preserved; every parameter
    is the checkpoint's; JAX reads it."""
    src, out = f"{EXAMPLES}/landing25_policy.npz", str(tmp_path / "ours.npz")
    res = tool("stats_surgery").main(["--cpu", "--checkpoint", src, "--out", out,
                                      "--train-num-envs", "1024"])
    # tools/stats_surgery.py's arithmetic, on the same arrays
    i, top_z = 16, 9.0
    stats = load_train_state_npz(src)["obs_stats"]
    m, v = np.asarray(stats["mean"]).copy(), np.asarray(stats["var"]).copy()
    x_lo, x_hi = res["x_lo"], res["x_hi"]
    z_lo_old = (x_lo - m[i]) / np.sqrt(v[i] + 1e-8)
    s_new = (x_hi - x_lo) / (top_z - z_lo_old)
    m[i] = x_lo - z_lo_old * s_new
    v[i] = s_new ** 2
    got, _ = policy_arrays(out)
    np.testing.assert_array_equal(got["obs.mean"], m)
    np.testing.assert_array_equal(got["obs.var"], v)
    # preserved up to the normalization's 1e-8 variance floor, which the
    # surgery leaves out (v = s**2): ~6e-4 here, as the JAX tool prints it
    assert abs((x_lo - m[i]) / np.sqrt(v[i] + 1e-8) - z_lo_old) < 2e-3
    before, _ = policy_arrays(src)
    for k in before:
        if not k.startswith("obs."):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
    env = HeliEnv.build("aw109", task=TASKS["landing"](), device="cpu")
    env = env.replace(task=env.task.with_target(**_parse_target("touch_alt=ground", env)))
    read_by_jax(out, PPOLearner(env, PPOConfig(num_envs=1024)))


def check_rollout_demo(tmp_path, capsys):
    """The demo's work on the plain versions (8 envs, 20 steps), fused and
    eager, and on a user airframe through --heli; its command line's
    lines."""
    mod = demo("rollout_demo")
    for fused in (True, False):
        res = mod.run(num_envs=8, steps=20, fused=fused, device="cpu")
        assert res["rewards"].shape == (20, 8) and res["env_steps"] == 160
        assert bool(torch.isfinite(res["rewards"]).all()) and res["device"] == "cpu"
    write_winged(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "_SEARCH_PATHS", list(registry._SEARCH_PATHS))
        register_model_path(str(tmp_path))
        winged = mod.run(num_envs=8, steps=20, fused=True, heli=WINGED, device="cpu")
        capsys.readouterr()
        mod.main(["--cpu", "--num-envs", "4", "--steps", "5", "--fused", "--heli", WINGED])
    assert bool(torch.isfinite(winged["rewards"]).all())
    assert not torch.equal(winged["state"].obs, res["state"].obs)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "solving trim..." and lines[1].startswith("20 env-steps in ")
    assert lines[2].startswith("mean reward ") and lines[3].startswith("final altitude")


def check_render_demo(tmp_path, capsys):
    """Frames of 4 steps, every 2nd; the GIF of the command line."""
    mod = demo("render_demo")
    frames = mod.render_frames(steps=4, every=2, device="cpu")
    assert len(frames) == 2 and frames[0].dtype == np.uint8 and frames[0].ndim == 3
    out = str(tmp_path / "hover.gif")
    capsys.readouterr()
    mod.main(["--cpu", "--steps", "2", "--every", "1", "--out", out])
    assert os.path.getsize(out) > 0
    assert capsys.readouterr().out.startswith(f"wrote {out}: 2 frames ")


def check_policy_demo(tmp_path, capsys):
    """The committed hover policy for 10 steps: two frames, finite rewards,
    the JAX demo's lines."""
    out = str(tmp_path / "policy.gif")
    capsys.readouterr()
    res = demo("policy_demo").main(
        ["--cpu", "--checkpoint", f"{EXAMPLES}/hover_policy.npz", "--num-envs", "512",
         "--target", "sea_alt=start", "--steps", "10", "--every", "5", "--out", out])
    assert len(res["frames"]) == 2 and len(res["rewards"]) == 10
    assert np.all(np.isfinite(res["rewards"])) and os.path.getsize(out) > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"wrote {out}: 2 frames; mean reward ")
    assert lines[1].startswith("no gear contact (min skid height ")


def test_tools_and_demos_run_on_the_cpu(tmp_path, capsys):
    """One CPU run of each tool and each demo, each in a directory of its
    own."""
    def check(fn, *extra):
        def run():
            path = tmp_path / fn.__name__
            path.mkdir()
            fn(path, *extra)
        return fn.__name__, run
    run_checks([check(check_widen), check(check_respan), check(check_stats_surgery),
                check(check_rollout_demo, capsys), check(check_render_demo, capsys),
                check(check_policy_demo, capsys)])
