"""The port's `utils/profiling.py` and `utils/checkpoint.py` counterparts of
the JAX package's helpers, on the CPU: `Timer`, `time_fn`, `StepsMeter`,
`trace`, `debug_nans`; `save_npz`/`load_npz` against a template and
`save_pytree`/`restore_pytree`, with files of either package.

The file collects two tests, each running all of its checks before it
reports every one that failed: a file of at most two tests is handed out
after every long file of the JAX package under `--dist loadfile`. The card
sides (`trace` naming the step kernel, a farm on the card saved and
restored) are in test_torch_cuda.py."""
import glob
import json
import time

import jax
import numpy as np
import pytest
import torch

from heligym_tpu.envs import VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.utils import checkpoint as jckpt

from heligym_tpu_torch.convert import env_state_to_numpy
from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv
from heligym_tpu_torch.ops.cuda import fused_step as fs
from heligym_tpu_torch.utils import checkpoint as ckpt
from heligym_tpu_torch.utils import profiling

from test_torch_distill import run_checks
from test_torch_tasks import jax_state_to_numpy
from torch_trim_cache import fresh_trim_cache  # noqa: F401

B = 4


def check_timers():
    """`Timer` and `time_fn` time what they run (warm-up calls untimed);
    `StepsMeter` counts env steps over its clock and restarts on reset."""
    with profiling.Timer() as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 1.0
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        time.sleep(0.01)
        return torch.ones(3) * scale
    sec = profiling.time_fn(fn, 1, iters=3, warmup=2, scale=2.0)
    assert len(calls) == 5 and 0.01 <= sec < 0.5
    assert profiling.time_fn(fn, 2, iters=1, warmup=0) >= 0.01 and len(calls) == 6
    meter = profiling.StepsMeter()
    meter.add(1000)
    time.sleep(0.01)
    assert 0.0 < meter.steps_per_sec < 1000 / 0.01
    meter.reset()
    assert meter.steps_per_sec == 0.0


def check_trace(tmp_path):
    """`trace` writes one Chrome trace into its directory, naming the ops
    it ran, and yields the profile."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.linspace(0.0, 1.0, 64).exp()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::exp" in names and "aten::linspace" in names
    assert any(ev.key == "aten::exp" for ev in prof.key_averages())


def check_debug_nans():
    """`debug_nans` raises FloatingPointError at the op that made a NaN or
    an infinity, lets finite work through, can be switched off inside an
    enabled scope, and leaves the state before it on exit."""
    neg = torch.tensor([-1.0, 2.0])
    with profiling.debug_nans():
        assert torch.isfinite(torch.log(neg.abs())).all()
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(neg)
        with profiling.debug_nans(False):
            assert torch.log(neg).isnan()[0]
        with pytest.raises(FloatingPointError):
            neg / torch.zeros(2)
        torch.empty(8)                   # uninitialised memory is not checked
    assert torch.log(neg).isnan()[0]     # restored: no check
    with pytest.raises(FloatingPointError):
        with profiling.debug_nans():
            torch.log(neg)
    assert torch.log(neg).isnan()[0] and profiling._nan_checks == [False]


def test_profiling_helpers(tmp_path):
    run_checks([("timers", check_timers), ("trace", lambda: check_trace(tmp_path)),
                ("debug_nans", check_debug_nans)])


@pytest.fixture(scope="module")
def farm():
    """A 4-env port farm stepped 5 times from the hover trim, its generator
    and what one more step with fixed noise gives."""
    env = HeliEnv.build("aw109", task=HoverTask(), device="cpu")
    venv = VectorHeliEnv(env, B)
    tr = env.trim_result()
    es, _ = venv.reset_from_trim(tr)
    act = tr.action.expand(B, 4).contiguous()
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        es, _ = venv.step(es, act + 0.05 * torch.randn(B, 4, generator=gen), gen)
    eta = torch.randn(B, 3, generator=gen)
    return venv, es, act, eta


def assert_state_equal(a, b):
    """Two EnvStates with every leaf bit-equal, of the same dtype."""
    la, lb = ckpt.flatten(a)[1], ckpt.flatten(b)[1]
    assert len(la) == len(lb) == 90
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def check_port_round_trips(farm, tmp_path):
    """The farm through `save_npz`/`load_npz` and `save_pytree`/
    `restore_pytree` against itself: bit-equal, the template's dtypes, and
    one more step from each restore equal to the original's."""
    venv, es, act, eta = farm
    ckpt.save_npz(str(tmp_path / "farm.npz"), es)
    ckpt.save_pytree(str(tmp_path / "farm.pt"), es)
    _, want = venv.step_with_eta(es, act, eta)
    for restored in (ckpt.load_npz(str(tmp_path / "farm.npz"), es),
                     ckpt.restore_pytree(str(tmp_path / "farm.pt"), es)):
        assert_state_equal(restored, es)
        assert restored.steps.dtype == torch.int32 and restored.obs.dtype == torch.float32
        _, got = venv.step_with_eta(restored, act, eta)
        assert torch.equal(got.obs, want.obs) and torch.equal(got.reward, want.reward)
        carry, _ = fs.pack(restored)
        assert torch.equal(carry, fs.pack(es)[0])


def check_across_packages(farm, hover_env, hover_trim, tmp_path):
    """A JAX farm (its per-env fields made distinct) written by the JAX
    package's `save_npz` loads through the port's `load_npz` into the port's
    EnvState, every value equal; the port's file of it loads back through
    the JAX package's `load_npz`, every value equal (its keys zeros)."""
    _, es, _, _ = farm
    es_j, _ = JVectorHeliEnv(hover_env, B).reset_from_trim(hover_trim, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    es_j = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape).astype(np.float32)
                   if x.dtype == np.float32 else x + rng.integers(0, 9, x.shape).astype(x.dtype)),
        es_j)
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, es_j)
    got = ckpt.load_npz(path, es)
    want = jax_state_to_numpy(es_j)
    ours = env_state_to_numpy(got)
    for k, v in want.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
    back = str(tmp_path / "port.npz")
    ckpt.save_npz(back, got)
    again = jckpt.load_npz(back, es_j)
    for k, v in want.items():
        assert np.array_equal(jax_state_to_numpy(again)[k], v), k
    assert np.array_equal(np.asarray(again.key), np.zeros((B, 2), np.uint32))


def check_wrong_templates(farm, tmp_path):
    """Each read refuses a template of another structure, a file with a leaf
    missing and a farm of another size, with the JAX package's messages."""
    venv, es, _, _ = farm
    npz, pt = str(tmp_path / "farm.npz"), str(tmp_path / "farm.pt")
    ckpt.save_npz(npz, es)
    ckpt.save_pytree(pt, es)
    bigger, _ = VectorHeliEnv(venv.env, 2 * B).reset_from_trim(venv.env.trim_result())
    for read, path in ((ckpt.load_npz, npz), (ckpt.restore_pytree, pt)):
        with pytest.raises(ValueError, match="checkpoint structure mismatch"):
            read(path, {"farm": es})
        with pytest.raises(ValueError, match="checkpoint structure mismatch"):
            read(path, es.init)
        with pytest.raises(ValueError, match=r"checkpoint leaf 0 shape \(4,\) != template \(8,\)"):
            read(path, bigger)
    treedef, leaves = ckpt.flatten(es)
    short = str(tmp_path / "short.npz")
    np.savez(short, n=len(leaves) - 1, treedef=treedef,
             **{f"leaf_{i}": x for i, x in enumerate(leaves[:-1])})
    with pytest.raises(ValueError, match="checkpoint leaf count 89 != template 90"):
        ckpt.load_npz(short, es)
    with pytest.raises(TypeError):
        ckpt.save_npz(str(tmp_path / "bad.npz"), {"gen": torch.Generator()})


def test_checkpoints(farm, hover_env, hover_trim, tmp_path):
    """Round trips in the port, across the packages, and the refusals, each
    in a directory of its own."""
    def check(fn, *args):
        def run():
            path = tmp_path / fn.__name__
            path.mkdir()
            fn(*args, path)
        return fn.__name__, run
    run_checks([check(check_port_round_trips, farm),
                check(check_across_packages, farm, hover_env, hover_trim),
                check(check_wrong_templates, farm)])
