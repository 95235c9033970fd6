"""The port's batched Newton trim, the assembly of a randomized farm and the
trim disk cache, against the JAX package's `trim_batched` and
`_assemble_batched` and the reference's golden trims, on the CPU.

The JAX `trim_batched` builds a new jitted solve on every call (~8 s here),
so it runs once, for every condition, in a module-scoped fixture."""
import ast

import jax
import numpy as np
import pytest
import torch

import heligym_tpu.envs.trim as jtrim
import heligym_tpu.envs.vector as jvector
from heligym_tpu.models import load_params as jload_params
from heligym_tpu.ops import dryden as jdryden, terrain as jterrain

from heligym_tpu_torch.envs import HeliEnv, HoverTask, TrimResult
from heligym_tpu_torch.envs import env as env_mod, trim as ttrim
from heligym_tpu_torch.envs.vector import _assemble_batched
from heligym_tpu_torch.models import load_params
from heligym_tpu_torch.ops import dryden, terrain as terrain_ops
from heligym_tpu_torch.ops.state import HeliState, WindState
from heligym_tpu_torch.utils.constants import EPS

# State over max(|reference|, 1) and action, each within this of the other
# solver's fixed point: JAX's own batched-vs-host bar (tests/test_trim.py).
TRIM_TOL = 5e-3
YAW = 1.0

# name -> overrides of the default hover trim condition
CONDS = {
    "hover_100ft": {},
    "fwd50_1000ft": {"ned_vel": [50.0, 0.0, 0.0], "gr_alt": 1000.0},
    "fwd100_side10_3000ft": {"ned_vel": [100.0, 10.0, 0.0], "gr_alt": 3000.0},
    "hover_6ft": {"gr_alt": 6.0},
    "hover_55ft": {"gr_alt": 55.0},
    "fwd40_yaw1": {"yaw": YAW, "ned_vel": [40.0 * float(np.cos(np.float32(YAW))),
                                           40.0 * float(np.sin(np.float32(YAW))), 0.0]},
    "offset_2000ft": {"xy": [2000.0, -2000.0]},
}
N_GOLDEN = 4


def _cond(over):
    cond = {"yaw": 0.0, "yaw_rate": 0.0, "ned_vel": [0.0, 0.0, 0.0],
            "gr_alt": 100.0, "xy": [0.0, 0.0], "psi_mr": 0.0, "psi_tr": 0.0}
    cond.update(over)
    return cond


def _batch(conds):
    """numpy batched trim conditions from a list of condition dicts."""
    return {k: np.asarray([c[k] for c in conds], np.float32)
            for k in ("yaw", "yaw_rate", "ned_vel", "gr_alt", "xy", "psi_mr", "psi_tr")}


@pytest.fixture(scope="module")
def conds(fixtures):
    f = fixtures("trim")
    assert int(f["n"]) == N_GOLDEN
    golden = [_cond(ast.literal_eval(str(f[f"cond{i}_json"]))) for i in range(N_GOLDEN)]
    return [_cond(o) for o in CONDS.values()] + golden


@pytest.fixture(scope="module")
def jax_solve(conds):
    p = jload_params("aw109")
    wind = jdryden.mean_wind(jdryden.WindParams.from_env(p.ENV))
    tr = jtrim.trim_batched(p, jterrain.load_terrain(p.ENV), wind, _batch(conds))
    return jax.tree_util.tree_map(np.asarray, tr), np.asarray(wind)


@pytest.fixture(scope="module")
def port_solve(conds):
    p = load_params("aw109")
    wind = dryden.mean_wind(dryden.WindParams.from_env(p.ENV))
    return ttrim.trim_batched(p, terrain_ops.load_terrain(p.ENV), wind, _batch(conds))


def _close(ours, ref, atol, msg=""):
    scale = np.maximum(np.abs(ref), 1.0)
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=0, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("i,name", list(enumerate(CONDS)))
def test_trim_batched_matches_jax(i, name, jax_solve, port_solve):
    jtr, _ = jax_solve
    tr = port_solve.result
    _close(tr.state.flatten()[i].numpy(), np.asarray(jtr.state.flatten())[i],
           TRIM_TOL, name)
    np.testing.assert_allclose(tr.action[i].numpy(), jtr.action[i], rtol=0,
                               atol=TRIM_TOL, err_msg=name)


def test_trim_batched_matches_goldens(fixtures, jax_solve, port_solve):
    """Each of the reference's golden trims, and the JAX solve of the same
    condition."""
    f = fixtures("trim")
    jtr, _ = jax_solve
    tr = port_solve.result
    for i in range(N_GOLDEN):
        k = len(CONDS) + i
        ours = tr.state.flatten()[k].numpy()
        _close(ours, f[f"cond{i}_state"], TRIM_TOL, f"golden {i}")
        np.testing.assert_allclose(tr.action[k].numpy(), f[f"cond{i}_action"], rtol=0,
                                   atol=TRIM_TOL, err_msg=f"golden {i}")
        _close(ours, np.asarray(jtr.state.flatten())[k], TRIM_TOL, f"golden {i} (JAX)")


def test_trim_batched_converges(port_solve):
    """Every condition converges (the 6 ft hover with the gear near contact
    included): its squared residual ends below EPS, within the 50-iteration
    cap, and the results are finite."""
    assert port_solve.iterations < 50
    res = port_solve.sq_residual.numpy()
    assert (res < EPS).all(), res
    tr = port_solve.result
    for t in (tr.state.flatten(), tr.action, tr.obs, tr.dots.flatten()):
        assert torch.isfinite(t).all()


def _trim_from_numpy(jtr) -> TrimResult:
    t = lambda a: torch.from_numpy(np.array(a))
    return TrimResult(state=HeliState.unflatten(t(jtr.state.flatten())),
                      action=t(jtr.action), obs=t(jtr.obs),
                      dots=HeliState.unflatten(t(jtr.dots.flatten())))


def test_assemble_batched_equals_jax(jax_solve):
    """Fed JAX's batched TrimResult, the port's assembly gives every field of
    JAX's exactly (the JAX state's per-env keys have no counterpart)."""
    jtr, wind = jax_solve
    n = jtr.action.shape[0]
    ref = jvector._assemble_batched(jtr, wind, jax.random.PRNGKey(0), n)
    es = _assemble_batched(_trim_from_numpy(jtr), torch.from_numpy(np.array(wind)), n)
    jwind = lambda w: np.stack([np.asarray(getattr(w, f)) for f in WindState.FIELDS], -1)
    pairs = {"heli": (es.heli.flatten(), ref.heli.flatten()),
             "wind": (es.wind.flatten(), jwind(ref.wind)),
             "dots": (es.dots.flatten(), ref.dots.flatten()),
             "obs": (es.obs, ref.obs), "wind_ned": (es.wind_ned, ref.wind_ned),
             "steps": (es.steps, ref.steps),
             "successed_steps": (es.successed_steps, ref.successed_steps),
             "task_id": (es.task_id, ref.task_id),
             "init.heli": (es.init.heli.flatten(), ref.init.heli.flatten()),
             "init.wind": (es.init.wind.flatten(), jwind(ref.init.wind)),
             "init.dots": (es.init.dots.flatten(), ref.init.dots.flatten()),
             "init.obs": (es.init.obs, ref.init.obs),
             "init.wind_ned": (es.init.wind_ned, ref.init.wind_ned)}
    for name, (ours, theirs) in pairs.items():
        theirs = np.asarray(theirs)
        assert ours.numpy().dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=name)


# -- the trim disk cache -------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    return HeliEnv.build("aw109", task=HoverTask(), device="cpu")


def test_trim_cache_stores_then_hits(env, tmp_path, monkeypatch):
    monkeypatch.setenv("HELIGYM_TPU_TORCH_CACHE", str(tmp_path))
    cond = {"gr_alt": 250.0}
    tr = env.trim_result(cond)
    files = list(tmp_path.glob("trim_aw109_*.npz"))
    assert len(files) == 1 and not list(tmp_path.glob("*.tmp"))

    def no_solve(*a, **k):
        raise AssertionError("the cached trim was solved again")
    monkeypatch.setattr(env_mod, "trim", no_solve)
    back = env.trim_result(cond)
    for a, b in ((tr.state.flatten(), back.state.flatten()), (tr.action, back.action),
                 (tr.obs, back.obs), (tr.dots.flatten(), back.dots.flatten())):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="solved again"):
        env.trim_result(cond, use_cache=False)


def test_trim_cache_corrupt_file_is_a_miss(env, tmp_path, monkeypatch):
    monkeypatch.setenv("HELIGYM_TPU_TORCH_CACHE", str(tmp_path))
    cond = env.default_trim_cond()
    cond["gr_alt"] = 300.0
    path = env_mod._trim_cache_path(env.params.name, env.wind_params, cond)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert env_mod._trim_cache_load(env.params.name, env.wind_params, cond) is None
    tr = env.trim_result({"gr_alt": 300.0})
    again = env_mod._trim_cache_load(env.params.name, env.wind_params, cond)
    assert again is not None and torch.equal(again.action, tr.action)


def test_trim_cache_root_is_the_ports_own(monkeypatch, tmp_path):
    """The default root is ~/.cache/heligym_tpu_torch, never the JAX
    package's ~/.cache/heligym_tpu; HELIGYM_TPU_TORCH_CACHE moves it, and
    the JAX package's variable does not."""
    wp = dryden.WindParams.from_env(load_params("aw109").ENV)
    monkeypatch.delenv("HELIGYM_TPU_TORCH_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("HELIGYM_TPU_CACHE", str(tmp_path / "jax"))
    path = env_mod._trim_cache_path("aw109", wp, {"gr_alt": 100.0})
    assert path.startswith(str(tmp_path / ".cache" / "heligym_tpu_torch") + "/")
    monkeypatch.setenv("HELIGYM_TPU_TORCH_CACHE", str(tmp_path / "own"))
    path = env_mod._trim_cache_path("aw109", wp, {"gr_alt": 100.0})
    assert path.startswith(str(tmp_path / "own") + "/")
