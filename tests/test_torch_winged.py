"""A user airframe with a wing, on the CPU: `register_model_path` in both
packages, the wing term and the dynamics against the JAX package, and 30
steps of the fused step's plain version against JAX's eager step.

The airframe `aw109_wing` (tests/torch_airframes.py: aw109 with a wing of
five times its horizontal tail's coefficients, at the centre of gravity) is
written into a temporary directory that both packages search first for
this module's run. Both
packages start from the JAX aw109 `hover_trim` fixture: a JAX trim of the
winged airframe costs minutes on the CPU, and the parity does not need one.

The file collects two tests, each running all of its checks before it
reports every one that failed (a file of at most two tests is handed out
after the long JAX files under `--dist loadfile`). Tolerances: the terms
those of tests/test_terms.py, the dynamics tests/test_dynamics.py's, the
30 steps the fused contract of tests/test_fused.py. The kernel itself is
held against the plain version bit for bit on the card (test_torch_cuda.py,
chip_smoke.py phase 10)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heligym_tpu import models as jmodels
from heligym_tpu.envs import HeliEnv as JHeliEnv, VectorHeliEnv as JVectorHeliEnv
from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.envs.vector import auto_reset as jauto_reset
from heligym_tpu.models import registry as jregistry
from heligym_tpu.ops import aero as jaero, terrain as jterrain
from heligym_tpu.ops.eom import heli_dynamics as jheli_dynamics
from heligym_tpu.ops.state import HeliState as JHeliState

from heligym_tpu_torch import convert, models
from heligym_tpu_torch.convert import env_state_from_numpy
from heligym_tpu_torch.envs import HeliEnv, tasks
from heligym_tpu_torch.models import registry
from heligym_tpu_torch.ops import aero, terrain
from heligym_tpu_torch.ops.cuda import fused_step as fs
from heligym_tpu_torch.ops.eom import heli_dynamics
from heligym_tpu_torch.ops.state import HeliState

from test_torch_distill import run_checks
from test_torch_ops import TERM_ATOL, TERM_RTOL, _random_states, _stack, _t, _tup
from test_torch_tasks import compiled, jax_state_to_numpy, make_task
from torch_airframes import NAME, WING, write_winged
from torch_trim_cache import fresh_trim_cache  # noqa: F401

B, STEPS = 16, 30
MIXED4 = ("hover", "forward", "turning", "oblique")
TOL = {"reward_atol": 2e-5, "state_rtol": 2e-4, "state_atol": 2e-4,
       "obs_rtol": 1e-4, "obs_atol": 2e-3}


@pytest.fixture(scope="module")
def airframes(tmp_path_factory):
    """A directory holding aw109_wing.yaml, registered in both packages
    through `register_model_path` for the module's run and removed after."""
    d = tmp_path_factory.mktemp("airframes")
    write_winged(d)
    with pytest.MonkeyPatch.context() as mp:
        for reg in (jregistry, registry):
            mp.setattr(reg, "_SEARCH_PATHS", list(reg._SEARCH_PATHS))
        for mod in (jmodels, models):
            mod.register_model_path(str(d))
        yield d


def check_params_and_registry(airframes, tmp_path):
    """The winged airframe loads equal in both packages; the registries
    search the registered directory first, without duplicates; a name
    loaded before its directory was registered stays cached in both."""
    ours, theirs = models.load_params(NAME), jmodels.load_params(NAME)
    a, b = convert.params_to_numpy(ours), convert.params_to_numpy(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        if np.asarray(a[k]).dtype.kind in "USO":
            assert a[k] == b[k], k
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, err_msg=k)
    assert (ours.WN.ZUU, ours.WN.ZUW, ours.WN.ZMAX) == tuple(WING.values())
    for mod, reg in ((models, registry), (jmodels, jregistry)):
        mod.register_model_path(str(airframes))
        assert reg._SEARCH_PATHS.count(str(airframes)) == 1
        assert reg._SEARCH_PATHS[0] == str(airframes)
        assert NAME in mod.available_models()
    # aw109 is loaded (and cached) before a directory holding another
    # aw109.yaml is registered: the cached airframe stays, the search finds
    # the new file first
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    (shadow / "aw109.yaml").write_text((airframes / f"{NAME}.yaml").read_text())
    for mod in (models, jmodels):
        assert mod.load_params("aw109").WN.ZUW == 0.0
        mod.register_model_path(str(shadow))
        assert mod.load_params("aw109").WN.ZUW == 0.0
        assert mod.load_params.__wrapped__("aw109").WN.ZUW == WING["ZUW"]
    for reg in (registry, jregistry):
        reg._SEARCH_PATHS.remove(str(shadow))
    with pytest.raises(FileNotFoundError):
        models.load_params("no_such_airframe")


def check_wing_term_equal_jax():
    """`aero.wing` on random inputs (both Z branches, and vta == 0) at
    tests/test_terms.py's tolerances; the wingless airframe gives zeros."""
    p, jp = models.load_params(NAME), jmodels.load_params(NAME)
    rng = np.random.default_rng(11)
    n = 512
    rho = rng.uniform(1.6e-3, 2.3e-3, n).astype(np.float32)
    uvw = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
    vi = rng.uniform(0, 70, n).astype(np.float32)
    uvw[:8, 0], uvw[:8, 2] = 0.0, vi[:8]          # vta == 0
    force, moment, power = aero.wing(p, _t(rho), _tup(uvw), _t(vi))
    jforce, jmoment, jpower = jax.jit(lambda: jaero.wing(
        jp, jnp.asarray(rho), tuple(jnp.asarray(uvw[:, i]) for i in range(3)),
        jnp.asarray(vi)))()
    np.testing.assert_allclose(_stack(force), _stack(jforce), rtol=TERM_RTOL, atol=TERM_ATOL)
    np.testing.assert_array_equal(_stack(moment), 0.0)
    np.testing.assert_allclose(np.asarray(power), np.asarray(jpower), rtol=1e-4, atol=50.0)
    wa_wn = uvw[:, 2] - vi
    stall = np.abs(wa_wn) > 0.3 * np.abs(uvw[:, 0])
    assert stall.any() and (~stall).any()
    assert np.all(np.isfinite(_stack(force))) and np.abs(_stack(force)[:, 2]).max() > 1.0
    zero = aero.wing(models.load_params("aw109"), _t(rho), _tup(uvw), _t(vi))
    assert all(float(x.abs().max()) == 0.0 for x in (*zero[0], *zero[1], zero[2]))


def check_dynamics_equal_jax():
    """`heli_dynamics` of the winged airframe on random batched states
    against JAX, normalized per column (tests/test_dynamics.py's 5e-5), and
    different from aw109's."""
    p, jp = models.load_params(NAME), jmodels.load_params(NAME)
    terr, jterr = terrain.load_terrain(p.ENV), jterrain.load_terrain(jp.ENV)
    rng = np.random.default_rng(12)
    n = 512
    st = _random_states(rng, n)
    acts = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    winds = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    s = HeliState.unflatten(_t(st))
    h = terrain.ground_height(terr, s.x, s.y)
    dots, obs, _ = heli_dynamics(p, s, _tup(acts), _tup(winds), h)

    def jfn(st, acts, winds):
        js = JHeliState.unflatten(st)
        jh = jterrain.ground_height(jterr, js.x, js.y)
        d, o, _ = jheli_dynamics(jp, js, tuple(acts[:, i] for i in range(4)),
                                 tuple(winds[:, i] for i in range(3)), jh)
        return d.flatten(), jnp.stack(o, -1)
    jd, jo = jax.jit(jfn)(st, acts, winds)
    for ours, ref in ((dots.flatten().numpy(), np.asarray(jd)),
                      (torch.stack(obs, -1).numpy(), np.asarray(jo))):
        scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
        np.testing.assert_allclose(ours / scale, ref / scale, atol=5e-5)
    plain, _, _ = heli_dynamics(models.load_params("aw109"), s, _tup(acts), _tup(winds), h)
    assert float((plain.u - dots.u).abs().max()) > 1.0


def test_winged_airframe_matches_jax(airframes, tmp_path):
    """The registry, the parameters, the wing term and the dynamics."""
    run_checks([("params_and_registry", lambda: check_params_and_registry(airframes, tmp_path)),
                ("wing_term", check_wing_term_equal_jax),
                ("dynamics", check_dynamics_equal_jax)])


def check_fused_30_steps(label, env, jstep, es_j, hover_trim, task_ids):
    """30 perturbed steps of the plain version on 16 winged envs against
    JAX's eager step + auto_reset (`jstep`) from the same state and noise,
    at the fused contract; the launch checks accept the airframe and its
    constant table holds the wing; the same steps without the wing differ
    by far more than the contract allows."""
    es_j = JVectorHeliEnv(jstep.env, B).assign_tasks(es_j, task_ids)
    rng = np.random.default_rng(4)
    act = np.tile(np.asarray(hover_trim.action, np.float32), (STEPS, B, 1))
    act += (0.02 * rng.standard_normal(act.shape)).astype(np.float32)
    eta = (rng.standard_normal((STEPS, 3, B)) * (1.0 / env.dt) ** 0.5).astype(np.float32)
    ref = {"reward": [], "done": [], "obs": []}
    e = es_j
    for t in range(STEPS):
        e, out = jstep(e, act[t], eta[t])
        for k in ref:
            ref[k].append(np.asarray(getattr(out, k)))
    ref = {k: np.stack(v) for k, v in ref.items()}

    es_t = env_state_from_numpy(jax_state_to_numpy(es_j), "cpu")
    carry, init = fs.pack(es_t)
    assert fs.has_wing(env) and not fs.has_wing(env.replace(
        params=models.load_params("aw109")))
    consts, _ = fs._checked(env, carry, init, torch.from_numpy(act[0]),
                            torch.from_numpy(eta[0]), carry, None, None)
    got = {k: consts[fs.CONST_NAMES.index(f"WN_{k}")] for k in WING}
    assert got == {k: np.float32(v) for k, v in WING.items()}

    def run(env):
        roll = fs.build_fused_rollout(env, B, STEPS, collect=("reward", "done", "obs"),
                                      eta_mode="inject")
        with torch.no_grad():
            return roll(es_t, torch.from_numpy(act), torch.from_numpy(eta))
    es_f, outs = run(env)
    np.testing.assert_allclose(outs["reward"].numpy(), ref["reward"], atol=TOL["reward_atol"])
    np.testing.assert_allclose(es_f.heli.flatten().numpy(), np.asarray(e.heli.flatten()),
                               rtol=TOL["state_rtol"], atol=TOL["state_atol"])
    np.testing.assert_allclose(outs["obs"].numpy(), ref["obs"],
                               rtol=TOL["obs_rtol"], atol=TOL["obs_atol"])
    np.testing.assert_array_equal(outs["done"].numpy(), ref["done"])
    np.testing.assert_array_equal(es_f.steps.numpy(), np.asarray(e.steps))
    assert not ref["done"].any(), f"{label}: an env ended; the contract is for 30 live steps"

    # the same run without the wing, in units of the contract's allowance
    es_w, _ = run(env.replace(params=models.load_params("aw109")))
    f, w = es_f.heli.flatten(), es_w.heli.flatten()
    gap = float(((w - f).abs() / (TOL["state_atol"] + TOL["state_rtol"] * f.abs())).max())
    assert gap > 100.0, gap


def test_winged_fused_plain_matches_jax(airframes, hover_trim):
    """Hover and the 4-task MixedTask on the winged airframe. JAX's step is
    compiled once (~25 s), for the MixedTask: its lanes on task id 0 score
    the plain HoverTask's reward, so the port's hover farm is held against
    a JAX farm whose every lane has id 0. The targets lie 10 ft above the
    start: a reward takes the sign of each error, and an error that starts
    at exactly zero would take its sign from the last bit of a state that
    the winged airframe, off its trim, moves at once (XLA contracts FMAs,
    the port does not)."""
    alt = float(-np.asarray(hover_trim.state.z)) + 10.0
    jenv = JHeliEnv.build(NAME, task=make_task(jtasks, "mixed4", alt))
    es_j, _ = JVectorHeliEnv(jenv, B).reset_from_trim(hover_trim, jax.random.PRNGKey(3))
    zeros = np.zeros((STEPS, B, 4), np.float32)
    fn = compiled(lambda es, a, e: jauto_reset(*jax.vmap(jenv.step_with_eta)(es, a, e.T)),
                  es_j, zeros[0], zeros[0, :, :3].T)
    jstep = lambda es, a, e: fn(es, a, e)
    jstep.env = jenv
    hover = HeliEnv.build(NAME, task=make_task(tasks, "hover", alt), device="cpu")
    mixed = HeliEnv.build(NAME, task=make_task(tasks, "mixed4", alt), device="cpu")
    run_checks([
        ("hover", lambda: check_fused_30_steps(
            "hover", hover, jstep, es_j, hover_trim, np.zeros(B, np.int64))),
        ("mixed4", lambda: check_fused_30_steps(
            "mixed4", mixed, jstep, es_j, hover_trim, np.arange(B) % len(MIXED4)))])
