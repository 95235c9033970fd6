"""Parity of the PyTorch port's ops (heligym_tpu_torch.ops, .models,
.utils) with the JAX package and the golden fixtures, on the CPU.

The same seeded numpy inputs go through the JAX function and its port; the
tolerances are those of the JAX package's own fixture tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heligym_tpu.envs import tasks as jtasks
from heligym_tpu.models import load_params as jload_params
from heligym_tpu.ops import aero as jaero, dryden as jdryden, rotor as jrotor
from heligym_tpu.ops import terrain as jterrain
from heligym_tpu.ops.eom import heli_dynamics as jheli_dynamics
from heligym_tpu.ops.state import HeliState as JHeliState
from heligym_tpu.ops.state import WindState as JWindState
from heligym_tpu.utils.math import pi_bound as jpi_bound

from heligym_tpu_torch import convert
from heligym_tpu_torch.envs import tasks
from heligym_tpu_torch.models import load_params
from heligym_tpu_torch.models.registry import _MODEL_DIR, _parse_yaml
from heligym_tpu_torch.ops import aero, dryden, rotor, terrain
from heligym_tpu_torch.ops.eom import heli_dynamics
from heligym_tpu_torch.ops.integrator import rk4_k4only
from heligym_tpu_torch.ops.lookup import Table, table_lookup_1d, table_lookup_2d
from heligym_tpu_torch.ops.state import HeliState, WindState
from heligym_tpu_torch.utils.constants import DT
from heligym_tpu_torch.utils.math import pi_bound

TERM_RTOL = 3e-5
TERM_ATOL = 2e-2


@pytest.fixture(scope="module")
def p():
    return load_params("aw109")


@pytest.fixture(scope="module")
def terr(p):
    return terrain.load_terrain(p.ENV)


@pytest.fixture(scope="module")
def jterr():
    return jterrain.load_terrain(jload_params("aw109").ENV)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _tup(arr):
    a = _t(arr)
    return tuple(a[:, i] for i in range(a.shape[1]))


def _stack(t):
    return np.stack([np.asarray(c) for c in t], axis=-1)


def _random_states(rng, n):
    """Random flight states around hover, some in gear contact."""
    st = np.zeros((n, 18), np.float32)
    st[:, 0] = rng.uniform(20, 60, n)            # vi_mr
    st[:, 1] = rng.uniform(20, 80, n)            # vi_tr
    st[:, 2:4] = rng.uniform(-np.pi, np.pi, (n, 2))
    st[:, 4:6] = rng.uniform(-0.1, 0.1, (n, 2))  # b0, b1
    st[:, 6:9] = rng.uniform(-80, 80, (n, 3))    # uvw
    st[:, 9:12] = rng.uniform(-0.5, 0.5, (n, 3))  # pqr
    st[:, 12:14] = rng.uniform(-0.6, 0.6, (n, 2))  # phi, theta
    st[:, 14] = rng.uniform(-np.pi, np.pi, n)
    st[:, 15:17] = rng.uniform(-3000, 3000, (n, 2))
    st[:, 17] = rng.uniform(-4000, -1500, n)
    return st


# -- models ------------------------------------------------------------------

def test_yaml_reader_matches_pyyaml():
    yaml = pytest.importorskip("yaml")
    for name in ("aw109", "aw109_heavy"):
        with open(f"{_MODEL_DIR}/{name}.yaml") as f:
            text = f.read()
        assert _parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("group", ["MR", "TR", "FUS", "HT", "VT", "WN"])
def test_params_match_fixture(fixtures, p, group):
    f = fixtures("params")
    keys = [k for k in f.keys() if k.startswith(group + ".")]
    assert keys
    ours = convert.params_to_numpy(p)
    for k in keys:
        np.testing.assert_allclose(ours[k], f[k], rtol=1e-12, err_msg=k)


def test_mass_inertia_gear_exact(fixtures, p):
    f = fixtures("params")
    np.testing.assert_allclose(p.HELI.M, float(f["HELI.M"]), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(p.HELI.I), f["HELI.I"])
    np.testing.assert_array_equal(np.asarray(p.HELI.IINV), f["HELI.IINV"])
    np.testing.assert_array_equal(np.asarray(p.LG.LOC), f["LG.LOC"])


@pytest.mark.parametrize("name", ["aw109", "aw109_heavy"])
def test_params_equal_jax(name):
    ours = convert.params_to_numpy(load_params(name))
    theirs = convert.params_to_numpy(jload_params(name))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# -- per-term fixtures -------------------------------------------------------

def test_main_rotor_terms(fixtures, p):
    f = fixtures("terms")
    betas = _t(f["betas"])
    force, moment, power, b0_dot, b1_dot, vi_dot, _ = rotor.main_rotor(
        p, _t(f["rho"]), _t(f["coll"]), _t(f["lon"]), _t(f["lat"]),
        betas[:, 0], betas[:, 1], _tup(f["uvw_air"]), _tup(f["pqr"]),
        _t(f["vi_mr"]))
    np.testing.assert_allclose(_stack(force), f["mr_force"], rtol=TERM_RTOL, atol=TERM_ATOL)
    np.testing.assert_allclose(_stack(moment), f["mr_moment"], rtol=TERM_RTOL, atol=0.5)
    np.testing.assert_allclose(power, f["mr_power"], rtol=1e-4, atol=50.0)
    np.testing.assert_allclose(_stack((b0_dot, b1_dot)), f["mr_betas_dot"],
                               rtol=TERM_RTOL, atol=1e-3)
    np.testing.assert_allclose(np.asarray(vi_dot)[:, None], f["mr_vi_dot"],
                               rtol=TERM_RTOL, atol=1e-3)


def test_tail_rotor_terms(fixtures, p):
    f = fixtures("terms")
    force, moment, power, vi_dot, _ = rotor.tail_rotor(
        p, _t(f["rho"]), _t(f["pedal"]), _tup(f["uvw_air"]), _tup(f["pqr"]),
        _t(f["vi_tr"]))
    np.testing.assert_allclose(_stack(force), f["tr_force"], rtol=TERM_RTOL, atol=TERM_ATOL)
    np.testing.assert_allclose(_stack(moment), f["tr_moment"], rtol=TERM_RTOL, atol=0.2)
    np.testing.assert_allclose(power, f["tr_power"], rtol=1e-4, atol=20.0)
    np.testing.assert_allclose(np.asarray(vi_dot)[:, None], f["tr_vi_dot"],
                               rtol=TERM_RTOL, atol=1e-3)


@pytest.mark.parametrize("term", ["fus", "ht", "vt"])
def test_aero_terms(fixtures, p, term):
    f = fixtures("terms")
    rho, uvw, pqr = _t(f["rho"]), _tup(f["uvw_air"]), _tup(f["pqr"])
    if term == "fus":
        force, moment, power = aero.fuselage(p, rho, uvw, _t(f["vi_mr"]))
        np.testing.assert_allclose(power, f["fus_power"], rtol=1e-4, atol=50.0)
    elif term == "ht":
        force, moment = aero.horizontal_tail(p, rho, uvw, pqr, _t(f["vi_mr"]))
    else:
        force, moment = aero.vertical_tail(p, rho, uvw, pqr, _t(f["vi_tr"]))
    np.testing.assert_allclose(_stack(force), f[f"{term}_force"],
                               rtol=TERM_RTOL, atol=TERM_ATOL)
    np.testing.assert_allclose(_stack(moment), f[f"{term}_moment"],
                               rtol=TERM_RTOL, atol=0.5)


def test_rotor_aero_equal_jax_random(p):
    """Rotor and aero terms on random inputs against the JAX functions."""
    jp = jload_params("aw109")
    rng = np.random.default_rng(3)
    n = 512
    rho = rng.uniform(1.6e-3, 2.3e-3, n).astype(np.float32)
    ctl = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    uvw = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
    pqr = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    vi = rng.uniform(0, 70, (n, 2)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    jt = lambda a: tuple(jnp.asarray(a[:, i]) for i in range(a.shape[1]))
    ours = rotor.main_rotor(p, _t(rho), _t(ctl[:, 0]), _t(ctl[:, 1]), _t(ctl[:, 2]),
                            _t(b[:, 0]), _t(b[:, 1]), _tup(uvw), _tup(pqr), _t(vi[:, 0]))
    theirs = jax.jit(lambda: jrotor.main_rotor(
        jp, jnp.asarray(rho), jnp.asarray(ctl[:, 0]), jnp.asarray(ctl[:, 1]),
        jnp.asarray(ctl[:, 2]), jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]),
        jt(uvw), jt(pqr), jnp.asarray(vi[:, 0])))()
    ours_tr = rotor.tail_rotor(p, _t(rho), _t(ctl[:, 3]), _tup(uvw), _tup(pqr),
                               _t(vi[:, 1]))
    theirs_tr = jax.jit(lambda: jrotor.tail_rotor(
        jp, jnp.asarray(rho), jnp.asarray(ctl[:, 3]), jt(uvw), jt(pqr),
        jnp.asarray(vi[:, 1])))()
    ours_a = (aero.fuselage(p, _t(rho), _tup(uvw), _t(vi[:, 0])),
              aero.horizontal_tail(p, _t(rho), _tup(uvw), _tup(pqr), _t(vi[:, 0])),
              aero.vertical_tail(p, _t(rho), _tup(uvw), _tup(pqr), _t(vi[:, 1])))
    theirs_a = jax.jit(lambda: (
        jaero.fuselage(jp, jnp.asarray(rho), jt(uvw), jnp.asarray(vi[:, 0])),
        jaero.horizontal_tail(jp, jnp.asarray(rho), jt(uvw), jt(pqr), jnp.asarray(vi[:, 0])),
        jaero.vertical_tail(jp, jnp.asarray(rho), jt(uvw), jt(pqr), jnp.asarray(vi[:, 1]))))()
    flat = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]
    for o, t in zip(flat((ours, ours_tr, ours_a)), flat((theirs, theirs_tr, theirs_a))):
        scale = max(np.abs(t).max(), 1.0)
        np.testing.assert_allclose(o / scale, t / scale, atol=1e-6)


# -- full dynamics -----------------------------------------------------------

def test_dynamics_match_fixture(fixtures, p, terr):
    f = fixtures("dynamics")
    s = HeliState.unflatten(_t(f["states"]))
    h = terrain.ground_height(terr, s.x, s.y)
    acts, winds = _t(f["actions"]), _t(f["winds"])
    dots, obs, _ = heli_dynamics(p, s, tuple(acts[:, i] for i in range(4)),
                                 tuple(winds[:, i] for i in range(3)), h)
    dots, obs = dots.flatten().numpy(), torch.stack(obs, -1).numpy()
    ref_dots, ref_obs = f["dots"], f["obs"]
    blocks = {"vi_mr": (0, 1), "vi_tr": (1, 2), "psi": (2, 4), "betas": (4, 6),
              "uvw": (6, 9), "pqr": (9, 12), "euler": (12, 15), "xyz": (15, 18)}
    for name, (a, b) in blocks.items():
        scale = max(np.abs(ref_dots[:, a:b]).max(), 1.0)
        np.testing.assert_allclose(dots[:, a:b] / scale, ref_dots[:, a:b] / scale,
                                   atol=5e-5, err_msg=f"dots block {name}")
    scale = np.maximum(np.abs(ref_obs).max(axis=0), 1.0)
    np.testing.assert_allclose(obs / scale, ref_obs / scale, atol=5e-5)


def test_heavy_dynamics_match_fixture(fixtures, terr):
    """The second airframe (aw109_heavy) against its reference fixture."""
    f = fixtures("dynamics_heavy")
    ph = load_params("aw109_heavy")
    s = HeliState.unflatten(_t(f["states"]))
    acts, winds = _t(f["actions"]), _t(f["winds"])
    dots, obs, _ = heli_dynamics(ph, s, tuple(acts[:, i] for i in range(4)),
                                 tuple(winds[:, i] for i in range(3)),
                                 terrain.ground_height(terr, s.x, s.y))
    for ours, ref in ((dots.flatten().numpy(), f["dots"]),
                      (torch.stack(obs, -1).numpy(), f["obs"])):
        scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
        np.testing.assert_allclose(ours / scale, ref / scale, atol=5e-5)


def test_dynamics_equal_jax_random(p, terr, jterr):
    """heli_dynamics on random batched states (gear contact included)
    against JAX, normalized per block as the fixture test does."""
    jp = jload_params("aw109")
    rng = np.random.default_rng(0)
    n = 512
    st = _random_states(rng, n)
    st[:64, 17] = -rng.uniform(0, 30, 64) - 1650.0   # near the ground at (0,0)
    st[:64, 15:17] = rng.uniform(-20, 20, (64, 2))
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
        return d.flatten(), jnp.stack(o, -1), jh
    jd, jo, jh = jax.jit(jfn)(st, acts, winds)
    # XLA on the CPU contracts a*b+c into FMAs; the port rounds each op.
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-3)
    for ours, ref in ((dots.flatten().numpy(), np.asarray(jd)),
                      (torch.stack(obs, -1).numpy(), np.asarray(jo))):
        scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
        np.testing.assert_allclose(ours / scale, ref / scale, atol=5e-5)


# -- lookup / wind -----------------------------------------------------------

def test_tep_table_and_2d_lookup(fixtures):
    f = fixtures("lookup")
    np.testing.assert_array_equal(dryden._TEP_DATA, f["table"])
    data = _t(f["table"])
    rows = np.repeat(f["rows"], len(f["cols"])).astype(np.float32)
    cols = np.tile(f["cols"], len(f["rows"])).astype(np.float32)
    got = table_lookup_2d(data, _t(rows), _t(cols)).numpy()
    np.testing.assert_allclose(got.reshape(f["vals"].shape), f["vals"],
                               rtol=1e-5, atol=1e-5)


def test_1d_interp_and_edge_bug():
    t = Table(3)
    t << 5 << 3 << 6 << 4 << 8 << 10
    assert abs(float(table_lookup_1d(t.data, 7.2)) - 7.6) < 1e-5
    assert float(table_lookup_1d(t.data, 1.0)) == 3.0
    # the reference's high clamp returns the last KEY (8), not 10
    assert float(table_lookup_1d(t.data, 99.0)) == 8.0


def test_tep_static_row_equals_2d_lookup():
    h = np.concatenate([np.linspace(-100, 90000, 997), [500.0, 1750.0, 80000.0]])
    h = h.astype(np.float32)
    ours = dryden._tep_lookup_static_row(1, _t(h)).numpy()
    full = table_lookup_2d(torch.from_numpy(dryden._TEP_DATA), _t(np.ones_like(h)),
                           _t(h)).numpy()
    np.testing.assert_array_equal(ours, full)


@pytest.mark.parametrize("regime", ["low", "mid", "high"])
def test_wind_trajectory_matches_fixture(fixtures, p, regime):
    f = fixtures("wind")
    wp = dryden.WindParams.from_env(p.ENV)
    act = _t(f[f"{regime}_action"])
    action4 = tuple(act[i] for i in range(4))
    ws = WindState.zeros()
    states, obs_list = [], []
    for eta in f[f"{regime}_eta"].astype(np.float32):
        e = _t(eta)

        def rhs(s):
            return dryden.wind_dynamics(wp, s, action4, (e[0], e[1], e[2]))
        ws, _, obs = rk4_k4only(rhs, ws, DT)
        states.append(ws.flatten().numpy())
        obs_list.append(torch.stack(obs).numpy())
    states, obs_arr = np.stack(states), np.stack(obs_list)
    scale = np.maximum(np.abs(f[f"{regime}_states"]).max(axis=0), 1e-3)
    np.testing.assert_allclose(states / scale, f[f"{regime}_states"] / scale, atol=2e-3)
    oscale = np.maximum(np.abs(f[f"{regime}_obs"]).max(axis=0), 1e-3)
    np.testing.assert_allclose(obs_arr / oscale, f[f"{regime}_obs"] / oscale, atol=2e-3)


def test_wind_dynamics_equal_jax_random(p):
    """wind_dynamics over random batched filter states in all three altitude
    regimes against JAX."""
    wp = dryden.WindParams.from_env(p.ENV)
    jwp = jdryden.WindParams.from_env(jload_params("aw109").ENV)
    rng = np.random.default_rng(1)
    n = 600
    ws = rng.standard_normal((n, 5)).astype(np.float32)
    act = np.concatenate([rng.uniform(-60, 60, (n, 3)),
                          rng.uniform(0, 3000, (n, 1))], -1).astype(np.float32)
    act[:3, :3] = [[-20 * np.cos(np.pi / 4), -20 * np.sin(np.pi / 4), 0]] * 3
    act[:3, 3] = [500.0, 1500.0, 2500.0]    # atan2(0, 0) in every regime
    eta = (rng.standard_normal((n, 3)) * 50 ** 0.5).astype(np.float32)
    d, wn = dryden.wind_dynamics(wp, WindState.unflatten(_t(ws)), _tup(act), _tup(eta))

    def jfn(ws, act, eta):
        js = JWindState(**{f: ws[:, i] for i, f in enumerate(WindState.FIELDS)})
        jd, jwn = jdryden.wind_dynamics(jwp, js, tuple(act[:, i] for i in range(4)),
                                        tuple(eta[:, i] for i in range(3)))
        return jnp.stack([getattr(jd, f) for f in WindState.FIELDS], -1), jnp.stack(jwn, -1)
    jd, jwn = jax.jit(jfn)(ws, act, eta)
    for ours, ref in ((d.flatten().numpy(), np.asarray(jd)),
                      (torch.stack(wn, -1).numpy(), np.asarray(jwn))):
        scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
        np.testing.assert_allclose(ours / scale, ref / scale, atol=1e-5)


# -- terrain -----------------------------------------------------------------

def test_ground_height_matches_fixture(fixtures, terr):
    f = fixtures("terrain")
    h = terrain.ground_height(terr, _t(f["x"]), _t(f["y"]))
    np.testing.assert_allclose(h.numpy(), f["h"], atol=2e-2)


def _edge_positions(terr):
    rng = np.random.default_rng(0)
    span = max(terr.ns_max, terr.ew_max)
    x = rng.uniform(-0.7 * span, 0.7 * span, 4096).astype(np.float32)
    y = rng.uniform(-0.7 * span, 0.7 * span, 4096).astype(np.float32)
    x[:8] = [-span, span, 0.0, span / 2 - 1.0, -span / 2, span / 2, 1e7, -1e7]
    y[:8] = [span, -span, span / 2 - 1.0, 0.0, -span / 2, span / 2, -1e7, 1e7]
    return x, y


@pytest.mark.parametrize("table", ["packed", "hmap2d", "hmap_flat"])
def test_ground_height_equal_jax(terr, jterr, table):
    """Packed and 2-D paths, edge cells and clamp regions: bit-identical to
    each other, and within 1e-3 ft (one float32 ulp at the map's 8809 ft top)
    of JAX's ground_height (XLA on the CPU fuses the interpolation's
    multiply-adds into FMAs; the port rounds each op)."""
    x, y = _edge_positions(terr)
    hm = {"packed": terr.packed, "hmap2d": terr.hmap,
          "hmap_flat": terr.hmap.reshape(-1)}[table]
    ours = terrain.ground_height(terr, _t(x), _t(y), hmap=hm).numpy()
    packed = terrain.ground_height(terr, _t(x), _t(y)).numpy()
    np.testing.assert_array_equal(ours, packed)
    ref = np.asarray(jax.jit(lambda x, y: jterrain.ground_height(
        jterr, x, y, hmap=jterr.packed))(x, y))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


def test_packed_texels_equal_jax(terr, jterr):
    np.testing.assert_array_equal(terr.packed.numpy(), np.asarray(jterr.packed))
    np.testing.assert_array_equal(terr.hmap.numpy(), np.asarray(jterr.hmap))


# -- small math and the task -------------------------------------------------

def test_pi_bound_equal_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001), [-np.pi, np.pi, 0.0, -0.0,
                        -3 * np.pi, 3 * np.pi, -1e-7, 1e-7]]).astype(np.float32)
    np.testing.assert_array_equal(pi_bound(_t(x)).numpy(),
                                  np.asarray(jax.jit(jpi_bound)(x)))


def test_hover_reward_equal_jax(p):
    rng = np.random.default_rng(2)
    n = 1024
    st, dt = _random_states(rng, n), _random_states(rng, n)
    st[:100, 9:12] = 0.0                     # sign(0) lanes
    task, jtask = tasks.HoverTask(sea_alt=3000.0, north_loc=5.0), \
        jtasks.HoverTask(sea_alt=3000.0, north_loc=5.0)
    norm = tasks.Normalizers.from_params(p)
    jnorm = jtasks.Normalizers.from_params(jload_params("aw109"))
    assert dataclasses.asdict(norm) == dataclasses.asdict(jnorm)
    r, s = task.reward(norm, HeliState.unflatten(_t(st)), HeliState.unflatten(_t(dt)))
    jr, js = jax.jit(lambda a, b: jtask.reward(
        jnorm, JHeliState.unflatten(a), JHeliState.unflatten(b)))(st, dt)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# -- the gather probe's plain version -------------------------------------------

@pytest.mark.parametrize("axis,shape", [
    (0, (8, 128)), (0, (64, 128)), (0, (64, 1024)), (0, (256, 1024)),
    (0, (1024, 1024)), (1, (8, 128)), (1, (8, 1024)), (1, (64, 1024)),
    (1, (1024, 1024))])
def test_gather_plain_equals_numpy(axis, shape):
    """On CPU tensors the gather wrappers run their plain version, which
    equals np.take_along_axis on the probe's seed-0 inputs; nothing is
    counted as a kernel launch."""
    from heligym_tpu_torch.ops.cuda import gather
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[axis], size=shape).astype(np.int32)
    fn = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    before = dict(gather.launches)
    out = fn(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.take_along_axis(x, idx, axis=axis))
    assert gather.launches == before


def test_gather_wrapper_refuses_bad_inputs():
    from heligym_tpu_torch.ops.cuda import gather
    x = torch.zeros((4, 6))
    idx = torch.zeros((4, 6), dtype=torch.int32)
    with pytest.raises(IndexError):
        gather.gather_axis0(x, idx + 4)
    with pytest.raises(IndexError):
        gather.gather_axis1(x, idx - 1)
    assert gather.gather_axis1(x, idx + 5).shape == (4, 6)
    with pytest.raises(ValueError):
        gather.gather_axis0(x, idx[:2])
    with pytest.raises(ValueError):
        gather.gather_axis0(x, idx.to(torch.int64))
    with pytest.raises(ValueError):
        gather.gather_axis0(x.to(torch.float64), idx)
    with pytest.raises(ValueError):
        gather.gather_axis0(torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    empty = gather.gather_axis0(torch.zeros((0, 6)), torch.zeros((0, 6), dtype=torch.int32))
    assert empty.shape == (0, 6)
