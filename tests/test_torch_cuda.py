"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips where there is no CUDA card. It imports no JAX, so it also runs on a
machine without JAX, where the suite's conftest (which imports JAX) must be
left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from heligym_tpu_torch.envs import (ForwardFlightTask, HeliEnv, HoverTask,
                                    LandingTask, MixedTask, ObliqueFlightTask,
                                    SlalomTask, TurningFlightTask, VectorHeliEnv)
from heligym_tpu_torch.ops.cuda import fused_step as fs, gather

TASK_NAMES = ("hover", "forward", "turning", "slalom", "landing",
              "landing_touch", "oblique", "mixed4", "mixed7")


def make_task(name, alt):
    """Task `name` with its altitude target at `alt` [ft above sea level],
    the trim altitude, so that in-tolerance flags fire."""
    single = {
        "hover": HoverTask(sea_alt=alt),
        "forward": ForwardFlightTask(sea_alt=alt, vel=60.0),
        "turning": TurningFlightTask(sea_alt=alt),
        "slalom": SlalomTask(sea_alt=alt, vel=60.0),
        "landing": LandingTask(),
        "landing_touch": LandingTask(touch_alt=alt - 100.0),
        "oblique": ObliqueFlightTask(sea_alt=alt, vel=60.0),
    }
    if name == "mixed4":
        return MixedTask(tasks=tuple(single[k] for k in
                                     ("hover", "forward", "turning", "oblique")))
    if name == "mixed7":
        return MixedTask(tasks=tuple(single.values()))
    return single[name]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernel_vs_plain(env, es, tr, steps, dive, seed=0, equal_nan=False):
    n = es.steps.shape[0]
    rng = np.random.default_rng(seed)
    act = (tr.action.cpu().numpy() + 0.02 * rng.standard_normal((steps, n, 4))
           ).astype(np.float32)
    if dive:
        act[..., 0] = -1.0
    eta = (rng.standard_normal((steps, 3, n)) * 50 ** 0.5).astype(np.float32)
    act, eta = torch.from_numpy(act).cuda(), torch.from_numpy(eta).cuda()
    carry_k, init = fs.pack(es)
    carry_p = carry_k.clone()
    done_any = False
    for t in range(steps):
        carry_k, x_k = fs.fused_step(env, carry_k, init, act[t], eta[t])
        with torch.no_grad():
            carry_p, x_p = fs.fused_step_plain(env, carry_p, init, act[t], eta[t])
        assert torch.equal(x_k[fs.CDONE:fs.COBS0], x_p[fs.CDONE:fs.COBS0])
        assert torch.equal(x_k[fs.CSUCC], x_p[fs.CSUCC])
        done_any |= bool(x_k[fs.CDONE].any())
        if dive:
            continue
        torch.testing.assert_close(x_k[fs.CREW], x_p[fs.CREW], rtol=0, atol=2e-5,
                                   equal_nan=equal_nan)
        for lo, hi in ((fs.COBS0, fs.CSUCC), (fs.CFINAL0, fs.XROWS)):
            torch.testing.assert_close(x_k[lo:hi], x_p[lo:hi], rtol=1e-4,
                                       atol=2e-3, equal_nan=equal_nan)
    if not dive:
        torch.testing.assert_close(carry_k[:fs.SROWS], carry_p[:fs.SROWS],
                                   rtol=2e-4, atol=2e-4, equal_nan=equal_nan)
    assert torch.equal(carry_k[fs.STEPS:], carry_p[fs.STEPS:])
    return done_any


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, on the card (30 steps at
    4096 envs; tolerances of the fused parity contract)."""
    _need_card()
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    es, _ = VectorHeliEnv(env, 4096).reset_from_trim(tr)
    _kernel_vs_plain(env, es, tr, 30, dive=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TASK_NAMES)
def test_kernel_matches_plain_every_task(name):
    """Every task and MixedTask through the kernel and the plain version
    from a 60 ft/s forward trim: 30 nominal steps at the parity tolerances,
    then a 300-step dive with identical flags and counters."""
    _need_card()
    env = HeliEnv.build("aw109")
    tr = env.trim_result({"ned_vel": [60.0, 0.0, 0.0]})
    env = env.replace(task=make_task(name, float(-tr.state.z)))
    venv = VectorHeliEnv(env, 4096)
    es, _ = venv.reset_from_trim(tr)
    if isinstance(env.task, MixedTask):
        es = venv.assign_tasks(es, np.arange(4096) % len(env.task.tasks))
    _kernel_vs_plain(env, es, tr, 30, dive=False, equal_nan=True)
    assert _kernel_vs_plain(env, es, tr, 300, dive=True, seed=1), \
        "the dive never terminated"


@pytest.mark.cuda
@pytest.mark.parametrize("axis,shape", [
    (0, (8, 128)), (0, (64, 128)), (0, (64, 1024)), (0, (256, 1024)),
    (0, (1024, 1024)), (1, (8, 128)), (1, (8, 1024)), (1, (64, 1024)),
    (1, (1024, 1024)), (0, (5, 7)), (1, (5, 7))])
def test_gather_kernels_match_plain(axis, shape):
    """Each gather kernel equals its plain version exactly at the probe
    sizes (and at a ragged one), and refuses what it does not take."""
    _need_card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, shape[axis], size=shape)
                           .astype(np.int32)).cuda()
    fn = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    before = gather.launches[f"gather_axis{axis}"]
    out = fn(x, idx)
    torch.cuda.synchronize()
    assert gather.launches[f"gather_axis{axis}"] == before + 1
    assert torch.equal(out, gather.gather_plain(x, idx, axis))
    with pytest.raises(IndexError):
        fn(x, idx + shape[axis])
    with pytest.raises(ValueError):
        fn(x.T, idx.T.contiguous().T)
