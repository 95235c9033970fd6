"""The port's gathers against the JAX probe kernels themselves, on the CPU.

`tools/exp_gather.py` holds the two Pallas kernels that the port's
`csrc/gather.cu` replaces. Each is wrapped here in a `pl.pallas_call` with
the probe's specs (whole arrays in VMEM) and run in interpret mode; the
port's wrappers on CPU tensors (their plain version) must equal it exactly
at the nine probe sizes, on the probe's seed-0 inputs.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from heligym_tpu_torch.ops.cuda import gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the probe's sizes (tools/exp_gather.py's __main__)
PROBE = [(0, (8, 128)), (0, (64, 128)), (0, (64, 1024)), (0, (256, 1024)),
         (0, (1024, 1024)), (1, (8, 128)), (1, (8, 1024)), (1, (64, 1024)),
         (1, (1024, 1024))]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "exp_gather", os.path.join(ROOT, "tools", "exp_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_inputs(S, L, axis):
    """The probe's inputs, as tools/exp_gather.py::trial makes them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, L)).astype(np.float32)
    idx = rng.integers(0, S if axis == 0 else L, size=(S, L)).astype(np.int32)
    return x, idx


@pytest.mark.parametrize("axis,shape", PROBE)
def test_gather_equals_pallas_probe_kernel(probe, axis, shape):
    """gather_axis0 / gather_axis1 on CPU tensors equal the probe's Pallas
    kernel (interpret mode) bit for bit, and launch no CUDA kernel."""
    S, L = shape
    kernel = probe.gather_axis0_kernel if axis == 0 else probe.gather_axis1_kernel
    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((S, L), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)
    x, idx = probe_inputs(S, L, axis)
    want = np.asarray(jax.block_until_ready(call(x, idx)))
    fn = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    before = dict(gather.launches)
    got = fn(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert gather.launches == before
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
