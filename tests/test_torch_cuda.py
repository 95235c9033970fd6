"""The fused_step CUDA kernel against its plain PyTorch version, on the card.

Skips where there is no CUDA card. It imports no JAX, so it also runs on a
machine without JAX, where the suite's conftest (which imports JAX) must be
left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from heligym_tpu_torch.envs import HeliEnv, HoverTask, VectorHeliEnv
from heligym_tpu_torch.ops.cuda import fused_step as fs


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, on the card (30 steps at
    4096 envs; tolerances of the fused parity contract)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = HeliEnv.build("aw109", task=HoverTask())
    tr = env.trim_result()
    n, steps = 4096, 30
    es, _ = VectorHeliEnv(env, n).reset_from_trim(tr)
    rng = np.random.default_rng(0)
    act = (tr.action.numpy() + 0.02 * rng.standard_normal((steps, n, 4))).astype(np.float32)
    eta = (rng.standard_normal((steps, 3, n)) * 50 ** 0.5).astype(np.float32)
    act, eta = torch.from_numpy(act).cuda(), torch.from_numpy(eta).cuda()
    carry_k, init = fs.pack(es)
    carry_p = carry_k.clone()
    for t in range(steps):
        carry_k, x_k = fs.fused_step(env, carry_k, init, act[t], eta[t])
        with torch.no_grad():
            carry_p, x_p = fs.fused_step_plain(env, carry_p, init, act[t], eta[t])
        torch.testing.assert_close(x_k[fs.CREW], x_p[fs.CREW], rtol=0, atol=2e-5)
        torch.testing.assert_close(x_k[fs.COBS0:fs.CSUCC], x_p[fs.COBS0:fs.CSUCC],
                                   rtol=1e-4, atol=2e-3)
        assert torch.equal(x_k[fs.CDONE:fs.COBS0], x_p[fs.CDONE:fs.COBS0])
    torch.testing.assert_close(carry_k[:fs.SROWS], carry_p[:fs.SROWS],
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(carry_k[fs.STEPS:], carry_p[fs.STEPS:])
