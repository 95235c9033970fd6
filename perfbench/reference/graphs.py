"""The reference's plain env step, replayed from a CUDA graph on the card.

The plain step is ~4,200 small PyTorch launches; eagerly the host paces it
at tens of milliseconds a step. Captured once, the same kernels replay in a
few milliseconds, with the same arithmetic: a replay runs exactly the
kernels the eager call launched. On the CPU the step runs eagerly.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class Stepper:
    """`step(carry, act, eta) -> (carry', collect)` for a fixed `init` and
    farm size; `post(carry)` (the bfloat16 control) runs after each step.
    On the card the returned tensors are the graph's own buffers: the
    caller copies what it keeps before the next call."""

    def __init__(self, sim, init: torch.Tensor, post: Optional[Callable] = None):
        self.sim, self.init, self.post = sim, init, post
        self.graph = None
        if init.device.type == "cuda":
            self._capture(init.shape[1], init.device)

    def _eager(self, carry, act, eta):
        carry, x = self.sim.step(carry, self.init, act, eta)
        return (self.post(carry) if self.post else carry), x

    def _capture(self, n: int, dev):
        self.carry = torch.zeros((63, n), device=dev)
        self.act = torch.zeros((n, 4), device=dev)
        self.eta = torch.zeros((3, n), device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            self._eager(self.carry, self.act, self.eta)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), torch.no_grad():
            self.out_carry, self.out_x = self._eager(self.carry, self.act, self.eta)

    def __call__(self, carry, act, eta):
        if self.graph is None:
            return self._eager(carry, act, eta)
        self.carry.copy_(carry)
        self.act.copy_(act)
        self.eta.copy_(eta)
        self.graph.replay()
        return self.out_carry, self.out_x
