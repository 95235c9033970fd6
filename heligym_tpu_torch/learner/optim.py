"""The PPO learner's optimizer: the JAX package's
`optax.chain(clip_by_global_norm(max_grad_norm), scale_by_adam())` followed
by its manual `-lr` step (`heligym_tpu/learner/ppo.py:250-252, :645-657`).

Written out by hand rather than with `torch.optim.Adam` and
`clip_grad_norm_`, whose arithmetic differs: optax scales the gradients by
`max_norm / norm` only when `norm >= max_norm` (`clip_grad_norm_` divides by
`norm + 1e-6` always), and corrects the moments' bias with an int32 step
count. The learning rate is applied after Adam, so that the KL stop can set a
step's rate to 0 while the moments and the count still advance, and the
critic warm-up can scale the actor's updates to 0.

The state holds one moment pair per parameter, in the order of the
parameter list given to `adam_init` (the learner passes the flax leaf order
of `ActorCritic.flax_leaves`), each in its parameter's own layout.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
_COUNT_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax's `ScaleByAdamState`: the int32 step count and the first and
    second moments."""
    count: torch.Tensor        # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)
                     for p in params]
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=params[0].device),
                     mu=zeros(), nu=zeros())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm: the gradients as they are while their
    global norm is below `max_norm`, else each `(g / norm) * max_norm`.
    Decided on the device (no host sync): while the norm is below the
    limit, the gradients are divided and multiplied by 1, which is exact."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    return torch._foreach_mul(torch._foreach_div(list(grads), torch.where(keep, one, norm)),
                              torch.where(keep, one, one * max_norm))


def adam_update(grads: Sequence[torch.Tensor], state: AdamState):
    """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): the
    Adam direction of each parameter and the advanced state."""
    grads = list(grads)
    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1),
                            torch._foreach_mul(state.mu, B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2),
                            torch._foreach_mul(state.nu, B2))
    count = torch.where(state.count < _COUNT_MAX, state.count + 1, state.count)
    steps = count.to(torch.float32)
    mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(B1, steps))
    nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(B2, steps))
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
    return torch._foreach_div(mu_hat, denom), AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def apply_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: AdamState, lr, max_grad_norm: float,
               scaled: Optional[Sequence[int]] = None, scale=None) -> AdamState:
    """One optimizer step, written into `params` in place (so that every
    holder of the parameters, such as the collector's graph, sees it):
    clip, Adam, then `p + (-lr * u)`, the update of each parameter whose
    index is in `scaled` first multiplied by `scale`. `lr` is a float or a
    0-d tensor (the KL stop makes it 0 on the device). Returns the new
    state."""
    direction, state = adam_update(clip_by_global_norm(grads, max_grad_norm), state)
    updates = torch._foreach_mul(direction, -torch.as_tensor(lr, dtype=torch.float32,
                                                             device=direction[0].device))
    if scaled:
        torch._foreach_mul_([updates[i] for i in scaled],
                            torch.as_tensor(scale, dtype=torch.float32,
                                            device=direction[0].device))
    torch._foreach_add_(list(params), updates)
    return state
