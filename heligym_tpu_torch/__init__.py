"""heligym_tpu_torch: the PyTorch/CUDA port of heligym_tpu.

Batched 6-DOF helicopter flight environments on torch tensors, with the whole
env step fused into one hand-written CUDA kernel (`ops/cuda/fused_step.py`).
Entry points run on the CUDA card unless the caller passes `device="cpu"`.

Modules: `envs` (the env, the tasks, the trim, the vector env, the
gymnasium facades), `ops` (the physics, terrain and Dryden wind; `ops/cuda`
the kernels and their builds), `learner` (the network, PPO, the trainer's
command line, the evaluator, the scripted expert, distillation), `parallel`
(process groups, env meshes, the sharded farm: one process per card over
`torch.distributed`), `render` (top-down, terminal and native renderers),
`models` (airframe parameters), `utils`, `convert` (to and from the JAX
package's arrays and checkpoints).

The package exports `HeliEnv`, `VectorHeliEnv` and `load_params`, as the
JAX package does. Where gymnasium is installed, importing the package also
exports the gymnasium classes named in `ENV_IDS` (`envs/gym_api.py`) and
registers their ids `heligym_tpu_torch/<Name>-v0`, beside the JAX package's
unprefixed ids. Where it is not, nothing is registered and every other
module works: only
`envs/gym_api.py` imports gymnasium, and `envs/gym_core.py` holds the
facades' work without it.
"""
import importlib.util

from .envs import HeliEnv, VectorHeliEnv
from .models import load_params

__version__ = "0.1.0"

# the gymnasium classes of envs/gym_api.py, registered as
# "heligym_tpu_torch/<name>-v0"
ENV_IDS = ("Heli", "HeliHover", "HeliForwardFlight", "HeliObliqueFlight",
           "HeliTurningFlight", "HeliSlalom", "HeliLanding")

if importlib.util.find_spec("gymnasium") is not None:
    from gymnasium.envs.registration import register

    for _name in ENV_IDS:
        register(id=f"heligym_tpu_torch/{_name}-v0",
                 entry_point=f"heligym_tpu_torch.envs.gym_api:{_name}",
                 max_episode_steps=5000, reward_threshold=0.95,
                 nondeterministic=False)

    from .envs.gym_api import (Heli, HeliForwardFlight, HeliHover, HeliLanding,
                               HeliObliqueFlight, HeliSlalom, HeliTurningFlight)
