from .env import ACT_DIM, OBS_DIM, EnvState, HeliEnv, ResetSnapshot, StepOutput
from .gym_core import TASKS, BatchCore, SingleCore, StepResult
from .tasks import (ForwardFlightTask, HoverTask, LandingTask, MixedTask,
                    Normalizers, ObliqueFlightTask, SlalomTask, Task,
                    TurningFlightTask)
from .trim import TrimResult
from .vector import VectorHeliEnv, auto_reset, broadcast_state, rollout

__all__ = ["ACT_DIM", "BatchCore", "EnvState", "ForwardFlightTask", "HeliEnv",
           "HoverTask", "LandingTask", "MixedTask", "Normalizers", "OBS_DIM",
           "ObliqueFlightTask", "ResetSnapshot", "SingleCore", "SlalomTask",
           "StepOutput", "StepResult", "TASKS", "Task", "TrimResult",
           "TurningFlightTask", "VectorHeliEnv", "auto_reset",
           "broadcast_state", "rollout"]
