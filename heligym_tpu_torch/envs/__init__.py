from .env import EnvState, HeliEnv, ResetSnapshot, StepOutput
from .tasks import (ForwardFlightTask, HoverTask, LandingTask, MixedTask,
                    Normalizers, ObliqueFlightTask, SlalomTask, Task,
                    TurningFlightTask)
from .trim import TrimResult
from .vector import VectorHeliEnv, auto_reset, broadcast_state, rollout

__all__ = ["EnvState", "ForwardFlightTask", "HeliEnv", "HoverTask",
           "LandingTask", "MixedTask", "Normalizers", "ObliqueFlightTask",
           "ResetSnapshot", "SlalomTask", "StepOutput", "Task", "TrimResult",
           "TurningFlightTask", "VectorHeliEnv", "auto_reset",
           "broadcast_state", "rollout"]
