from .env import EnvState, HeliEnv, ResetSnapshot, StepOutput
from .tasks import HoverTask, Normalizers, Task
from .trim import TrimResult
from .vector import VectorHeliEnv, auto_reset, broadcast_state

__all__ = ["EnvState", "HeliEnv", "HoverTask", "Normalizers", "ResetSnapshot",
           "StepOutput", "Task", "TrimResult", "VectorHeliEnv", "auto_reset",
           "broadcast_state"]
