from .networks import ActorCritic, gaussian_entropy, gaussian_log_prob, obs_scales
from .ppo import ObsStats, PPOConfig, PPOLearner, TrainState, Transition

__all__ = ["ActorCritic", "ObsStats", "PPOConfig", "PPOLearner", "TrainState",
           "Transition", "gaussian_entropy", "gaussian_log_prob", "obs_scales"]
