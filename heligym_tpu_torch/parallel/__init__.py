from .mesh import (ENV_AXIS, env_sharding, init_distributed, make_env_mesh,
                   make_train_mesh, replicated_sharding, shard_env_state)
from .farm import EnvFarm, farm_metrics
