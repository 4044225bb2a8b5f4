from madrona_bots_tpu_torch.parallel.mesh import (WORLD_AXIS, Mesh, make_mesh, replicated,
                                                  shard_state, state_sharding)
from madrona_bots_tpu_torch.parallel.sharded import make_sharded_train_tick

__all__ = ["WORLD_AXIS", "Mesh", "make_mesh", "replicated", "shard_state",
           "state_sharding", "make_sharded_train_tick"]
